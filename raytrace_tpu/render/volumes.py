"""Constant-density medium sampling for the wavefront integrator.

Reference semantics (``constantMedium``, Geometry.hs:298-330): per bounce,
find where the ray enters and exits the medium's closed boundary surface —
entry is the first boundary crossing if it is front-facing, else the ray
starts inside and entry is t_min; exit is the next crossing — then scatter
at ``entry - log(U)/density`` if that lies before the exit.

Array re-design: instead of nesting stochastic geometry inside traversal,
every volume produces an *independent scatter candidate t* per ray, and
the integrator takes the global argmin against the surface hit.  This is
distribution-equivalent to the reference's shrinking-t_max group fold
(see SURVEY.md: the fold's ``min tmax`` clipping only rejects candidates
that would lose the argmin anyway).

Boundary crossings reuse :func:`..ops.intersect.chunk_roots`: both sphere
roots and plane hits are crossings.  Two chunked min-scans give first and
second crossing without materializing an [R, all-crossings] buffer.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from ..core.vecmath import DTYPE
from ..ops.intersect import INF, _bdot, _chunk_size, chunk_roots
from ..scene.types import PRIM_BOX, PRIM_SPHERE, Primitives, Volumes


def _crossing_scan2(prims: Primitives, start: int, count: int, o, d, time,
                    t_min):
    """The two smallest boundary crossings > ``t_min[R]`` within the
    static prim slice [start, start+count), in ONE pass over the prims.

    Returns ``(t1, front1, t2)``: the reference finds the first hit, then
    the next hit strictly beyond it (Geometry.hs:306-315) — identical to
    the two smallest crossings overall.  The front flag of the first
    minimal entry is selected with a cumsum first-match mask.
    """
    r = o.shape[0]
    c = _chunk_size(count, r)
    steps = -(-count // c)

    def step(carry, i):
        b1, f1c, b2 = carry
        cs = start + jnp.minimum(i * c, count - c)
        sl = lambda x: jax.lax.dynamic_slice_in_dim(x, cs, c, 0)
        kind = sl(prims.kind)
        r1, r2 = chunk_roots(kind, sl(prims.p0), sl(prims.e1), sl(prims.e2),
                             sl(prims.mv0), sl(prims.mv1), prims.has_motion,
                             o, d, time, has_box=prims.has_box)
        gt = t_min[:, None]
        t1 = jnp.where(r1 > gt, r1, INF)
        t2 = jnp.where(r2 > gt, r2, INF)
        # front-ness of candidates: sphere/box near root enters (front),
        # far root exits; planes are front iff approached from normal side
        two_root = (kind == PRIM_SPHERE) | (kind == PRIM_BOX)
        cp = jnp.cross(sl(prims.e1), sl(prims.e2))
        denom = _bdot(d, cp)
        fr1 = jnp.where(two_root[None, :], True, denom < 0.0)
        fr2 = jnp.zeros_like(fr1)

        both_t = jnp.concatenate([t1, t2], axis=1)
        both_f = jnp.concatenate([fr1, fr2], axis=1)
        # chunk's smallest + smallest STRICTLY greater (the reference's
        # second hit uses an open interval from the first, Geometry.hs:
        # 310-315 — shared mesh edges produce duplicate crossings that
        # must collapse into one)
        c1 = jnp.min(both_t, axis=1)
        is_min = both_t == c1[:, None]
        first = is_min & (jnp.cumsum(is_min.astype(jnp.int32), axis=1) == 1)
        cf = jnp.any(both_f & first, axis=1)
        c2 = jnp.min(jnp.where(both_t > c1[:, None], both_t, INF), axis=1)

        # merge into carried (b1, f1c, b2) with the same strictness
        new_b1 = jnp.minimum(b1, c1)
        take_c = c1 < b1
        new_f1 = jnp.where(take_c, cf, f1c)
        gt = lambda x: jnp.where(x > new_b1, x, INF)
        new_b2 = jnp.minimum(jnp.minimum(gt(b1), gt(b2)),
                             jnp.minimum(gt(c1), gt(c2)))
        return (new_b1, new_f1, new_b2), None

    init = (jnp.full((r,), INF, DTYPE), jnp.zeros((r,), bool),
            jnp.full((r,), INF, DTYPE))
    (t1, front1, t2), _ = jax.lax.scan(step, init, jnp.arange(steps))
    return t1, front1, t2


def _candidate_from_crossings(volumes: Volumes, v: int, t1, front1, t2,
                              t_min, u_v):
    """Scatter candidate of volume ``v`` from its two smallest boundary
    crossings (entry/exit per Geometry.hs:306-315, free flight per
    Geometry.hs:316-319)."""
    entry = jnp.where(front1, t1, t_min)
    exit_t = jnp.where(front1, t2, t1)
    has_segment = jnp.isfinite(t1) & jnp.isfinite(exit_t)
    dist_in = exit_t - entry
    # density is DETACHED here: its gradient flows through the
    # score-function weight (integrator.bounce diff path), not the
    # reparameterized flight distance — carrying both would double-count.
    # Geometry gradients (entry/exit via the boundary crossings) stay
    # attached (reparameterized, like surface hits).
    neg_inv_density = jax.lax.stop_gradient(-1.0 / volumes.density[v])
    hit_dist = neg_inv_density * jnp.log(jnp.maximum(u_v, 1e-38))
    scatter = has_segment & (hit_dist < dist_in)
    return jnp.where(scatter, entry + hit_dist, INF), scatter


def volume_candidates(volumes: Volumes, o, d, time, t_min, u_scatter,
                      with_segments: bool = False):
    """Scatter candidate per volume: returns (t_cand[R, V], valid[R, V]).

    ``u_scatter[R, V]`` are uniform draws for the exponential free-flight
    distance (Geometry.hs:316-319: ``-log U / density``).

    ``with_segments=True`` additionally returns ``(entry[R, V],
    exit[R, V], has_segment[R, V])`` — the medium segment each ray
    traverses, needed by the score-function density gradient
    (integrator._volume_density_score)."""
    cands = []
    valids = []
    segs = []
    for v in range(volumes.n_volumes):
        start = volumes.starts[v]
        count = volumes.counts[v]
        t1, front1, t2 = _crossing_scan2(volumes.prims, start, count,
                                         o, d, time, t_min)
        c, valid = _candidate_from_crossings(volumes, v, t1, front1, t2,
                                             t_min, u_scatter[:, v])
        cands.append(c)
        valids.append(valid)
        if with_segments:
            entry = jnp.where(front1, t1, t_min)
            exit_t = jnp.where(front1, t2, t1)
            has_segment = jnp.isfinite(t1) & jnp.isfinite(exit_t)
            segs.append((entry, exit_t, has_segment))
    out = jnp.stack(cands, axis=1), jnp.stack(valids, axis=1)
    if with_segments:
        return out + (jnp.stack([s[0] for s in segs], axis=1),
                      jnp.stack([s[1] for s in segs], axis=1),
                      jnp.stack([s[2] for s in segs], axis=1))
    return out
