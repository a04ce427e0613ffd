"""Differentiable nearest-hit with a winner-only backward.

The backward pass of ray-scene intersection only needs gradients through
the *winning* primitive of each ray (the argmin is piecewise-constant in
the parameters, and t/normal/uv of non-winners don't affect the output).
So: run the plain nearest-hit scan forward (ops/intersect.py), and in the
custom VJP recompute the winner's hit analytically and differentiate that
tiny function — the vjp of the gather scatters parameter cotangents back
into the primitive buffers automatically.  The backward therefore does
not depend on the forward's intersection engine.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from ..core.vecmath import DTYPE, gather_rows, onehot_rows
from ..scene.types import Primitives
from .intersect import (
    INF, _single_prim_t_rows, make_hit_record, make_hit_record_rows,
    nearest_hit_t,
)

# Above this many primitive rows the winner gather is a plain take
# (scatter-add backward) instead of the [R, N] one-hot matmul.  Not
# measured on the card yet (ROADMAP A5).
_ONEHOT_MAX_ROWS = 8192


def _winner_record(floats, ints, o, d, time, idx, has_motion, t_min,
                   has_box=False, sphere_rots=()):
    """Differentiable recompute of the hit for a known winner ``idx``.

    Per-ray primitive rows are gathered with ONE one-hot matmul over the
    concatenated float tables (up to ``_ONEHOT_MAX_ROWS`` rows), so the
    vjp of the gather is a matmul (``oh.T @ ct``) rather than six
    separate scatter-adds (see core/vecmath.py:onehot_rows).

    Returns ``(t_safe, valid, rec)`` where ``t_safe`` is 1.0 on
    miss/invalid lanes (NaN-free grads) and ``rec`` the full HitRecord.
    """
    p0, e1, e2, uvs, mv0, mv1 = floats
    kind, mat = ints
    n = kind.shape[0]
    pi = jnp.maximum(idx, 0)
    parts = [p0, e1, e2, uvs.reshape(n, 6)]
    if has_motion:
        parts += [mv0, mv1]
    if n <= _ONEHOT_MAX_ROWS:
        oh = onehot_rows(pi, n)
        allf = gather_rows(oh, jnp.concatenate(parts, axis=1))
    else:
        allf = jnp.concatenate(parts, axis=1)[pi]
    g_p0, g_e1, g_e2 = allf[:, 0:3], allf[:, 3:6], allf[:, 6:9]
    g_uvs = allf[:, 9:15].reshape(-1, 3, 2)
    g_mv0 = allf[:, 15:18] if has_motion else None
    g_mv1 = allf[:, 18:21] if has_motion else None
    g_kind = kind[pi]

    # same open interval as the forward pass, so the same root is chosen
    t = _single_prim_t_rows((g_kind, g_p0, g_e1, g_e2, g_mv0, g_mv1),
                            has_motion, o, d, time,
                            jnp.full_like(time, t_min),
                            jnp.full_like(time, INF), has_box=has_box)
    valid = (idx >= 0) & jnp.isfinite(t)
    t_safe = jnp.where(valid, t, 1.0)
    rec = make_hit_record_rows(
        (g_kind, g_p0, g_e1, g_e2, g_mv0, g_mv1, g_uvs), has_motion,
        mat[pi], idx, o, d, time, t_safe, has_box=has_box,
        sphere_rots=sphere_rots)
    return t_safe, valid, rec


def _winner_outputs(floats, ints, o, d, time, idx, has_motion, t_min,
                    has_box=False, sphere_rots=()):
    """Differentiable recompute of (t, normal, uv) for winner ``idx``."""
    t_safe, _, rec = _winner_record(floats, ints, o, d, time, idx,
                                    has_motion, t_min, has_box=has_box,
                                    sphere_rots=sphere_rots)
    return t_safe, rec.normal, rec.uv


def make_diff_surface_hit(has_motion: bool, t_min: float,
                          has_box: bool = False, sphere_rots=()):
    """Build a differentiable surface-hit fn over float primitive buffers.

    Returns ``hit(floats, ints_f, o, d, time) -> (t, idx, normal, front,
    uv, m)`` where ``floats = (p0, e1, e2, uvs, mv0, mv1)`` and ``ints_f =
    (kind, mat)`` *as float32* (custom_vjp cannot close over traced
    arrays, and integer args would need float0 cotangents; small ints are
    exact in f32 and get zero cotangents).
    """

    def _forward(floats, ints_f, o, d, time):
        p0, e1, e2, uvs, mv0, mv1 = floats
        kind = ints_f[0].astype(jnp.int32)
        mat = ints_f[1].astype(jnp.int32)
        prims = Primitives(kind=kind, p0=p0, e1=e1, e2=e2, uvs=uvs, mat=mat,
                           mv0=mv0, mv1=mv1, n=kind.shape[0],
                           has_motion=has_motion, has_box=has_box,
                           sphere_rots=sphere_rots)
        r = o.shape[0]
        tmin = jnp.full((r,), t_min, DTYPE)
        tmax = jnp.full((r,), INF, DTYPE)
        t, idx = nearest_hit_t(prims, None, o, d, time, tmin, tmax)
        rec = make_hit_record(prims, idx, o, d, time,
                              jnp.where(jnp.isfinite(t), t, 1.0))
        return t, idx, rec.normal, rec.front, rec.uv, rec.mat

    @jax.custom_vjp
    def hit(floats, ints_f, o, d, time):
        return _forward(floats, ints_f, o, d, time)

    def hit_fwd(floats, ints_f, o, d, time):
        out = _forward(floats, ints_f, o, d, time)
        idx = out[1]
        return out, (floats, ints_f, o, d, time, idx)

    def hit_bwd(res, cts):
        floats, ints_f, o, d, time, idx = res
        ct_t, _ct_idx, ct_normal, _ct_front, ct_uv, _ct_mat = cts
        ct_t = jnp.where(jnp.isfinite(ct_t), ct_t, 0.0)
        ints = (ints_f[0].astype(jnp.int32), ints_f[1].astype(jnp.int32))

        def g(floats, o, d, time):
            return _winner_outputs(floats, ints, o, d, time, idx,
                                   has_motion, t_min, has_box=has_box,
                                   sphere_rots=sphere_rots)

        _, vjp = jax.vjp(g, floats, o, d, time)
        gf, go, gd, gtime = vjp((ct_t, ct_normal, ct_uv))
        g_ints = (jnp.zeros_like(ints_f[0]), jnp.zeros_like(ints_f[1]))
        return gf, g_ints, go, gd, gtime

    hit.defvjp(hit_fwd, hit_bwd)
    return hit
