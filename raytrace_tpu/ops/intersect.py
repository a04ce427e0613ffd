"""Ray-primitive intersection, dense and BVH, fully vectorized.

The semantics mirror the reference primitives exactly:

* sphere     — half-b quadratic, two roots tried against the open interval,
               outward-normal front/back flip, polar uv (Geometry.hs:58-104)
* planeShape — denom guard 1e-8, plane t, barycentric-style (a, b)
               coordinates, membership test, right-hand-rule front side
               (Geometry.hs:108-144); parallelogram and triangle are
               membership/uv specializations (Geometry.hs:147-176)
* motion     — time-lerped translation applied to the primitive
               (Geometry.hs:447-456)

Array re-design (not a port): intersection is computed for a whole
[R rays x C primitives] tile at once.  The plane test is rewritten as three
scalar triple products against per-primitive precomputed vectors
(a = p_rel . cross(v, n_s) etc.), so the entire tile is a handful of
[R,3]x[C,3] contractions plus elementwise ops — dense work with no
divergence, no gathers in the inner loop.  The "two roots" contract lets
*one* candidate computation serve both nearest-hit queries and the
entry/exit queries of constant media (render/volumes.py) without
recomputation.

A stackless threaded-BVH traversal (escape indices, shrinking t_max —
semantics of Geometry.hs:352-363) is provided for large scenes.
"""
from __future__ import annotations

import math

import jax
import jax.numpy as jnp
from ..core import struct

from ..core.vecmath import DTYPE, HIGHEST, matmul, normalize, vdot0
from ..scene.types import (
    BVH, PRIM_BOX, PRIM_PARALLELOGRAM, PRIM_SPHERE, PRIM_TRIANGLE,
    Primitives,
)

INF = jnp.inf
DENOM_EPS = 1e-8  # planeShape denom guard (Geometry.hs:126)

# Budget for [R, C] intersection tiles (elements). Governs the dense-mode
# primitive chunk size so the device-memory working set stays bounded.
_TILE_BUDGET = 1 << 23


class HitRecord(struct.PyTreeNode):
    """SoA hit record (Core.hs:155-162) + the prim/material ids the
    wavefront integrator needs."""
    t: jnp.ndarray          # f32[R]
    point: jnp.ndarray      # f32[R,3]
    normal: jnp.ndarray     # f32[R,3] unit, facing the ray
    front: jnp.ndarray      # bool[R]
    uv: jnp.ndarray         # f32[R,2]
    mat: jnp.ndarray        # i32[R]
    hit: jnp.ndarray        # bool[R] — whether anything was hit


def _bdot(x, y):
    """[R,3] x [C,3] -> [R,C] contraction in full f32 (core/vecmath.py:
    HIGHEST)."""
    return jax.lax.dot_general(
        x, y, (((1,), (1,)), ((), ())), precision=HIGHEST,
        preferred_element_type=DTYPE
    )


def chunk_roots(kind, p0, e1, e2, mv0, mv1, has_motion, o, d, time,
                has_box: bool = False):
    """Candidate hit parameters of R rays against C primitives.

    Returns ``(r1, r2)`` of shape [R, C]: the (sorted) candidate ray
    parameters, ``+inf`` where there is no candidate.  Spheres yield both
    quadratic roots; planar primitives yield their single plane hit in
    ``r1`` (membership already applied); boxes (slab test) yield entry in
    ``r1`` and exit in ``r2`` like spheres.  Interval clipping is the
    caller's job, so one evaluation serves nearest-hit *and* volume
    entry/exit queries.  ``has_box`` is static; scenes without box rows
    compile none of the slab code.
    """
    kind = kind[None, :]                                  # [1,C]
    is_sphere = kind == PRIM_SPHERE
    is_para = kind == PRIM_PARALLELOGRAM
    is_tri = kind == PRIM_TRIANGLE

    if has_motion:
        # Effective ray origin per (ray, prim): o - (mv0 + time*(mv1-mv0)).
        # Expanded into per-prim scalars times powers of time so everything
        # stays [R,C] without an [R,C,3] intermediate.
        dmv = mv1 - mv0
        tr = time[:, None]                                # [R,1]
    # --- sphere: h^2 - c quadratic in half-b form (Geometry.hs:63-80) ---
    center = p0
    radius = e1[:, 0]
    d_dot_c = _bdot(d, center)                            # [R,C]
    o_dot_c = _bdot(o, center)
    o_sq = vdot0(o, o)[:, None]
    c_sq = vdot0(center, center)[None, :]
    if has_motion:
        # oc = center + shift - o ; h = d.(oc) ; c = |oc|^2 - r^2
        d_dot_mv0 = _bdot(d, mv0)
        d_dot_dmv = _bdot(d, dmv)
        o_dot_mv0 = _bdot(o, mv0)
        o_dot_dmv = _bdot(o, dmv)
        c_dot_mv0 = vdot0(center, mv0)[None, :]
        c_dot_dmv = vdot0(center, dmv)[None, :]
        mv0_sq = vdot0(mv0, mv0)[None, :]
        mv0_dmv = vdot0(mv0, dmv)[None, :]
        dmv_sq = vdot0(dmv, dmv)[None, :]
        h = d_dot_c + d_dot_mv0 + tr * d_dot_dmv - vdot0(d, o)[:, None]
        shift_sq = mv0_sq + 2.0 * tr * mv0_dmv + tr * tr * dmv_sq
        c_shift = c_dot_mv0 + tr * c_dot_dmv
        o_shift = o_dot_mv0 + tr * o_dot_dmv
        oc_sq = c_sq + 2.0 * c_shift + shift_sq - 2.0 * (o_dot_c + o_shift) + o_sq
    else:
        h = d_dot_c - jnp.sum(d * o, -1)[:, None]
        oc_sq = c_sq - 2.0 * o_dot_c + o_sq
    cc = oc_sq - (radius * radius)[None, :]
    disc = h * h - cc
    sphere_ok = disc >= 0.0
    # double-where: sqrt'(0) = inf would leak NaN into gradients of the
    # masked-out branch, so feed sqrt a safe value where there is no hit
    sq = jnp.sqrt(jnp.where(sphere_ok, jnp.maximum(disc, 1e-20), 1.0))
    s_r1 = h - sq
    s_r2 = h + sq

    # --- planeShape family (Geometry.hs:117-142) ---
    u = e1
    v = e2
    cp = jnp.cross(u, v)                                  # [C,3]
    cp_sq_raw = vdot0(cp, cp)
    # degenerate (zero-area) rows: substitute dummy geometry so 1/cp_sq
    # can't overflow into NaN gradients; they are masked out of plane_ok
    degen = cp_sq_raw < 1e-24
    cp = jnp.where(degen[:, None], jnp.asarray([0.0, 0.0, 1.0], DTYPE), cp)
    cp_sq = jnp.where(degen, 1.0, cp_sq_raw)
    n_unit = cp * jax.lax.rsqrt(cp_sq)[:, None]           # unit normal
    n_s = cp / cp_sq[:, None]                             # scaled normal
    w_a = jnp.cross(v, n_s)                               # a = p_rel . w_a
    w_b = jnp.cross(n_s, u)                               # b = p_rel . w_b

    denom = _bdot(d, n_unit)                              # [R,C]
    q_dot_n = vdot0(p0, n_unit)[None, :]
    o_dot_n = _bdot(o, n_unit)
    if has_motion:
        n_mv0 = vdot0(n_unit, mv0)[None, :]
        n_dmv = vdot0(n_unit, dmv)[None, :]
        q_dot_n = q_dot_n + n_mv0 + tr * n_dmv            # plane shifts with prim
    denom_safe = jnp.where(jnp.abs(denom) > DENOM_EPS, denom, 1.0)
    t_plane = (q_dot_n - o_dot_n) / denom_safe

    # p_rel . w = (o - q + t d) . w  (+ motion shift of q)
    o_dot_wa = _bdot(o, w_a)
    d_dot_wa = _bdot(d, w_a)
    q_dot_wa = vdot0(p0, w_a)[None, :]
    o_dot_wb = _bdot(o, w_b)
    d_dot_wb = _bdot(d, w_b)
    q_dot_wb = vdot0(p0, w_b)[None, :]
    if has_motion:
        q_dot_wa = q_dot_wa + vdot0(w_a, mv0)[None, :] + tr * vdot0(w_a, dmv)[None, :]
        q_dot_wb = q_dot_wb + vdot0(w_b, mv0)[None, :] + tr * vdot0(w_b, dmv)[None, :]
    a = o_dot_wa - q_dot_wa + t_plane * d_dot_wa
    b = o_dot_wb - q_dot_wb + t_plane * d_dot_wb

    member_para = (0.0 <= a) & (a <= 1.0) & (0.0 <= b) & (b <= 1.0)
    member_tri = (a >= 0.0) & (b >= 0.0) & (a + b <= 1.0)
    plane_ok = (jnp.abs(denom) > DENOM_EPS) & ~degen[None, :] & jnp.where(
        is_para, member_para, member_tri
    )

    r1 = jnp.where(
        is_sphere, jnp.where(sphere_ok, s_r1, INF),
        jnp.where((is_para | is_tri) & plane_ok, t_plane, INF),
    )
    r2 = jnp.where(is_sphere & sphere_ok, s_r2, INF)

    if has_box:
        # --- axis-aligned box slab test (p0 = lo, e1 = hi) ---
        # Entry/exit roots play the same two-root role as sphere roots:
        # r1 = slab entry, r2 = exit, so a ray starting inside takes the
        # exit — identical selection to the reference's 6-parallelogram
        # cuboid under roots_to_hit_t (Geometry.hs:154-166 + 74-80).
        tn = jnp.full(r1.shape, -INF, DTYPE)
        tf = jnp.full(r1.shape, INF, DTYPE)
        for ax in range(3):
            d_ax = d[:, ax:ax + 1]                        # [R,1]
            inv = 1.0 / jnp.where(
                jnp.abs(d_ax) < 1e-20,
                jnp.where(d_ax < 0, -1e-20, 1e-20), d_ax)
            lo_ax = p0[None, :, ax]
            hi_ax = e1[None, :, ax]
            if has_motion:
                sh = mv0[None, :, ax] + tr * dmv[None, :, ax]
                lo_ax = lo_ax + sh
                hi_ax = hi_ax + sh
            t0 = (lo_ax - o[:, ax:ax + 1]) * inv
            t1 = (hi_ax - o[:, ax:ax + 1]) * inv
            tn = jnp.maximum(tn, jnp.minimum(t0, t1))
            tf = jnp.minimum(tf, jnp.maximum(t0, t1))
        box_ok = (kind == PRIM_BOX) & (tn <= tf)
        r1 = jnp.where(box_ok, tn, r1)
        r2 = jnp.where(box_ok, tf, r2)
    return r1, r2


def roots_to_hit_t(r1, r2, tmin, tmax):
    """Reference root selection (Geometry.hs:74-80): nearest root strictly
    inside the open interval, else the far root, else miss (+inf)."""
    ok1 = (tmin < r1) & (r1 < tmax)
    ok2 = (tmin < r2) & (r2 < tmax)
    return jnp.where(ok1, r1, jnp.where(ok2, r2, INF))


def _prim_chunk(prims: Primitives, start, size):
    sl = lambda x: jax.lax.dynamic_slice_in_dim(x, start, size, 0)
    return (sl(prims.kind), sl(prims.p0), sl(prims.e1), sl(prims.e2),
            sl(prims.mv0), sl(prims.mv1))


def _chunk_size(n_prims: int, n_rays: int) -> int:
    c = max(8, _TILE_BUDGET // max(n_rays, 1))
    c = 1 << int(math.floor(math.log2(c)))
    return min(n_prims, c)


def dense_nearest(prims: Primitives, o, d, time, tmin, tmax):
    """Nearest hit by scanning all primitives in [R, C] tiles, carrying a
    running (t, prim_index) minimum — the array form of the reference
    ``group`` fold with shrinking t_max (Geometry.hs:336-347)."""
    n = prims.kind.shape[0]
    r = o.shape[0]
    c = _chunk_size(n, r)
    steps = -(-n // c)

    def step(carry, i):
        best_t, best_i = carry
        start = jnp.minimum(i * c, n - c)
        kind, p0, e1, e2, mv0, mv1 = _prim_chunk(prims, start, c)
        r1, r2 = chunk_roots(kind, p0, e1, e2, mv0, mv1, prims.has_motion,
                             o, d, time, has_box=prims.has_box)
        t = roots_to_hit_t(r1, r2, tmin[:, None], tmax[:, None])
        ci = jnp.argmin(t, axis=1)
        ct = jnp.take_along_axis(t, ci[:, None], axis=1)[:, 0]
        better = ct < best_t
        best_i = jnp.where(better, start + ci, best_i)
        best_t = jnp.where(better, ct, best_t)
        return (best_t, best_i), None

    init = (jnp.full((r,), INF, DTYPE), jnp.full((r,), -1, jnp.int32))
    (best_t, best_i), _ = jax.lax.scan(step, init, jnp.arange(steps))
    return best_t, best_i


def bvh_nearest(prims: Primitives, bvh: BVH, o, d, time, tmin, tmax,
                leaf_size: int):
    """Stackless threaded-BVH traversal (escape indices), vectorized over
    rays via a single while_loop: each lane carries its own node cursor and
    shrinking best-t (ordered-traversal semantics of Geometry.hs:356-361).
    """
    n_nodes = bvh.n_nodes
    rcount = o.shape[0]
    inv_d = 1.0 / d

    def cond(state):
        node, best_t, best_i = state
        return jnp.any(node < n_nodes)

    def body(state):
        node, best_t, best_i = state
        active = node < n_nodes
        ni = jnp.minimum(node, n_nodes - 1)
        lo = bvh.lo[ni]
        hi = bvh.hi[ni]
        count = bvh.count[ni]
        start = bvh.start[ni]
        skip = bvh.skip[ni]

        t0 = (lo - o) * inv_d
        t1 = (hi - o) * inv_d
        t_near = jnp.maximum(jnp.max(jnp.minimum(t0, t1), axis=-1), tmin)
        t_far = jnp.minimum(jnp.min(jnp.maximum(t0, t1), axis=-1),
                            jnp.minimum(tmax, best_t))
        hit_box = t_near <= t_far
        is_leaf = count > 0

        do_prims = active & hit_box & is_leaf
        for j in range(leaf_size):
            pi = jnp.minimum(start + j, prims.kind.shape[0] - 1)
            valid = do_prims & (j < count)
            t = _single_prim_t(prims, pi, o, d, time, tmin,
                               jnp.minimum(tmax, best_t))
            better = valid & (t < best_t)
            best_t = jnp.where(better, t, best_t)
            best_i = jnp.where(better, pi, best_i)

        nxt = jnp.where(hit_box & ~is_leaf, node + 1, skip)
        node = jnp.where(active, nxt, node)
        return node, best_t, best_i

    init = (
        jnp.zeros((rcount,), jnp.int32),
        jnp.full((rcount,), INF, DTYPE),
        jnp.full((rcount,), -1, jnp.int32),
    )
    node, best_t, best_i = jax.lax.while_loop(cond, body, init)
    return best_t, best_i


def _single_prim_t(prims: Primitives, pi, o, d, time, tmin, tmax):
    """Hit t of each ray against its own gathered primitive ``pi[R]``."""
    rows = (prims.kind[pi], prims.p0[pi], prims.e1[pi], prims.e2[pi],
            prims.mv0[pi] if prims.has_motion else None,
            prims.mv1[pi] if prims.has_motion else None)
    return _single_prim_t_rows(rows, prims.has_motion, o, d, time, tmin,
                               tmax, has_box=prims.has_box)


def _box_roots_rows(lo, hi, o, d):
    """Slab entry/exit of each ray vs its own box row (lo, hi [R,3]).
    Returns ``(tn, tf, ok)``; the caller applies kind/interval masks."""
    d_safe = jnp.where(jnp.abs(d) < 1e-20,
                       jnp.where(d < 0, -1e-20, 1e-20), d)
    t0 = (lo - o) / d_safe
    t1 = (hi - o) / d_safe
    tn = jnp.max(jnp.minimum(t0, t1), axis=-1)
    tf = jnp.min(jnp.maximum(t0, t1), axis=-1)
    return tn, tf, tn <= tf


def _single_prim_t_rows(rows, has_motion, o, d, time, tmin, tmax,
                        has_box: bool = False):
    """Hit t from pre-gathered per-ray primitive rows
    ``(kind, p0, e1, e2, mv0, mv1)`` — each [R] / [R,3].

    Split out so the differentiable path can gather rows via one-hot
    matmuls (ops/diff_intersect.py)."""
    kind, p0, e1, e2, mv0, mv1 = rows
    if has_motion:
        shift = mv0 + time[:, None] * (mv1 - mv0)
        o = o - shift
    is_sphere = kind == PRIM_SPHERE

    # sphere
    oc = p0 - o
    h = vdot0(d, oc)
    cc = vdot0(oc, oc) - e1[:, 0] * e1[:, 0]
    disc = h * h - cc
    sq = jnp.sqrt(jnp.where(disc >= 0.0, jnp.maximum(disc, 1e-20), 1.0))
    s_r1 = h - sq
    s_r2 = h + sq

    # plane
    cp = jnp.cross(e1, e2)
    cp_sq_raw = vdot0(cp, cp)
    degen = cp_sq_raw < 1e-24
    cp = jnp.where(degen[:, None], jnp.asarray([0.0, 0.0, 1.0], DTYPE), cp)
    cp_sq = jnp.where(degen, 1.0, cp_sq_raw)
    n_unit = cp * jax.lax.rsqrt(cp_sq)[:, None]
    denom = vdot0(n_unit, d)
    denom_safe = jnp.where(jnp.abs(denom) > DENOM_EPS, denom, 1.0)
    t_plane = vdot0(n_unit, p0 - o) / denom_safe
    p_rel = o + t_plane[:, None] * d - p0
    n_s = cp / cp_sq[:, None]
    a = vdot0(n_s, jnp.cross(p_rel, e2))
    b = vdot0(n_s, jnp.cross(e1, p_rel))
    member = jnp.where(
        kind == PRIM_PARALLELOGRAM,
        (0.0 <= a) & (a <= 1.0) & (0.0 <= b) & (b <= 1.0),
        (a >= 0.0) & (b >= 0.0) & (a + b <= 1.0),
    )
    plane_ok = (jnp.abs(denom) > DENOM_EPS) & ~degen & member

    r1 = jnp.where(is_sphere, jnp.where(disc >= 0.0, s_r1, INF),
                   jnp.where(plane_ok, t_plane, INF))
    r2 = jnp.where(is_sphere & (disc >= 0.0), s_r2, INF)
    if has_box:
        tn, tf, ok = _box_roots_rows(p0, e1, o, d)
        box_ok = (kind == PRIM_BOX) & ok
        r1 = jnp.where(box_ok, tn, r1)
        r2 = jnp.where(box_ok, tf, r2)
    return roots_to_hit_t(r1, r2, tmin, tmax)


def nearest_hit_t(scene_prims: Primitives, bvh: BVH | None, o, d, time,
                  tmin, tmax, leaf_size: int = 4):
    if bvh is not None:
        return bvh_nearest(scene_prims, bvh, o, d, time, tmin, tmax, leaf_size)
    return dense_nearest(scene_prims, o, d, time, tmin, tmax)


def apply_sphere_rotations(outward, idx, sphere_rots):
    """Rotate world-space sphere outward normals into OBJECT space for the
    rows listed in ``sphere_rots`` (static ``((row, 9-float world->object
    rotation), ...)``; scene/compile.py bakes instancing rotations there).

    The reference evaluates ``sphereUV`` on the inverse-transformed ray
    (Geometry.hs:382-391 + 100-104), i.e. in object space, so a rotated
    image-textured sphere shows a rotated texture.  Rotated spheres are
    rare (demo2 has exactly one), so this is an unrolled compare+select
    per listed row — elementwise work, no gathers.  Only UV evaluation uses
    the result; shading normals stay world-space.
    """
    if not sphere_rots:
        return outward
    out = outward
    for row, r9 in sphere_rots:
        rot = jnp.asarray(r9, DTYPE).reshape(3, 3)
        sel = (idx == row)[:, None]
        out = jnp.where(sel, matmul(outward, rot.T), out)
    return out


def make_hit_record(prims: Primitives, idx, o, d, time, t) -> HitRecord:
    """Reconstruct the full hit record for winning primitive ``idx[R]``
    (gather + recompute — cheaper than carrying records through the
    reduction).  Normals face the ray; ``front`` is the reference's
    front-side flag (Geometry.hs:85-90, 131-140)."""
    hit = idx >= 0
    pi = jnp.maximum(idx, 0)
    rows = (prims.kind[pi], prims.p0[pi], prims.e1[pi], prims.e2[pi],
            prims.mv0[pi] if prims.has_motion else None,
            prims.mv1[pi] if prims.has_motion else None,
            prims.uvs[pi])
    return make_hit_record_rows(rows, prims.has_motion, prims.mat[pi],
                                idx, o, d, time, t, has_box=prims.has_box,
                                sphere_rots=prims.sphere_rots)


def make_hit_record_rows(rows, has_motion, mat, idx, o, d, time,
                         t, has_box: bool = False,
                         sphere_rots: tuple = ()) -> HitRecord:
    """:func:`make_hit_record` from pre-gathered per-ray rows
    ``(kind, p0, e1, e2, mv0, mv1, uvs)`` (see ``_single_prim_t_rows``)."""
    hit = idx >= 0
    kind, p0, e1, e2, mv0, mv1, uvs_rows = rows
    if has_motion:
        shift = mv0 + time[:, None] * (mv1 - mv0)
        p0 = p0 + shift
        if has_box:
            e1 = jnp.where((kind == PRIM_BOX)[:, None], e1 + shift, e1)

    point = o + t[:, None] * d
    is_sphere = (kind == PRIM_SPHERE)[:, None]

    # sphere record (Geometry.hs:82-91): outward normal, polar uv
    radius = jnp.where(jnp.abs(e1[:, 0]) > 0, e1[:, 0], 1.0)
    outward = (point - p0) / radius[:, None]
    s_front = vdot0(d, outward) <= 0.0
    s_normal = jnp.where(s_front[:, None], outward, -outward)
    # sphereUV (Geometry.hs:100-104) in OBJECT space: rotated instances
    # un-rotate the outward normal first (shading normal stays world)
    outward_uv = apply_sphere_rotations(outward, idx, sphere_rots)
    # atan2 grads blow up when x=z=0 (the poles / padded rows), so feed it
    # safe coordinates there
    xz_ok = outward_uv[:, 0] ** 2 + outward_uv[:, 2] ** 2 > 1e-12
    ox = jnp.where(xz_ok, outward_uv[:, 0], 0.0)
    oz = jnp.where(xz_ok, outward_uv[:, 2], 1.0)
    s_u = jnp.arctan2(ox, oz) / (2.0 * jnp.pi) + 0.5
    s_v = jnp.arccos(
        jnp.clip(-outward_uv[:, 1], -1.0 + 1e-6, 1.0 - 1e-6)) / jnp.pi
    s_uv = jnp.stack([s_u, s_v], axis=-1)

    # plane record (Geometry.hs:131-141)
    cp = jnp.cross(e1, e2)
    cp_sq_raw = vdot0(cp, cp)
    degen = cp_sq_raw < 1e-24
    cp = jnp.where(degen[:, None], jnp.asarray([0.0, 0.0, 1.0], DTYPE), cp)
    cp_sq = jnp.where(degen, 1.0, cp_sq_raw)
    n_unit = cp * jax.lax.rsqrt(cp_sq)[:, None]
    n_s = cp / cp_sq[:, None]
    p_rel = point - p0
    a = vdot0(n_s, jnp.cross(p_rel, e2))
    b = vdot0(n_s, jnp.cross(e1, p_rel))
    denom = vdot0(n_unit, d)
    p_front = denom < 0.0
    p_normal = jnp.where(p_front[:, None], n_unit, -n_unit)
    uv0 = uvs_rows[:, 0]
    uv1 = uvs_rows[:, 1]
    uv2 = uvs_rows[:, 2]
    ab = jnp.stack([a, b], axis=-1)
    tri_uv = ((1.0 - a - b)[:, None] * uv0 + a[:, None] * uv1
              + b[:, None] * uv2)
    p_uv = jnp.where((kind == PRIM_TRIANGLE)[:, None], tri_uv, ab)

    normal = jnp.where(is_sphere, s_normal, p_normal)
    front = jnp.where(is_sphere[:, 0], s_front, p_front)
    uv = jnp.where(is_sphere, s_uv, p_uv)

    if has_box:
        # box record: face from the dominant normalized offset of the hit
        # point from the box center (argmax axis is piecewise-constant in
        # the params, so gradients flow through uv/point only — same
        # detachment discipline as the sphere front flag).  The per-face
        # uv orientation reproduces the reference's six-parallelogram
        # winding (Geometry.hs:154-166): see scene/builder.py:box_faces.
        is_box = (kind == PRIM_BOX)[:, None]
        lo = p0
        hi = e1
        size = jnp.maximum(hi - lo, 1e-12)
        rel = (point - 0.5 * (lo + hi)) / size          # in [-.5,.5] on faces
        arel = jnp.abs(rel)
        ax_x = (arel[:, 0] >= arel[:, 1]) & (arel[:, 0] >= arel[:, 2])
        ax_y = ~ax_x & (arel[:, 1] >= arel[:, 2])
        ax_z = ~ax_x & ~ax_y
        sgn = jnp.sign(jnp.where(rel == 0.0, 1.0, rel))
        axes = jnp.stack([ax_x, ax_y, ax_z], axis=-1)
        outward = jnp.where(axes, sgn, 0.0)
        b_front = vdot0(d, outward) < 0.0
        b_normal = jnp.where(b_front[:, None], outward, -outward)
        fx = (point[:, 0] - lo[:, 0]) / size[:, 0]
        fy = (point[:, 1] - lo[:, 1]) / size[:, 1]
        fz = (point[:, 2] - lo[:, 2]) / size[:, 2]
        pos = sgn > 0.0
        # face -> (a, b) per the reference cuboid winding:
        #   +z: (fx, fy)       -z: (1-fx, fy)
        #   -x: (fz, fy)       +x: (1-fz, fy)
        #   +y: (fx, 1-fz)     -y: (fx, fz)
        b_a = jnp.where(
            ax_z, jnp.where(pos[:, 2], fx, 1.0 - fx),
            jnp.where(ax_x, jnp.where(pos[:, 0], 1.0 - fz, fz), fx))
        b_b = jnp.where(
            ax_y, jnp.where(pos[:, 1], 1.0 - fz, fz), fy)
        b_uv = jnp.stack([b_a, b_b], axis=-1)
        normal = jnp.where(is_box, b_normal, normal)
        front = jnp.where(is_box[:, 0], b_front, front)
        uv = jnp.where(is_box, b_uv, uv)

    return HitRecord(
        t=t,
        point=point,
        normal=normal,
        front=front,
        uv=uv,
        mat=mat,
        hit=hit & jnp.isfinite(t),
    )
