"""Ellipsoid (sphere under arbitrary affine) intersection.

Reference semantics (``transform``, Geometry.hs:382-391 + ``sphere``,
Geometry.hs:58-104): the ray is inverse-transformed — origin by the full
affine inverse, direction by the linear inverse WITHOUT renormalizing —
so the object-space hit parameter t is directly the world-space t (world
point = M(o' + t d') = o + t Md' ... with d' = A^-1 d).  The sphere's
two-root selection runs against the same open interval; the hit normal is
transformed by the forward linear part A (the reference's Euclidean-only
caveat; we additionally normalize, which is a no-op for Euclidean A and
strictly better for the non-Euclidean case), and UV is the object-space
polar map (Geometry.hs:100-104).

Vectorized [R rays x E ellipsoids]; E is tiny (ellipsoids are rare), so
this is a handful of small einsums merged after the main primitive scan.
"""
from __future__ import annotations

import jax.numpy as jnp

from ..core.vecmath import HIGHEST, vdot0
from ..scene.types import Ellipsoids

INF = jnp.inf


def ellipsoid_nearest(ells: Ellipsoids, o, d, time, t_min: float):
    """Nearest ellipsoid hit per ray.

    Returns ``(t, e_idx, normal, front, uv)``: ``t`` is +inf on miss,
    ``e_idx`` the winning ellipsoid row (-1 on miss), ``normal`` the
    unit world normal facing the ray, ``uv`` the object-space polar uv.
    """
    r = o.shape[0]
    # world origin relative to the instance (motion shifts the instance
    # in world space, reference `moving` Geometry.hs:447-456)
    rel = o[:, None, :] - ells.shift[None, :, :]            # [R,E,3]
    if ells.has_motion:
        mshift = (ells.mv0[None, :, :]
                  + time[:, None, None] * (ells.mv1 - ells.mv0)[None, :, :])
        rel = rel - mshift
    # object-space ray (direction NOT renormalized: t stays world t)
    op = jnp.einsum("rek,eik->rei", rel, ells.inv,          # A^-1 rel
                    precision=HIGHEST)
    dp = jnp.einsum("rk,eik->rei", d, ells.inv,             # A^-1 d
                    precision=HIGHEST)

    oc = ells.center[None, :, :] - op                       # [R,E,3]
    a = jnp.sum(dp * dp, -1)
    h = jnp.sum(dp * oc, -1)
    c = jnp.sum(oc * oc, -1) - (ells.radius * ells.radius)[None, :]
    disc = h * h - a * c
    ok = disc >= 0.0
    a_safe = jnp.maximum(a, 1e-30)
    sq = jnp.sqrt(jnp.where(ok, jnp.maximum(disc, 1e-30), 1.0))
    r1 = (h - sq) / a_safe
    r2 = (h + sq) / a_safe
    t_cand = jnp.where(r1 > t_min, r1, jnp.where(r2 > t_min, r2, INF))
    t_cand = jnp.where(ok, t_cand, INF)                     # [R,E]

    best_t = jnp.min(t_cand, axis=1)
    e_idx = jnp.where(jnp.isfinite(best_t), jnp.argmin(t_cand, axis=1), -1)
    ei = jnp.maximum(e_idx, 0)

    # winner attributes (E is tiny: gather rows directly)
    t_safe = jnp.where(jnp.isfinite(best_t), best_t, 1.0)
    op_w = jnp.take_along_axis(op, ei[:, None, None].repeat(3, -1),
                               axis=1)[:, 0]                # [R,3]
    dp_w = jnp.take_along_axis(dp, ei[:, None, None].repeat(3, -1),
                               axis=1)[:, 0]
    center_w = ells.center[ei]
    radius_w = jnp.where(jnp.abs(ells.radius[ei]) > 0, ells.radius[ei], 1.0)
    hit_obj = op_w + t_safe[:, None] * dp_w
    outward_obj = (hit_obj - center_w) / radius_w[:, None]  # unit in object
    front = vdot0(dp_w, outward_obj) <= 0.0

    # world normal: forward linear map (Geometry.hs:393 caveat), normalized
    fwd_w = ells.fwd[ei]                                    # [R,3,3]
    n_world = jnp.einsum("rik,rk->ri", fwd_w, outward_obj,
                         precision=HIGHEST)
    n_norm = jnp.sqrt(jnp.maximum(jnp.sum(n_world * n_world, -1), 1e-30))
    n_world = n_world / n_norm[:, None]
    normal = jnp.where(front[:, None], n_world, -n_world)

    # object-space polar uv (Geometry.hs:100-104)
    xz_ok = outward_obj[:, 0] ** 2 + outward_obj[:, 2] ** 2 > 1e-12
    ox = jnp.where(xz_ok, outward_obj[:, 0], 0.0)
    oz = jnp.where(xz_ok, outward_obj[:, 2], 1.0)
    u = jnp.arctan2(ox, oz) / (2.0 * jnp.pi) + 0.5
    v = jnp.arccos(
        jnp.clip(-outward_obj[:, 1], -1.0 + 1e-6, 1.0 - 1e-6)) / jnp.pi
    uv = jnp.stack([u, v], axis=-1)
    return best_t, e_idx, normal, front, uv


def merge_ellipsoid_hits(ells: Ellipsoids, o, d, time, t_min: float,
                         t_srf, idx, normal, front, uv, mat_id):
    """Merge the ellipsoid nearest hit into a ``_surface_hit`` result
    tuple (global argmin).  Ellipsoid-winning lanes get ``idx = -2 - e``
    (never matches a primitive row; still < 0 only on miss semantics are
    preserved via t's finiteness)."""
    t_e, e_idx, n_e, fr_e, uv_e = ellipsoid_nearest(ells, o, d, time, t_min)
    win = t_e < t_srf
    t_out = jnp.where(win, t_e, t_srf)
    idx_out = jnp.where(win, -2 - e_idx, idx)
    normal_out = jnp.where(win[:, None], n_e, normal)
    front_out = jnp.where(win, fr_e, front)
    uv_out = jnp.where(win[:, None], uv_e, uv)
    mat_out = jnp.where(win, ells.mat[jnp.maximum(e_idx, 0)], mat_id)
    return t_out, idx_out, normal_out, front_out, uv_out, mat_out
