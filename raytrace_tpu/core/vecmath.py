"""Core vector / interval / AABB math for the path tracer.

Array re-design of the reference's ``Graphics.Ray.Core``
(``/root/reference/src/Graphics/Ray/Core.hs``): the reference works on single
``V3 Double`` values; here every helper is written against ``jnp`` arrays whose
*last* axis is the 3-vector axis, so the same code path serves one ray or a
million rays.

Reference parity notes (file:line cites into /root/reference):
  * ``reflect``         — Core.hs:49-51
  * ``refract``         — Material.hs:81-85 (private helper there)
  * interval semantics  — Core.hs:76-106 (open intervals)
  * slab test           — Core.hs:147-152 (``overlapsBox``)
"""
from __future__ import annotations

import math

import jax
import jax.numpy as jnp

# Default compute dtype (the reference uses f64 on CPU; f32 + scale-aware
# epsilons reproduces its images statistically).
DTYPE = jnp.float32

# Every f32 contraction on the render and gradient path states this
# precision.  At DEFAULT a GPU may run an f32 matmul in TF32 (~10 mantissa
# bits): at Cornell's coordinates (~555) plane distances and gathered
# vertices would be off by ~0.3 scene units, and ids carried through a
# one-hot matmul would no longer round-trip exactly.
HIGHEST = jax.lax.Precision.HIGHEST

INFINITY = float("inf")


def degrees(x):
    """Convert degrees to radians (reference Core.hs:25-27 ``degrees``)."""
    return x * math.pi / 180.0


def vdot(a, b):
    """Dot product over the trailing 3-axis, keeping the axis (shape [..., 1])."""
    return jnp.sum(a * b, axis=-1, keepdims=True)


def vdot0(a, b):
    """Dot product over the trailing 3-axis, dropping the axis (shape [...])."""
    return jnp.sum(a * b, axis=-1)


def matmul(a, b):
    """``a @ b`` at :data:`HIGHEST` precision."""
    return jnp.matmul(a, b, precision=HIGHEST)


def onehot_rows(idx, n: int):
    """One-hot [R, n] selector for ``idx[R]`` (f32), for
    :func:`gather_rows`: its backward is the matmul ``onehot.T @ ct``
    instead of a scatter-add."""
    return jax.nn.one_hot(idx, n, dtype=DTYPE)


def gather_rows(oh, table):
    """Gather ``table[idx]`` given ``oh = onehot_rows(idx, n)``.

    ``table`` is [n] or [n, ...]; returns [R] / [R, ...].  At HIGHEST
    precision every output is exactly one table entry."""
    if table.ndim <= 2:
        return matmul(oh, table)
    flat = matmul(oh, table.reshape(table.shape[0], -1))
    return flat.reshape((oh.shape[0],) + table.shape[1:])


def quadrance(a):
    return jnp.sum(a * a, axis=-1)


def vnorm(a):
    return jnp.sqrt(jnp.sum(a * a, axis=-1))


def normalize(a, eps: float = 1e-12):
    """Unit-length vectors along the last axis, safe at zero length."""
    q = jnp.sum(a * a, axis=-1, keepdims=True)
    return a * jax_rsqrt(jnp.maximum(q, eps))


def jax_rsqrt(x):
    return 1.0 / jnp.sqrt(x)


def vcross(a, b):
    """Cross product over the trailing 3-axis."""
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return jnp.stack(
        [ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx], axis=-1
    )


def reflect(normal, v):
    """Mirror ``v`` about the plane with unit normal ``normal``.

    Reference: Core.hs:49-51.
    """
    return v - 2.0 * vdot(normal, v) * normal


def refract(ior_ratio, cos_theta, normal, u):
    """Snell refraction of unit vector ``u`` about unit ``normal``.

    ``ior_ratio`` is eta_in/eta_out and ``cos_theta`` = dot(normal, -u),
    both broadcast against the leading dims. Reference: Material.hs:81-85.
    """
    ior_ratio = jnp.asarray(ior_ratio)[..., None]
    cos_theta = jnp.asarray(cos_theta)[..., None]
    perp = ior_ratio * (u + cos_theta * normal)
    # max() keeps sqrt' finite at grazing incidence (|perp| -> 1)
    rem = jnp.maximum(jnp.abs(1.0 - jnp.sum(perp * perp, axis=-1, keepdims=True)),
                      1e-12)
    return perp - jnp.sqrt(rem) * normal


# ---------------------------------------------------------------------------
# Intervals — represented as a pair of arrays (tmin, tmax); open intervals,
# matching reference Core.hs:83-85 (``inInterval`` uses strict <).
# ---------------------------------------------------------------------------

def in_interval(tmin, tmax, t):
    return jnp.logical_and(tmin < t, t < tmax)


# ---------------------------------------------------------------------------
# Axis-aligned boxes — SoA as (lo[...,3], hi[...,3]).
# ---------------------------------------------------------------------------

def box_from_corners(a, b):
    """Box spanned by two opposite corners (Core.hs:113-114)."""
    return jnp.minimum(a, b), jnp.maximum(a, b)


def box_join(lo_a, hi_a, lo_b, hi_b):
    """Smallest box containing both boxes (Core.hs:117-118)."""
    return jnp.minimum(lo_a, lo_b), jnp.maximum(hi_a, hi_b)


def box_hull(points, axis=-2):
    """Smallest box containing all points along ``axis`` (Core.hs:121-126)."""
    return jnp.min(points, axis=axis), jnp.max(points, axis=axis)


def ray_box_range(lo, hi, orig, inv_dir, tmin, tmax):
    """Slab test: clip ``[tmin, tmax]`` against the box along the ray.

    Returns (t_enter, t_exit); the ray overlaps the box iff t_enter <= t_exit.
    Matches reference ``overlapsBox`` (Core.hs:147-152): per-axis
    ``(bound - origin) / d`` with min/max swap, intersected across axes.
    ``inv_dir`` is the precomputed reciprocal direction; IEEE infs from zero
    components give the correct open-slab behaviour just as Haskell's
    Double division does.
    """
    t0 = (lo - orig) * inv_dir
    t1 = (hi - orig) * inv_dir
    t_near = jnp.minimum(t0, t1)
    t_far = jnp.maximum(t0, t1)
    t_enter = jnp.maximum(jnp.max(t_near, axis=-1), tmin)
    t_exit = jnp.minimum(jnp.min(t_far, axis=-1), tmax)
    return t_enter, t_exit


def ray_box_overlaps(lo, hi, orig, inv_dir, tmin, tmax):
    t_enter, t_exit = ray_box_range(lo, hi, orig, inv_dir, tmin, tmax)
    return t_enter <= t_exit
