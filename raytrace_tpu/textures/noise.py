"""3D Perlin gradient noise, vectorized over whole ray batches.

Re-design of the reference ``Graphics.Ray.Noise`` (Noise.hs:15-92): same
algorithm — period-256 lattice, three XOR-combined permutation tables, 256
precomputed unit-vector gradients, smoothstep-weighted trilinear blend of the
eight corner gradient dot products — but evaluated for a whole ``[..., 3]``
batch of points at once.

The permutation tables are the reference's fixed tables
(:mod:`._perlin_tables`, Noise.hs:52-92).  The gradient table in the
reference is 256 rejection-sampled unit vectors from Haskell's
``mkStdGen 666`` (Noise.hs:86-92); that bitstream is not reproducible
outside GHC, so the gradient for lattice hash ``h`` is *computed* (a
full-avalanche integer mix of ``h`` mapped to a uniform unit vector) —
same distribution, same noise statistics, different concrete pattern
(pixel parity with the reference is statistical, not bitwise; see
SURVEY.md §7 "hard parts" (b)).

Table traffic: the naive form looks up 4 tables x 8 corners per call,
~450 lookups per bounce with 7-octave fractal + turbulence textures.
Since the reference's *gradient* bitstream is unreproducible anyway
(above), the permutation tables buy no parity — so the default lattice
hash is pure arithmetic (a murmur avalanche of the period-256 lattice
coordinates): zero table traffic, same noise statistics.  ``perlin_noise(..., use_tables=True)`` keeps the
reference-table path (tests / bit-level table checks).
"""
from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from ..core.vecmath import DTYPE, matmul
from ._perlin_tables import PERMX, PERMY, PERMZ

# [256, 2] f32 per axis: column 0 = perm, column 1 = perm shifted by one —
# one one-hot matmul yields both lattice-corner lookups (values <= 255 are
# exact in f32 at HIGHEST precision).
# Built lazily: creating device arrays at import time would initialize
# the XLA backend, which must not happen before
# ``jax.distributed.initialize`` in multi-process jobs (multihost.py).
_PERM2_CACHE: dict = {}


def _perm2(ax: str):
    if not _PERM2_CACHE:
        for a, t in (("x", PERMX), ("y", PERMY), ("z", PERMZ)):
            ti = jnp.asarray(t, dtype=jnp.int32)
            _PERM2_CACHE[a] = jnp.stack(
                [ti.astype(jnp.float32),
                 jnp.roll(ti, -1).astype(jnp.float32)], axis=1)
    return _PERM2_CACHE[ax]


def _perm_pair(axis: str, idx):
    """(perm[idx & 255], perm[(idx+1) & 255]) as i32, scatter/gather-free."""
    import jax.nn
    flat = (idx & 255).reshape(-1)
    oh = jax.nn.one_hot(flat, 256, dtype=jnp.float32)
    both = matmul(oh, _perm2(axis))               # [R, 2]
    both = both.astype(jnp.int32).reshape(idx.shape + (2,))
    return both[..., 0], both[..., 1]


def _smoothstep(x):
    return x * x * (3.0 - 2.0 * x)


def _hash_gradient(h):
    """Uniform unit vector from lattice hash ``h`` (i32 in [0, 256)).

    Murmur-style avalanche of ``h`` supplies two independent uniforms;
    (z, phi) mapping gives exact spherical uniformity.  Arithmetic only —
    replaces a [R] gather from a 256x3 table (see module docstring).
    """
    u = h.astype(jnp.uint32)
    u = (u ^ (u >> 4)) * jnp.uint32(0x21F0AAAD)
    u = u ^ (u >> 15)
    u = u * jnp.uint32(0x735A2D97)
    u = u ^ (u >> 13)
    # both halves fit int32 exactly
    u1 = (u & jnp.uint32(0xFFFF)).astype(jnp.int32).astype(DTYPE) \
        * DTYPE(1.0 / 65536.0)
    u2 = (u >> jnp.uint32(16)).astype(jnp.int32).astype(DTYPE) \
        * DTYPE(1.0 / 65536.0)
    z = 1.0 - 2.0 * u1
    r = jnp.sqrt(jnp.maximum(1.0 - z * z, 0.0))
    phi = (2.0 * np.pi) * u2
    return r * jnp.cos(phi), r * jnp.sin(phi), z


def _ava(c, mul):
    """Murmur avalanche of the period-256 lattice coordinate ``c`` (i32)."""
    u = (c & 255).astype(jnp.uint32) * jnp.uint32(mul)
    u = (u ^ (u >> 4)) * jnp.uint32(0x21F0AAAD)
    u = u ^ (u >> 15)
    return u.astype(jnp.int32)


def _blend_corners(hx, hy, hz, fx, fy, fz):
    """Smoothstep-weighted trilinear blend of the 8 corner gradient dots
    (Noise.hs:15-39).  ``hx/hy/hz`` are per-axis (h(c), h(c+1)) pairs."""
    total = jnp.zeros_like(fx)
    sx, sy, sz = _smoothstep(fx), _smoothstep(fy), _smoothstep(fz)
    for i in (0, 1):
        for j in (0, 1):
            for k in (0, 1):
                gx, gy, gz = _hash_gradient(hx[i] ^ hy[j] ^ hz[k])
                dot = (gx * (fx - i) + gy * (fy - j) + gz * (fz - k))
                coef = (
                    (sx if i else (1.0 - sx))
                    * (sy if j else (1.0 - sy))
                    * (sz if k else (1.0 - sz))
                )
                total = total + coef * dot
    return total


def perlin_noise_soa(px, py, pz):
    """Arithmetic-hash Perlin noise on SoA components.

    Pure elementwise arithmetic (no tables, no gathers); identical to
    ``perlin_noise(p, use_tables=False)``.
    """
    ipx, ipy, ipz = jnp.floor(px), jnp.floor(py), jnp.floor(pz)
    fx, fy, fz = px - ipx, py - ipy, pz - ipz
    hs = []
    for c, mul in ((ipx, 0x9E3779B1), (ipy, 0x85EBCA77), (ipz, 0xC2B2AE3D)):
        c = c.astype(jnp.int32)
        hs.append((_ava(c, mul), _ava(c + 1, mul)))
    return _blend_corners(hs[0], hs[1], hs[2], fx, fy, fz)


def perlin_noise(p, use_tables: bool = False):
    """Perlin noise for points ``p`` of shape [..., 3] -> noise of shape [...].

    Values lie in [-sqrt(3)/2, +sqrt(3)/2] (Noise.hs:17-19).
    """
    p = jnp.asarray(p, DTYPE)
    if not use_tables:
        return perlin_noise_soa(p[..., 0], p[..., 1], p[..., 2])
    ip = jnp.floor(p)
    f = p - ip  # fractional part in [0, 1)
    ip = ip.astype(jnp.int32)
    # hoisted permutation lookups: one one-hot matmul per axis
    hx = _perm_pair("x", ip[..., 0])
    hy = _perm_pair("y", ip[..., 1])
    hz = _perm_pair("z", ip[..., 2])
    return _blend_corners(hx, hy, hz, f[..., 0], f[..., 1], f[..., 2])


def fractal_noise(depth: int, p, use_tables: bool = False):
    """Sum of ``depth`` octaves: weight halves, frequency doubles per octave
    (Noise.hs:41-46). ``depth`` is static."""
    p = jnp.asarray(p, DTYPE)
    total = jnp.zeros(p.shape[:-1], DTYPE)
    coef = 1.0
    for _ in range(depth):
        total = total + coef * perlin_noise(p, use_tables=use_tables)
        coef *= 0.5
        p = p * 2.0
    return total


def turbulence(depth: int, p, use_tables: bool = False):
    """Absolute value of fractal noise (Noise.hs:48-50)."""
    return jnp.abs(fractal_noise(depth, p, use_tables=use_tables))
