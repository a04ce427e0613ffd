"""Counter-based RNG for the path tracer.

The reference threads a ``StdGen`` through every sampling site and
pre-splits one generator per pixel (``Ray.hs:234-236``); here we use JAX's
counter-based threefry keys derived deterministically from
``(pixel_index, sample_index, bounce_depth, draw_site)``.  This makes every
random draw a pure function of logical coordinates, so renders are
bit-identical regardless of how the ray buffer is sharded across devices —
the array answer to the reference's determinism-via-split-seeds.

The reference's rejection samplers (Core.hs:54-68) are replaced by
*branchless, exactly equidistributed* transforms (no data-dependent loops,
which XLA cannot vectorize):
  * uniform unit vector  <- normalized isotropic Gaussian
  * uniform in unit disk <- sqrt(u) * (cos, sin)(2 pi v)
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from .vecmath import DTYPE, normalize

# Auditing switch: True routes every uniform_block through a full
# threefry pass (reference-quality stream, ~2.5x the cost) instead of the
# fast counter-hash — for checking statistical-quality concerns.
USE_THREEFRY = False
# False disables the two-uniforms-per-hash-word fast path (see
# uniform_block) and restores 24-bit mantissas.
USE_PAIR16 = True


def base_key(seed: int):
    return jax.random.key(seed)


def ray_keys(key, pixel_ids, sample_ids):
    """One key per ray from absolute (pixel, sample) coordinates.

    Shard-count invariant: depends only on logical ids, not layout.
    """
    k = jax.vmap(jax.random.fold_in, in_axes=(None, 0))(key, pixel_ids)
    return jax.vmap(jax.random.fold_in)(k, sample_ids)


# Hot-path key derivation: instead of chaining threefry passes (fold_in is
# a full threefry application), build the 64-bit threefry *key* directly
# from the logical coordinates with odd-constant multiplies (bijective, so
# (pixel, sample) -> key is collision-free) — threefry is a PRF in its key,
# so the generated streams stay independent.  ~20x cheaper per bounce.

def ray_keys_fast(key, pixel_ids, sample_ids):
    kd = jax.random.key_data(key).astype(jnp.uint32)
    p = pixel_ids.astype(jnp.uint32)
    s = sample_ids.astype(jnp.uint32)
    k0 = kd[0] ^ (p * jnp.uint32(0x9E3779B1)) ^ (s * jnp.uint32(0x632BE5AB))
    k1 = kd[1] ^ (s * jnp.uint32(0x85EBCA77)) ^ (p * jnp.uint32(0xB5297A4D))
    return jax.random.wrap_key_data(jnp.stack([k0, k1], axis=-1))


def mix_depth(keys, depth):
    """Cheap per-bounce key derivation (vs a full fold_in threefry pass)."""
    kd = jax.random.key_data(keys).astype(jnp.uint32)
    dep = jnp.asarray(depth).astype(jnp.uint32)
    dep = jnp.broadcast_to(dep, kd.shape[:-1])
    k0 = kd[..., 0] + dep * jnp.uint32(0xC2B2AE3D)
    k1 = kd[..., 1] ^ (dep * jnp.uint32(0x27D4EB2F))
    return jax.random.wrap_key_data(jnp.stack([k0, k1], axis=-1))


def fold_depth(keys, depth):
    """Derive the per-bounce key from a per-ray key (vectorized fold_in)."""
    return jax.vmap(jax.random.fold_in, in_axes=(0, None))(keys, depth)


def site(keys, i: int):
    """Derive the key for draw-site ``i`` within a bounce."""
    return jax.vmap(jax.random.fold_in, in_axes=(0, None))(keys, i)


def uniform(keys, shape=(), dtype=DTYPE):
    """U[0,1) per key; ``shape`` are extra trailing dims."""
    return jax.vmap(lambda k: jax.random.uniform(k, shape, dtype))(keys)


def uniform_block_threefry(keys, n: int, dtype=DTYPE):
    """[R, n] uniforms from one threefry pass per key (reference-quality
    stream; ~2.5x the cost of :func:`uniform_block`)."""
    return jax.vmap(lambda k: jax.random.uniform(k, (n,), dtype))(keys)


def uniform_block(keys, n: int, dtype=DTYPE):
    """[R, n] uniforms via a counter-hash: column c of lane key (k0, k1)
    is ``finalize(finalize(k0 + c*phi) ^ k1)`` where ``finalize`` is a
    full-avalanche 32-bit mixer (Murmur3-style, improved constants).

    ~10 integer ops per uniform vs threefry's ~40.  Each (pixel, sample,
    depth, column)
    still maps injectively into the hash input, so streams stay
    deterministic and shard-invariant; statistical quality is validated
    by tests/test_rng.py (collision-freedom over the full bench key
    domain, column serial correlation, pairwise uniformity) and the
    golden-parity renders.  :data:`USE_THREEFRY` swaps in the threefry
    stream as an auditing fallback."""
    if USE_THREEFRY:
        return uniform_block_threefry(keys, n, dtype)
    kd = jax.random.key_data(keys).astype(jnp.uint32)
    k0 = kd[..., 0:1]
    k1 = kd[..., 1:2]
    if USE_PAIR16:
        # Two 16-bit uniforms per hash word: halves the integer hashing
        # at 14 columns/lane/bounce, and every
        # consumer is a Monte-Carlo sampling transform where 2^-16
        # resolution is far below the estimator noise floor (golden
        # parity + the test_rng batteries both hold on the half-words of
        # the full-avalanche mix).  USE_PAIR16 = False restores 24-bit
        # mantissas; USE_THREEFRY the reference-quality stream.
        # NOTE for consumers: with 16-bit resolution a draw is EXACTLY
        # 0.0 with probability 2^-16 (~60 zero draws per 2^18-lane
        # bounce) — never divide by a uniform or take log(u) without a
        # clamp (volumes.py clamps; sqrt/compares are safe).  This fast
        # path (default since round 2) also changes the default RNG
        # stream: renders are not bit-identical to pre-pair16 versions.
        m = (n + 1) // 2
        cols = jnp.arange(m, dtype=jnp.uint32)
        h = _finalize2(k0 + cols * jnp.uint32(0x9E3779B9), k1)
        lo = (h & jnp.uint32(0xFFFF)).astype(dtype)
        hi = (h >> jnp.uint32(16)).astype(dtype)
        # columns [0, m) take the low half-words, [m, 2m) the high ones
        # (a concat, NOT an interleave — the interleaved layout measured
        # slower than the hashes it saved)
        u = jnp.concatenate([lo, hi], axis=-1)
        return u[..., :n] * dtype(1.0 / (1 << 16))
    cols = jnp.arange(n, dtype=jnp.uint32)
    h = _finalize2(k0 + cols * jnp.uint32(0x9E3779B9), k1)
    # 24-bit mantissa -> [0, 1)
    return (h >> jnp.uint32(8)).astype(dtype) * dtype(1.0 / (1 << 24))


def _finalize2(h, k1):
    """Two-round full-avalanche 32-bit mixer (Murmur3-style, improved
    constants by Pelle Evensen / T. Mueller), keyed by ``k1``."""
    h = h ^ (h >> 16)
    h = h * jnp.uint32(0x21F0AAAD)
    h = h ^ (h >> 15)
    h = h * jnp.uint32(0x735A2D97)
    h = h ^ (h >> 15)
    h = h ^ k1
    h = h ^ (h >> 16)
    h = h * jnp.uint32(0xD35A2D97)
    h = h ^ (h >> 15)
    return h


def unit_vector_from_uniforms(u, v):
    """Uniform unit vectors from two U[0,1) draws — z = 1-2u is uniform in
    [-1,1], azimuth 2*pi*v; exact spherical uniformity with only
    sqrt/sincos (no erfinv, unlike Gaussian normalization)."""
    z = 1.0 - 2.0 * u
    r = jnp.sqrt(jnp.maximum(1.0 - z * z, 0.0))
    phi = (2.0 * jnp.pi) * v
    return jnp.stack([r * jnp.cos(phi), r * jnp.sin(phi), z], axis=-1)


def disk_from_uniforms(u, v):
    """Uniform points in the unit disk from two U[0,1) draws."""
    r = jnp.sqrt(u)
    theta = (2.0 * jnp.pi) * v
    return jnp.stack([r * jnp.cos(theta), r * jnp.sin(theta)], axis=-1)


def unit_vector(keys, dtype=DTYPE):
    """Uniformly distributed points on the unit sphere (replaces the
    rejection loop at Core.hs:54-61 with a branchless Gaussian transform;
    the distribution is identical)."""
    g = jax.vmap(lambda k: jax.random.normal(k, (3,), dtype))(keys)
    return normalize(g)


def in_unit_disk(keys, dtype=DTYPE):
    """Uniformly distributed points in the closed unit disk (replaces the
    rejection loop at Core.hs:63-68; identical distribution)."""
    u = jax.vmap(lambda k: jax.random.uniform(k, (2,), dtype))(keys)
    r = jnp.sqrt(u[..., 0])
    theta = 2.0 * jnp.pi * u[..., 1]
    return jnp.stack([r * jnp.cos(theta), r * jnp.sin(theta)], axis=-1)
