"""RNG tests: distribution correctness + shard-invariant determinism."""
import jax.numpy as jnp
import numpy as np

from raytrace_tpu.core import rng


def _keys(n, seed=0):
    return rng.ray_keys(rng.base_key(seed), jnp.arange(n),
                        jnp.zeros(n, jnp.int32))


def test_unit_vector_distribution():
    k = _keys(4096)
    v = np.asarray(rng.unit_vector(k))
    np.testing.assert_allclose(np.linalg.norm(v, axis=-1), 1.0, atol=1e-5)
    # uniform on sphere: mean ~ 0, per-component variance ~ 1/3
    assert np.abs(v.mean(0)).max() < 0.05
    np.testing.assert_allclose(v.var(0), 1 / 3, atol=0.02)


def test_in_unit_disk_distribution():
    k = _keys(4096)
    p = np.asarray(rng.in_unit_disk(k))
    r = np.linalg.norm(p, axis=-1)
    assert r.max() <= 1.0 + 1e-6
    # uniform in disk: E[r^2] = 1/2
    assert np.isclose((r ** 2).mean(), 0.5, atol=0.02)


def test_keys_depend_on_coordinates_only():
    # same (pixel, sample) -> same key regardless of batch layout
    a = rng.ray_keys(rng.base_key(7), jnp.asarray([3, 10]), jnp.asarray([1, 2]))
    b = rng.ray_keys(rng.base_key(7), jnp.asarray([10, 5, 3]),
                     jnp.asarray([2, 0, 1]))
    ua = np.asarray(rng.uniform(a))
    ub = np.asarray(rng.uniform(b))
    assert ua[0] == ub[2]  # pixel 3, sample 1
    assert ua[1] == ub[0]  # pixel 10, sample 2


def test_sites_and_depths_differ():
    k = _keys(8)
    u0 = np.asarray(rng.uniform(rng.site(k, 0)))
    u1 = np.asarray(rng.uniform(rng.site(k, 1)))
    d0 = np.asarray(rng.uniform(rng.fold_depth(k, 0)))
    d1 = np.asarray(rng.uniform(rng.fold_depth(k, 1)))
    assert not np.allclose(u0, u1)
    assert not np.allclose(d0, d1)


def test_uniform_range():
    u = np.asarray(rng.uniform(_keys(1024)))
    assert u.min() >= 0.0 and u.max() < 1.0
    assert np.isclose(u.mean(), 0.5, atol=0.03)


def test_ray_keys_fast_collision_free_large_domain():
    """Injectivity of the (pixel, sample) -> 64-bit key mix, checked over
    a 512x512-pixel x 64-sample domain (16.7M keys) in numpy uint32
    arithmetic identical to core/rng.py:ray_keys_fast.  (The full
    600px/200spp Cornell bench domain — 72M keys — was verified
    collision-free offline with the same code.)"""
    def keys64(p, s, k0=0x12345678, k1=0x9ABCDEF0):
        p = p.astype(np.uint32)
        s = s.astype(np.uint32)
        a = (np.uint32(k0) ^ (p * np.uint32(0x9E3779B1))
             ^ (s * np.uint32(0x632BE5AB)))
        b = (np.uint32(k1) ^ (s * np.uint32(0x85EBCA77))
             ^ (p * np.uint32(0xB5297A4D)))
        return (a.astype(np.uint64) << np.uint64(32)) | b.astype(np.uint64)

    n_pix, n_s = 512 * 512, 64
    pp, ss = np.meshgrid(np.arange(n_pix, dtype=np.uint32),
                         np.arange(n_s, dtype=np.uint32), indexing="ij")
    k = keys64(pp.ravel(), ss.ravel())
    assert np.unique(k).size == k.size
    # the numpy replica must match the jax implementation bit-for-bit
    import jax.random
    jk = rng.ray_keys_fast(
        jax.random.wrap_key_data(
            jnp.asarray([0x12345678, 0x9ABCDEF0], jnp.uint32)),
        jnp.asarray([0, 1, 511, 77777], jnp.int32),
        jnp.asarray([0, 3, 63, 199], jnp.int32))
    jd = np.asarray(jax.random.key_data(jk)).astype(np.uint64)
    got = (jd[:, 0] << np.uint64(32)) | jd[:, 1]
    want = keys64(np.asarray([0, 1, 511, 77777]),
                  np.asarray([0, 3, 63, 199]))
    np.testing.assert_array_equal(got, want)


def test_uniform_block_column_serial_correlation():
    """Adjacent uniform_block columns (the per-bounce draw sites) must be
    uncorrelated: Pearson |r| < 4/sqrt(N) for every adjacent pair, and
    the lag-1 autocorrelation along the lane axis likewise."""
    n = 1 << 16
    keys = rng.ray_keys_fast(rng.base_key(5),
                             jnp.arange(n, dtype=jnp.int32),
                             jnp.zeros(n, jnp.int32))
    u = np.asarray(rng.uniform_block(keys, 14))
    bound = 4.0 / np.sqrt(n)
    for c in range(13):
        r = np.corrcoef(u[:, c], u[:, c + 1])[0, 1]
        assert abs(r) < bound, (c, r)
    for c in range(14):
        r = np.corrcoef(u[:-1, c], u[1:, c])[0, 1]
        assert abs(r) < bound, (c, r)


def test_uniform_block_pairwise_uniformity():
    """2-D chi-square: (col c, col c+1) pairs fill a 16x16 grid uniformly
    (catches lattice structure a 1-D test misses)."""
    n = 1 << 18
    keys = rng.ray_keys_fast(rng.base_key(9),
                             jnp.arange(n, dtype=jnp.int32),
                             jnp.zeros(n, jnp.int32))
    u = np.asarray(rng.uniform_block(keys, 4))
    g = 16
    for c in range(3):
        i = np.minimum((u[:, c] * g).astype(int), g - 1)
        j = np.minimum((u[:, c + 1] * g).astype(int), g - 1)
        counts = np.bincount(i * g + j, minlength=g * g)
        expected = n / (g * g)
        chi2 = float(((counts - expected) ** 2 / expected).sum())
        # dof = 255; mean 255, std ~22.6 -> 6 sigma ~= 391
        assert chi2 < 391, (c, chi2)


def test_threefry_fallback_switch(monkeypatch):
    """USE_THREEFRY routes uniform_block through the threefry stream."""
    n = 128
    keys = rng.ray_keys_fast(rng.base_key(1),
                             jnp.arange(n, dtype=jnp.int32),
                             jnp.zeros(n, jnp.int32))
    fast = np.asarray(rng.uniform_block(keys, 4))
    monkeypatch.setattr(rng, "USE_THREEFRY", True)
    tf = np.asarray(rng.uniform_block(keys, 4))
    ref = np.asarray(rng.uniform_block_threefry(keys, 4))
    np.testing.assert_array_equal(tf, ref)
    assert not np.array_equal(fast, tf)
    assert (tf >= 0).all() and (tf < 1).all()
