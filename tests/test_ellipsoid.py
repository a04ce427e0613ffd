"""Spheres under arbitrary affines (ellipsoids).

The reference accepts any M44 on a sphere (inverse-transforms the ray,
Geometry.hs:382-391) with its Euclidean-only normal caveat; round 1
raised ValueError for non-uniform scale.  Ellipsoids now compile into a
dedicated object-space buffer merged after the main primitive scan.
"""
import numpy as np
import jax
import jax.numpy as jnp

import raytrace_tpu as rt
from raytrace_tpu.core import rng as rrng
from raytrace_tpu.render.integrator import _surface_hit, trace

M = rt.lambertian(rt.constant_texture(0.5))


def _scale3(sx, sy, sz):
    m = np.eye(4)
    m[0, 0], m[1, 1], m[2, 2] = sx, sy, sz
    return m


def _ell_scene(extra=()):
    world = rt.group([
        rt.transform(
            rt.compose(rt.translate([0, 0, -5]), _scale3(2.0, 1.0, 0.5)),
            rt.with_material(M, rt.sphere([0, 0, 0], 1.0))),
        *extra,
    ])
    return rt.compile_scene(world)


def test_compile_accepts_nonuniform_sphere():
    scene = _ell_scene()
    assert scene.ellipsoids is not None and scene.ellipsoids.n == 1
    np.testing.assert_allclose(np.asarray(scene.ellipsoids.fwd[0]),
                               np.diag([2.0, 1.0, 0.5]), atol=1e-6)


def test_ellipsoid_hit_geometry():
    """Implicit surface check: hit points satisfy |A^-1 (p - b)| = r, the
    normal matches the analytic gradient direction for a diagonal scale,
    and t is the nearest crossing."""
    scene = _ell_scene()
    s = rt.CameraSettings(center=jnp.zeros(3),
                          look_at=jnp.asarray([0.0, 0.0, -5.0]),
                          vfov=0.5, image_width=4, aspect_ratio=1.0,
                          samples_per_pixel=1, max_depth=2,
                          background=rt.const_background(0.0))
    n = 64
    g = np.random.default_rng(0)
    o = jnp.zeros((n, 3), jnp.float32)
    d = np.asarray([0, 0, -5.0]) + 0.6 * g.normal(size=(n, 3))
    d = jnp.asarray(d / np.linalg.norm(d, axis=1, keepdims=True), jnp.float32)
    time = jnp.zeros((n,), jnp.float32)
    t, idx, normal, front, uv, mat = _surface_hit(scene, s, o, d, time)
    hit = np.isfinite(np.asarray(t))
    assert hit.sum() > 20
    p = np.asarray(o + t[:, None] * d)[hit]
    inv = np.diag([0.5, 1.0, 2.0])
    obj = (p - np.asarray([0, 0, -5.0])) @ inv.T
    np.testing.assert_allclose(np.linalg.norm(obj, axis=1), 1.0, atol=1e-4)
    # ellipsoid lanes are tagged idx <= -2
    assert (np.asarray(idx)[hit] <= -2).all()
    # NOTE: no facing-direction assertion on the world normal — the
    # reference transforms normals by A, not A^-T (its documented
    # Euclidean-only caveat, Geometry.hs:380-382), so the caveat normal
    # of a non-Euclidean instance may point anywhere; we only preserve
    # that exact semantics (checked directionally below) plus unit norm.
    nrm = np.asarray(normal)[hit]
    np.testing.assert_allclose(np.linalg.norm(nrm, axis=1), 1.0, atol=1e-5)
    # reference normal semantics: A @ n_obj, normalized.  For diagonal A,
    # n_obj = obj (unit), so expected direction = normalize(A @ obj)
    fwd = np.diag([2.0, 1.0, 0.5])
    exp = obj @ fwd.T
    exp /= np.linalg.norm(exp, axis=1, keepdims=True)
    np.testing.assert_allclose(nrm, exp, atol=1e-4)


def test_ellipsoid_nearest_vs_prims():
    """An ellipsoid in front of a parallelogram wins the argmin; behind
    it, the parallelogram wins."""
    extra = [rt.with_material(M, rt.parallelogram([-5, -5, -8], [10, 0, 0],
                                                  [0, 10, 0]))]
    scene = _ell_scene(extra)
    s = rt.CameraSettings(center=jnp.zeros(3),
                          look_at=jnp.asarray([0.0, 0.0, -5.0]),
                          vfov=0.5, image_width=4, aspect_ratio=1.0,
                          samples_per_pixel=1, max_depth=2,
                          background=rt.const_background(0.0))
    o = jnp.zeros((2, 3), jnp.float32)
    d = jnp.asarray([[0, 0, -1.0], [0.6, 0.1, -1.0]], jnp.float32)
    d = d / jnp.linalg.norm(d, axis=1, keepdims=True)
    time = jnp.zeros((2,), jnp.float32)
    t, idx, normal, front, uv, mat = _surface_hit(scene, s, o, d, time)
    assert int(idx[0]) <= -2          # straight ray hits the ellipsoid
    assert int(idx[1]) >= 0           # oblique ray misses it, hits the quad
    assert abs(float(t[0]) - 4.5) < 1e-3   # z extent 0.5 around z=-5


def test_ellipsoid_render_and_gradient():
    """End-to-end: differentiable trace through an ellipsoid scene runs
    and yields finite, nonzero gradients for the ellipsoid radius."""
    light = rt.light_source(rt.constant_texture(3.0))
    scene = _ell_scene([rt.with_material(
        light, rt.parallelogram([-3, 3, -3], [6, 0, 0], [0, 0, -4]))])
    s = rt.CameraSettings(center=jnp.zeros(3),
                          look_at=jnp.asarray([0.0, 0.0, -5.0]),
                          vfov=0.7, image_width=4, aspect_ratio=1.0,
                          samples_per_pixel=2, max_depth=3,
                          background=rt.const_background(0.2))
    n = 64
    o = jnp.zeros((n, 3), jnp.float32)
    g = np.random.default_rng(1)
    d = np.asarray([0, 0, -5.0]) + 0.8 * g.normal(size=(n, 3))
    d = jnp.asarray(d / np.linalg.norm(d, axis=1, keepdims=True), jnp.float32)
    time = jnp.zeros((n,), jnp.float32)
    keys = rrng.ray_keys_fast(rrng.base_key(0),
                              jnp.arange(n, dtype=jnp.int32),
                              jnp.zeros(n, jnp.int32))

    def loss(radius):
        sc = scene.replace(ellipsoids=scene.ellipsoids.replace(
            radius=radius))
        img = trace(sc, s, o, d, time, keys, differentiable=True)
        return jnp.mean(img)

    val, grad = jax.value_and_grad(loss)(scene.ellipsoids.radius)
    assert np.isfinite(float(val))
    assert np.isfinite(np.asarray(grad)).all()

    # FD check on the smooth quantity: mean hit t vs radius (radiance
    # itself depends on the radius only through discrete visibility in
    # this constant-albedo scene, which finite differences can't probe)
    def mean_t(radius):
        sc = scene.replace(ellipsoids=scene.ellipsoids.replace(
            radius=radius))
        t, *_ = _surface_hit(sc, s, o, d, time)
        return jnp.mean(jnp.where(jnp.isfinite(t), t, 0.0))

    g_t = jax.grad(lambda r: mean_t(r))(scene.ellipsoids.radius)
    eps = 1e-3
    fd = (mean_t(scene.ellipsoids.radius + eps)
          - mean_t(scene.ellipsoids.radius - eps)) / (2 * eps)
    np.testing.assert_allclose(float(g_t[0]), float(fd), rtol=0.02,
                               atol=1e-4)


def test_ellipsoid_rejected_as_medium_boundary():
    import pytest
    with pytest.raises(ValueError):
        rt.compile_scene(rt.with_material(
            rt.isotropic(rt.constant_texture(0.5)),
            rt.constant_medium(0.5, rt.transform(
                _scale3(2.0, 1.0, 0.5), rt.sphere([0, 0, 0], 1.0)))))
