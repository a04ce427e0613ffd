"""The differentiable wavefront (render/integrator.py:trace_wavefront_diff):
its forward equals the production forward driver, remat does not change
its result, and its texture gradients match finite differences.

Finite differences use common random numbers (same key on both sides).
Without Russian roulette, texture parameters change no sampling
decision, so the loss is a smooth function of them and central
differences are exact up to f32 rounding.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import raytrace_tpu as rt
from raytrace_tpu.core import rng
from raytrace_tpu.diff.gradients import (
    partition, render_loss_wavefront,
)
from raytrace_tpu.render.integrator import (
    trace_wavefront_diff, trace_wavefront_stationary,
)

W, SPP, ITERS = 12, 4, 60


def _settings(**kw):
    return rt.CameraSettings(
        center=jnp.asarray([0.0, 0.5, 2.0]),
        look_at=jnp.asarray([0.0, 0.0, -3.0]), vfov=1.0, image_width=W,
        samples_per_pixel=SPP, max_depth=5,
        background=rt.const_background(0.3), **kw)


def _scene(tex):
    light = rt.light_source(rt.constant_texture(3.0))
    return rt.compile_scene(rt.group([
        rt.with_material(rt.lambertian(tex), rt.sphere([0, 0, -3], 1.2)),
        rt.with_material(rt.lambertian(rt.constant_texture(0.6)),
                         rt.parallelogram([-5, -1.2, 0], [10, 0, 0],
                                          [0, 0, -10])),
        rt.with_material(light, rt.parallelogram([-2, 3, -1], [4, 0, 0],
                                                 [0, 0, -4])),
    ]))


def _mesh_scene(tex):
    """A textured triangle mesh (a uv-mapped quad pair) under a light."""
    v = np.asarray([[-2, -1, -4], [2, -1, -4], [2, 2, -3], [-2, 2, -3.0]])
    uv = np.asarray([[0, 0], [1, 0], [1, 1], [0, 1.0]])
    f = np.asarray([[0, 1, 2], [0, 2, 3]])
    mesh = rt.Mesh(vertices=v, uv=uv, faces=f, uv_faces=f.copy())
    light = rt.light_source(rt.constant_texture(3.0))
    return rt.compile_scene(rt.group([
        rt.with_material(rt.lambertian(tex), rt.triangle_mesh(mesh)),
        rt.with_material(light, rt.parallelogram([-2, 3, 0], [4, 0, 0],
                                                 [0, 0, -4])),
    ]))


def _loss_fn(scene, s):
    params, statics = partition(scene)
    pix = jnp.arange(W * W, dtype=jnp.int32)
    target = jnp.full((W * W, 3), 0.2, jnp.float32)

    def loss(params):
        val, frac = render_loss_wavefront(params, statics, s,
                                          rng.base_key(5), pix, target,
                                          spp=SPP, n_iters=ITERS)
        return val
    return params, statics, jax.jit(loss)


@pytest.mark.parametrize("rr", [None, 2], ids=["exact", "rr"])
def test_diff_forward_matches_production_driver(rr):
    scene = _scene(rt.checker_texture(4, 4, [0.8, 0.2, 0.2],
                                      [0.2, 0.2, 0.8]))
    s = _settings(rr_depth=rr)
    key = rng.base_key(2)
    mean, done = trace_wavefront_diff(scene, s, key,
                                      jnp.arange(W * W, dtype=jnp.int32),
                                      SPP, n_iters=ITERS)
    assert np.all(np.asarray(done) == SPP)
    acc = trace_wavefront_stationary(scene, s, key, W * W, SPP)
    np.testing.assert_allclose(np.asarray(mean), np.asarray(acc) / SPP,
                               rtol=1e-5, atol=1e-6)


def test_remat_does_not_change_loss_or_gradients():
    scene = _scene(rt.noise_texture(2, 1.0, [0, 0, 0], [0.1, 0.3, 0.2],
                                    [0.9, 0.7, 0.5]))
    s = _settings()
    params, statics = partition(scene)
    pix = jnp.arange(W * W, dtype=jnp.int32)
    target = jnp.full((W * W, 3), 0.2, jnp.float32)
    out = {}
    for remat in (True, False):
        vg = jax.value_and_grad(render_loss_wavefront, has_aux=True)
        out[remat] = vg(params, statics, s, rng.base_key(1), pix, target,
                        spp=SPP, n_iters=ITERS, remat=remat)
    (l1, f1), g1 = out[True]
    (l0, f0), g0 = out[False]
    assert float(f1) == float(f0) == 1.0
    np.testing.assert_allclose(float(l1), float(l0), rtol=1e-6)
    for a, b in zip(jax.tree_util.tree_leaves(g1),
                    jax.tree_util.tree_leaves(g0)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-5, atol=1e-7)


def _fd_check(scene, s, leaf_path, index, eps):
    """jax.grad vs central FD of one element of one texture-table leaf."""
    params, statics, loss = _loss_fn(scene, s)
    g = jax.grad(loss)(params)
    g_val = np.asarray(getattr(g.textures, leaf_path))[index]

    def bumped(delta):
        arr = getattr(params.textures, leaf_path)
        tex = params.textures.replace(
            **{leaf_path: arr.at[index].add(delta)})
        return float(loss(params.replace(textures=tex)))

    fd = (bumped(eps) - bumped(-eps)) / (2 * eps)
    assert abs(g_val) > 1e-6, "the probed parameter does not matter"
    np.testing.assert_allclose(g_val, fd, rtol=2e-2, atol=1e-6)


def test_image_texture_gradient_matches_fd():
    r = np.random.default_rng(0)
    scene = _scene(rt.image_texture(r.uniform(0.2, 0.8, (6, 10, 3))))
    g = jax.grad(_loss_fn(scene, _settings())[2])(partition(scene)[0])
    hot = np.unravel_index(np.argmax(np.abs(np.asarray(g.textures.images))),
                           g.textures.images.shape)
    _fd_check(scene, _settings(), "images", hot, 1e-2)


def test_checker_color_gradient_matches_fd():
    scene = _scene(rt.checker_texture(4, 4, [0.8, 0.2, 0.2],
                                      [0.2, 0.2, 0.8]))
    _fd_check(scene, _settings(), "c1", (0, 2), 1e-2)


def test_noise_color_gradient_matches_fd():
    scene = _scene(rt.noise_texture(3, 1.5, [0, 0, 0], [0.1, 0.3, 0.2],
                                    [0.9, 0.7, 0.5]))
    _fd_check(scene, _settings(), "c0", (0, 1), 1e-2)


def test_marble_frequency_gradient_matches_fd():
    scene = _scene(rt.marble_texture([0.0, 0.3, 0.1], 2.0))
    _fd_check(scene, _settings(), "f0", (0,), 1e-3)


def test_image_texture_on_mesh_gradient_matches_fd():
    r = np.random.default_rng(1)
    scene = _mesh_scene(rt.image_texture(r.uniform(0.2, 0.8, (4, 4, 3))))
    s = _settings()
    g = jax.grad(_loss_fn(scene, s)[2])(partition(scene)[0])
    hot = np.unravel_index(np.argmax(np.abs(np.asarray(g.textures.images))),
                           g.textures.images.shape)
    _fd_check(scene, s, "images", hot, 1e-2)
