"""Precision guard: every f32 contraction on the render and gradient path
states ``HIGHEST``.

At DEFAULT precision a GPU may run an f32 matmul in TF32 (~10 mantissa
bits), which at Cornell's coordinates moves plane distances and gathered
vertices by ~0.3 scene units (core/vecmath.py:HIGHEST).  Each case lowers
one step to StableHLO and checks every ``dot_general`` in it.
"""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import raytrace_tpu as rt
from raytrace_tpu.core import rng
from raytrace_tpu.core.vecmath import gather_rows, onehot_rows

_DOT = re.compile(r"stablehlo\.dot_general.*")


def _cornell(width=8, spp=2, depth=4):
    from __graft_entry__ import _cornell_scene_and_settings
    return _cornell_scene_and_settings(width=width, spp=spp, depth=depth)


def _assert_all_highest(lowered):
    text = lowered.as_text()
    dots = _DOT.findall(text)
    assert dots, "no dot_general in the lowered step"
    bad = [d for d in dots if "precision = [HIGHEST, HIGHEST]" not in d]
    assert not bad, f"{len(bad)}/{len(dots)} dot_general not HIGHEST: {bad[0]}"


def _fog_scene():
    world = rt.group([
        rt.with_material(rt.light_source(rt.constant_texture(4.0)),
                         rt.parallelogram([-2, -2, -4], [4, 0, 0],
                                          [0, 4, 0])),
        rt.with_material(rt.isotropic(rt.constant_texture(0.3)),
                         rt.constant_medium(0.8, rt.sphere([0, 0, -2], 1.0))),
        rt.with_material(rt.lambertian(rt.noise_texture(
            2, 1.0, [0, 0, 0], [0.1, 0.1, 0.1], [0.9, 0.9, 0.9])),
            rt.sphere([0, -3, -3], 1.0)),
    ])
    return rt.compile_scene(world)


def test_forward_step_is_highest():
    """Cornell wavefront with MIS redirection (the redirect pdf and the
    one-hot material gathers)."""
    from raytrace_tpu.render.integrator import trace_wavefront_stationary
    scene, s = _cornell()
    fn = jax.jit(lambda sc, st, k: trace_wavefront_stationary(
        sc, st, k, 64, 2))
    _assert_all_highest(fn.lower(scene, s, rng.base_key(0)))


def test_diff_step_is_highest():
    """Loss and gradients of the differentiable wavefront, backward
    (transposed) contractions included."""
    from raytrace_tpu.diff.gradients import partition, render_loss_wavefront
    scene, s = _cornell()
    params, statics = partition(scene)
    fn = jax.jit(jax.value_and_grad(render_loss_wavefront, has_aux=True),
                 static_argnames=("spp", "n_iters"))
    _assert_all_highest(fn.lower(
        params, statics, s, rng.base_key(0), jnp.arange(64, dtype=jnp.int32),
        jnp.zeros((64, 3)), spp=2, n_iters=8))


def test_volume_step_is_highest():
    """One bounce through a medium (crossing scan + density score) with a
    noise texture, forward and backward."""
    from raytrace_tpu.diff.gradients import combine, partition
    from raytrace_tpu.render.integrator import bounce, n_bounce_uniforms
    scene = _fog_scene()
    s = rt.CameraSettings(background=rt.const_background(0.1))
    r = 32
    params, statics = partition(scene)

    def loss(params, o, d, u):
        sc = combine(params, statics)
        out = bounce(sc, s, o, d, jnp.zeros(r), u, jnp.zeros((r, 3)),
                     jnp.ones((r, 3)), jnp.ones(r, bool), diff=True)
        return jnp.sum(out[2]) + jnp.sum(out[3])

    o = jnp.zeros((r, 3))
    d = jnp.tile(jnp.asarray([[0.0, 0.0, -1.0]]), (r, 1))
    u = jnp.full((r, n_bounce_uniforms(scene)), 0.5)
    _assert_all_highest(jax.jit(jax.grad(loss)).lower(params, o, d, u))


def test_ellipsoid_step_is_highest():
    """Spheres under a non-uniform scale go through the ellipsoid buffer
    (ops/ellipsoid.py einsums)."""
    from raytrace_tpu.render.integrator import _surface_hit
    world = rt.with_material(
        rt.lambertian(rt.constant_texture(0.5)),
        rt.transform(np.diag([1.0, 2.0, 0.5, 1.0]),
                     rt.sphere([0, 0, -4], 1.0)))
    scene = rt.compile_scene(world)
    assert scene.ellipsoids is not None
    s = rt.CameraSettings()
    r = 16
    fn = jax.jit(lambda o, d: _surface_hit(scene, s, o, d, jnp.zeros(r))[0])
    _assert_all_highest(fn.lower(jnp.zeros((r, 3)),
                                 jnp.tile(jnp.asarray([[0.0, 0.0, -1.0]]),
                                          (r, 1))))


def test_gather_rows_is_exact():
    """The one-hot gather returns table entries bit for bit, for f32
    values with full 24-bit mantissas at Cornell scale."""
    r = np.random.default_rng(0)
    table = r.uniform(0.0, 555.0, (24, 9)).astype(np.float32)
    idx = r.integers(0, 24, 1000).astype(np.int32)
    got = jax.jit(lambda t, i: gather_rows(onehot_rows(i, 24), t))(
        jnp.asarray(table), jnp.asarray(idx))
    np.testing.assert_array_equal(np.asarray(got), table[idx])


@pytest.mark.gpu
def test_gather_and_bdot_on_gpu(gpu_device):
    """On the card: the gather stays bit-exact and the intersection
    contraction stays within f32 rounding (TF32 would not)."""
    from raytrace_tpu.ops.intersect import _bdot
    r = np.random.default_rng(1)
    table = r.uniform(0.0, 555.0, (24, 9)).astype(np.float32)
    idx = r.integers(0, 24, 1000).astype(np.int32)
    got = jax.jit(lambda t, i: gather_rows(onehot_rows(i, 24), t))(
        jax.device_put(table, gpu_device), jax.device_put(idx, gpu_device))
    np.testing.assert_array_equal(np.asarray(got), table[idx])
    x = r.uniform(-555, 555, (512, 3)).astype(np.float32)
    y = r.uniform(-555, 555, (24, 3)).astype(np.float32)
    got = np.asarray(jax.jit(_bdot)(jax.device_put(x, gpu_device),
                                    jax.device_put(y, gpu_device)),
                     np.float64)
    x64, y64 = x.astype(np.float64), y.astype(np.float64)
    bound = 4 * 2.0 ** -24 * (np.abs(x64) @ np.abs(y64).T)
    assert np.all(np.abs(got - x64 @ y64.T) <= bound)
