"""Integrator physics tests: closed-form light transport checks.

The reference has no unit tests (SURVEY.md §4); these are the
golden-physics tests this build adds: energy conservation, material
behaviour, MIS unbiasedness.
"""
import jax
import jax.numpy as jnp
import numpy as np

import raytrace_tpu as rt
from raytrace_tpu.core import rng
from raytrace_tpu.render.camera import camera_frame, generate_rays
from raytrace_tpu.render.integrator import trace


def _trace_rays(scene, settings, o, d, seed=0):
    n = o.shape[0]
    keys = rng.ray_keys(rng.base_key(seed), jnp.arange(n), jnp.zeros(n, jnp.int32))
    time = jnp.zeros(n)
    return np.asarray(trace(scene, settings, o, d, time, keys))


def _repeat_rays(o, d, n):
    o = jnp.tile(jnp.asarray(o, jnp.float32)[None], (n, 1))
    d = jnp.asarray(d, jnp.float32)
    d = d / jnp.linalg.norm(d)
    return o, jnp.tile(d[None], (n, 1))


def test_miss_gives_background():
    scene = rt.compile_scene(rt.with_material(
        rt.lambertian(rt.constant_texture(0.5)), rt.sphere([0, 0, -100], 1)))
    s = rt.CameraSettings(background=rt.const_background([0.3, 0.6, 0.9]))
    o, d = _repeat_rays([0, 0, 0], [0, 1, 0], 4)
    out = _trace_rays(scene, s, o, d)
    np.testing.assert_allclose(out, [[0.3, 0.6, 0.9]] * 4, atol=1e-6)


def test_light_source_emits_texture():
    scene = rt.compile_scene(rt.with_material(
        rt.light_source(rt.constant_texture([2.0, 3.0, 4.0])),
        rt.sphere([0, 0, -5], 1)))
    s = rt.CameraSettings(background=rt.const_background(0.0))
    o, d = _repeat_rays([0, 0, 0], [0, 0, -1], 4)
    out = _trace_rays(scene, s, o, d)
    np.testing.assert_allclose(out, [[2.0, 3.0, 4.0]] * 4, atol=1e-5)


def test_pitch_black_absorbs():
    scene = rt.compile_scene(rt.with_material(
        rt.pitch_black(), rt.sphere([0, 0, -5], 1)))
    s = rt.CameraSettings(background=rt.const_background(1.0))
    o, d = _repeat_rays([0, 0, 0], [0, 0, -1], 4)
    out = _trace_rays(scene, s, o, d)
    np.testing.assert_allclose(out, 0.0, atol=1e-6)


def test_mirror_exact_reflection():
    # mirror floor reflects a downward ray into a light above
    world = rt.group([
        rt.with_material(rt.mirror(rt.constant_texture([0.5, 1.0, 0.25])),
                         rt.parallelogram([-10, 0, -10], [20, 0, 0], [0, 0, 20])),
        rt.with_material(rt.light_source(rt.constant_texture(2.0)),
                         rt.parallelogram([-10, 20, -10], [20, 0, 0], [0, 0, 20])),
    ])
    scene = rt.compile_scene(world)
    s = rt.CameraSettings(background=rt.const_background(0.0))
    o, d = _repeat_rays([0, 5, 0], [0, -1, 0], 4)
    out = _trace_rays(scene, s, o, d)
    np.testing.assert_allclose(out, [[1.0, 2.0, 0.5]] * 4, atol=1e-5)


def test_transparent_tints():
    world = rt.group([
        rt.with_material(rt.transparent(rt.constant_texture([0.5, 0.25, 1.0])),
                         rt.parallelogram([-5, -5, -1], [10, 0, 0], [0, 10, 0])),
        rt.with_material(rt.light_source(rt.constant_texture(1.0)),
                         rt.parallelogram([-5, -5, -3], [10, 0, 0], [0, 10, 0])),
    ])
    scene = rt.compile_scene(world)
    s = rt.CameraSettings(background=rt.const_background(0.0))
    o, d = _repeat_rays([0, 0, 0], [0, 0, -1], 4)
    out = _trace_rays(scene, s, o, d)
    np.testing.assert_allclose(out, [[0.5, 0.25, 1.0]] * 4, atol=1e-5)


def test_lambertian_furnace():
    """Furnace test: a lambertian sphere in a uniform unit environment must
    look exactly like the environment in expectation: sum_k a^k (1-a)...
    actually with cosine sampling and BRDF*pi = a, each bounce multiplies
    throughput by a and escapes with probability independent of a; total
    radiance = sum over escape events = a/(1-a)*... — simpler: for albedo a
    and unlimited depth, L = a * L + ... Here: L = a*(background) after
    geometric series: L = a * 1 * (since every scattered ray eventually
    escapes to the unit background or re-hits the sphere) -> for a convex
    sphere every scattered ray escapes, so L = a exactly."""
    a = 0.6
    scene = rt.compile_scene(rt.with_material(
        rt.lambertian(rt.constant_texture(a)), rt.sphere([0, 0, -5], 1)))
    s = rt.CameraSettings(background=rt.const_background(1.0), max_depth=50)
    n = 2048
    o, d = _repeat_rays([0, 0, 0], [0, 0, -1], n)
    out = _trace_rays(scene, s, o, d)
    # head-on hit scatters cosine-weighted off a convex surface: every
    # scattered ray escapes -> expected radiance = a
    np.testing.assert_allclose(out.mean(), a, atol=0.02)


def test_dielectric_conserves_energy():
    # glass sphere in unit furnace: reflection+refraction lossless -> 1
    scene = rt.compile_scene(rt.with_material(
        rt.dielectric(1.5), rt.sphere([0, 0, -5], 1)))
    s = rt.CameraSettings(background=rt.const_background(1.0), max_depth=50)
    n = 1024
    o, d = _repeat_rays([0, 0.5, 0], [0, 0, -1], n)
    out = _trace_rays(scene, s, o, d)
    np.testing.assert_allclose(out.mean(), 1.0, atol=0.02)


def test_metal_fuzz_zero_equals_mirror():
    world_metal = rt.group([
        rt.with_material(rt.metal(0.0, rt.constant_texture(0.8)),
                         rt.parallelogram([-10, 0, -10], [20, 0, 0], [0, 0, 20])),
        rt.with_material(rt.light_source(rt.constant_texture(1.0)),
                         rt.parallelogram([-10, 20, -10], [20, 0, 0], [0, 0, 20])),
    ])
    scene = rt.compile_scene(world_metal)
    s = rt.CameraSettings(background=rt.const_background(0.0))
    o, d = _repeat_rays([0, 5, 0], [0.3, -1, 0], 8)
    out = _trace_rays(scene, s, o, d)
    np.testing.assert_allclose(out, 0.8, atol=1e-5)


def test_mis_redirection_unbiased():
    """Cornell-style box: with and without redirection must agree in
    expectation (README.md:63-71 — same image, less noise)."""
    white = rt.lambertian(rt.constant_texture(0.73))
    light = rt.light_source(rt.constant_texture(15.0))
    world = rt.group([
        rt.with_material(white, rt.parallelogram([0, 0, 0], [555, 0, 0], [0, 0, 555])),
        rt.with_material(white, rt.parallelogram([555, 0, 0], [0, 555, 0], [0, 0, 555])),
        rt.with_material(white, rt.parallelogram([0, 0, 0], [0, 555, 0], [0, 0, 555])),
        rt.with_material(white, rt.parallelogram([0, 0, 555], [555, 0, 0], [0, 555, 0])),
        rt.with_material(white, rt.parallelogram([555, 555, 555], [-555, 0, 0], [0, 0, -555])),
        rt.with_material(light, rt.parallelogram([343, 554, 332], [-130, 0, 0], [0, 0, -105])),
    ])
    scene = rt.compile_scene(world)
    # depth high enough that truncation bias (which redirection *reduces*,
    # since guided paths find the light sooner) is negligible vs noise
    base = rt.CameraSettings(background=rt.const_background(0.0), max_depth=40)
    redir = base.with_redirect_targets(
        [(0.25, [343, 554, 332], [-130, 0, 0], [0, 0, -105])])
    n = 1 << 16  # the plain estimator is heavy-tailed; needs real statistics
    o, d = _repeat_rays([278, 278, -800], [0, 0, 1], n)
    plain = _trace_rays(scene, base, o, d, seed=1).mean()
    guided = _trace_rays(scene, redir, o, d, seed=2).mean()
    assert abs(plain - guided) / max(plain, 1e-9) < 0.08


def test_hemisphere_kill_on_negative_pdf():
    """Redirect target behind the surface: pdf <= 0 kills the path
    (Ray.hs:198) instead of contributing negatively."""
    world = rt.group([
        rt.with_material(rt.lambertian(rt.constant_texture(0.5)),
                         rt.parallelogram([-10, 0, -10], [20, 0, 0], [0, 0, 20])),
    ])
    scene = rt.compile_scene(world)
    s = rt.CameraSettings(background=rt.const_background(1.0), max_depth=4)
    # target below the floor: redirected rays have dir.normal < 0
    s = s.with_redirect_targets([(0.9, [-1, -5, -1], [2, 0, 0], [0, 0, 2])])
    o, d = _repeat_rays([0, 5, 0], [0, -1, 0], 8192)
    out = _trace_rays(scene, s, o, d)
    assert out.min() >= 0.0
    # 90% of paths are killed (redirected dir has pdf <= 0) but survivors
    # carry 1/remProb weight: estimator stays unbiased at albedo * bg = 0.5
    # (std of the mean for 5*Bernoulli(0.1) over 8192 rays is ~0.017)
    assert np.isclose(out.mean(), 0.5, atol=0.07)


def test_depth_zero_is_black():
    scene = rt.compile_scene(rt.with_material(
        rt.lambertian(rt.constant_texture(0.5)), rt.sphere([0, 0, -5], 1)))
    s = rt.CameraSettings(background=rt.const_background(1.0), max_depth=0)
    o, d = _repeat_rays([0, 0, 0], [0, 0, -1], 2)
    out = _trace_rays(scene, s, o, d)
    np.testing.assert_allclose(out, 0.0, atol=1e-6)


def test_russian_roulette_unbiased():
    """Opt-in Russian roulette (rr_depth) must agree in expectation with
    the exact reference estimator (it is NOT part of the reference;
    render/integrator.py:_russian_roulette)."""
    white = rt.lambertian(rt.constant_texture(0.73))
    light = rt.light_source(rt.constant_texture(15.0))
    world = rt.group([
        rt.with_material(white, rt.parallelogram([0, 0, 0], [555, 0, 0], [0, 0, 555])),
        rt.with_material(white, rt.parallelogram([555, 0, 0], [0, 555, 0], [0, 0, 555])),
        rt.with_material(white, rt.parallelogram([0, 0, 0], [0, 555, 0], [0, 0, 555])),
        rt.with_material(white, rt.parallelogram([0, 0, 555], [555, 0, 0], [0, 555, 0])),
        rt.with_material(white, rt.parallelogram([555, 555, 555], [-555, 0, 0], [0, 0, -555])),
        rt.with_material(light, rt.parallelogram([343, 554, 332], [-130, 0, 0], [0, 0, -105])),
    ])
    scene = rt.compile_scene(world)
    base = rt.CameraSettings(background=rt.const_background(0.0), max_depth=40
                             ).with_redirect_targets(
        [(0.25, [343, 554, 332], [-130, 0, 0], [0, 0, -105])])
    rr = base.replace(rr_depth=3, rr_min=0.05)
    n = 1 << 16
    o, d = _repeat_rays([278, 278, -800], [0, 0, 1], n)
    exact = _trace_rays(scene, base, o, d, seed=3).mean()
    routed = _trace_rays(scene, rr, o, d, seed=4).mean()
    assert abs(exact - routed) / max(exact, 1e-9) < 0.08
