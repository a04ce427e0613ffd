"""Differentiable-rendering tests: autodiff vs finite differences
(BASELINE north-star: pixel gradients to material albedo, texture, and
geometry params via reparameterized/detached sampling)."""
import jax
import jax.numpy as jnp
import numpy as np

import raytrace_tpu as rt
from raytrace_tpu.core import rng
from raytrace_tpu.diff.gradients import (
    combine, grad_render, partition, render_tile,
)


def _simple_scene(albedo=(0.5, 0.5, 0.5), z=-3.0, radius=1.0):
    world = rt.group([
        rt.with_material(rt.lambertian(rt.constant_texture(albedo)),
                         rt.sphere([0, 0, z], radius)),
        rt.with_material(rt.light_source(rt.constant_texture(2.0)),
                         rt.parallelogram([-20, 10, -20], [40, 0, 0],
                                          [0, 0, 40])),
    ])
    return rt.compile_scene(world)


def _render_mean(scene, spp=64, n_pix=256, depth=4, seed=0):
    s = rt.CameraSettings(image_width=16, samples_per_pixel=spp,
                          max_depth=depth,
                          background=rt.const_background(0.5))
    key = rng.base_key(seed)
    pix = jnp.arange(n_pix, dtype=jnp.int32)
    samp = jnp.arange(spp, dtype=jnp.int32)
    img = render_tile(scene, s, key, pix, samp, differentiable=True)
    return jnp.mean(img)


def test_albedo_gradient_matches_fd():
    """d(mean image)/d(albedo): texture-table gradient vs central FD.
    Same RNG stream on both sides -> FD is noise-free."""
    def f(albedo_r):
        scene = _simple_scene()
        # perturb the compiled texture table directly (tex 0 = sphere)
        c0 = scene.textures.c0.at[0, 0].set(albedo_r)
        scene = scene.replace(textures=scene.textures.replace(c0=c0))
        return _render_mean(scene)

    g_auto = jax.grad(f)(jnp.float32(0.5))
    eps = 1e-2
    g_fd = (f(0.5 + eps) - f(0.5 - eps)) / (2 * eps)
    assert np.isfinite(float(g_auto))
    assert float(g_auto) > 0  # brighter albedo -> brighter image
    np.testing.assert_allclose(float(g_auto), float(g_fd), rtol=0.05)


def test_emission_gradient_matches_fd():
    def f(emit):
        scene = _simple_scene()
        c0 = scene.textures.c0.at[1].set(emit)
        scene = scene.replace(textures=scene.textures.replace(c0=c0))
        return _render_mean(scene)

    g_auto = jax.grad(f)(jnp.float32(2.0))
    eps = 1e-2
    g_fd = (f(2.0 + eps) - f(2.0 - eps)) / (2 * eps)
    np.testing.assert_allclose(float(g_auto), float(g_fd), rtol=0.05)


def test_geometry_gradient_finite_and_sane():
    """Gradient w.r.t. sphere center z: moving the sphere toward the
    camera changes shading/coverage; autodiff must be finite and in the
    same ballpark as (noisy) FD."""
    def f(z):
        scene = _simple_scene()
        p0 = scene.prims.p0.at[0, 2].set(z)
        scene = scene.replace(prims=scene.prims.replace(p0=p0))
        return _render_mean(scene, spp=32)

    g_auto = float(jax.grad(f)(jnp.float32(-3.0)))
    assert np.isfinite(g_auto)
    eps = 3e-2
    g_fd = float((f(-3.0 + eps) - f(-3.0 - eps)) / (2 * eps))
    # detached-sampling gradients omit the moving-silhouette term, so
    # compare loosely: same sign region / magnitude within 3x or both tiny
    if abs(g_fd) > 1e-3:
        assert np.sign(g_auto) == np.sign(g_fd) or abs(g_auto - g_fd) < 0.3 * abs(g_fd) + 1e-3


def test_box_hit_t_gradient_matches_fd():
    """d(hit t)/d(box hi_z) through the winner-only diff intersection:
    rays hitting the +z face of a PRIM_BOX have dt/dhi_z = 1/|d_z|
    exactly (slab plane t = (hi_z - o_z)/d_z); winner selection is
    piecewise-constant, so same-winner central FD is noise-free."""
    from raytrace_tpu.ops.diff_intersect import make_diff_surface_hit

    world = rt.with_material(rt.lambertian(rt.constant_texture(0.6)),
                             rt.cuboid([-2, -2, -4], [2, 2, -2]))
    scene = rt.compile_scene(world)
    assert scene.prims.has_box
    p = scene.prims
    hit_fn = make_diff_surface_hit(p.has_motion, 1e-3, has_box=p.has_box)
    rng_ = np.random.default_rng(3)
    r = 64
    o = jnp.asarray(np.concatenate(
        [rng_.uniform(-1.5, 1.5, (r, 2)), np.zeros((r, 1))], 1), jnp.float32)
    d = jnp.asarray(np.concatenate(
        [rng_.uniform(-0.2, 0.2, (r, 2)), -np.ones((r, 1))], 1), jnp.float32)
    d = d / jnp.linalg.norm(d, axis=-1, keepdims=True)
    time = jnp.zeros(r)
    ints_f = (p.kind.astype(jnp.float32), p.mat.astype(jnp.float32))

    def sum_t(hi_z):
        e1 = p.e1.at[0, 2].set(hi_z)
        t, idx, *_ = hit_fn((p.p0, e1, p.e2, p.uvs, p.mv0, p.mv1), ints_f,
                            o, d, time)
        return jnp.sum(jnp.where(jnp.isfinite(t), t, 0.0))

    g_auto = float(jax.grad(sum_t)(jnp.float32(-2.0)))
    eps = 1e-2
    g_fd = float((sum_t(-2.0 + eps) - sum_t(-2.0 - eps)) / (2 * eps))
    # every ray hits the front (+z) face: expected sum of 1/|d_z|
    expect = float(jnp.sum(1.0 / jnp.abs(d[:, 2])))
    np.testing.assert_allclose(g_auto, g_fd, rtol=1e-3)
    np.testing.assert_allclose(g_auto, -expect, rtol=1e-3)


def test_grad_render_full_scene_no_nans():
    scene = _simple_scene()
    s = rt.CameraSettings(image_width=16, samples_per_pixel=8, max_depth=4,
                          background=rt.const_background(0.5))
    key = rng.base_key(0)
    pix = jnp.arange(256, dtype=jnp.int32)
    samp = jnp.arange(8, dtype=jnp.int32)
    target = jnp.zeros((256, 3))
    loss, grads = grad_render(scene, s, key, pix, samp, target)
    assert np.isfinite(float(loss))
    for leaf in jax.tree_util.tree_leaves(grads):
        if hasattr(leaf, "dtype"):
            assert not bool(jnp.isnan(leaf).any())


def test_partition_combine_roundtrip():
    scene = _simple_scene()
    params, statics = partition(scene)
    back = combine(params, statics)
    for a, b in zip(jax.tree_util.tree_leaves(scene),
                    jax.tree_util.tree_leaves(back)):
        assert a is b or bool(jnp.all(a == b))


def test_camera_gradient():
    """Gradients also flow to camera parameters (center)."""
    scene = _simple_scene()

    def f(cx):
        s = rt.CameraSettings(
            center=jnp.asarray([cx, 0.0, 0.0]),
            image_width=16, samples_per_pixel=16, max_depth=3,
            background=rt.const_background(0.5))
        key = rng.base_key(0)
        pix = jnp.arange(256, dtype=jnp.int32)
        samp = jnp.arange(16, dtype=jnp.int32)
        img = render_tile(scene, s, key, pix, samp, differentiable=True)
        return jnp.mean(img)

    g = float(jax.grad(f)(jnp.float32(0.0)))
    assert np.isfinite(g)


def test_albedo_gradient_with_russian_roulette():
    """Gradient correctness with RR enabled (the bench's differentiable
    config): survival prob is detached, so AD still matches FD exactly
    (same RNG stream on both sides)."""
    def f(albedo_r):
        scene = _simple_scene()
        c0 = scene.textures.c0.at[0, 0].set(albedo_r)
        scene = scene.replace(textures=scene.textures.replace(c0=c0))
        s = rt.CameraSettings(image_width=16, samples_per_pixel=32,
                              max_depth=8, rr_depth=2, rr_min=0.05,
                              background=rt.const_background(0.5))
        key = rng.base_key(0)
        pix = jnp.arange(256, dtype=jnp.int32)
        samp = jnp.arange(32, dtype=jnp.int32)
        img = render_tile(scene, s, key, pix, samp, differentiable=True)
        return jnp.mean(img)

    g_auto = jax.grad(f)(jnp.float32(0.5))
    eps = 1e-2
    g_fd = (f(0.5 + eps) - f(0.5 - eps)) / (2 * eps)
    assert np.isfinite(float(g_auto))
    np.testing.assert_allclose(float(g_auto), float(g_fd), rtol=0.05)


def test_wavefront_diff_loss_with_rr_matches_scan():
    """render_loss_wavefront (regenerative diff wavefront) with RR agrees
    with the bounded-scan estimator in expectation (same physical scene,
    independent streams)."""
    from raytrace_tpu.diff.gradients import (
        partition, render_loss, render_loss_wavefront,
    )
    scene = _simple_scene()
    s = rt.CameraSettings(image_width=16, samples_per_pixel=32, max_depth=8,
                          rr_depth=3, background=rt.const_background(0.5))
    params, statics = partition(scene)
    key = rng.base_key(0)
    pix = jnp.arange(256, dtype=jnp.int32)
    target = jnp.zeros((256, 3), jnp.float32)
    samp = jnp.arange(32, dtype=jnp.int32)
    l_scan = render_loss(params, statics, s, key, pix, samp, target)
    l_wave, frac = render_loss_wavefront(params, statics, s, rng.base_key(1),
                                         pix, target, spp=32, n_iters=200)
    assert float(frac) > 0.98
    np.testing.assert_allclose(float(l_scan), float(l_wave), rtol=0.08)


def test_wavefront_diff_rotation_matches_unrotated():
    """Pixel rotation in the diff wavefront (rolled pixel maps + rolled
    flushes) reproduces the unrotated loss AND gradients exactly when
    every lane completes (absolute (pixel, sample) RNG keys)."""
    from raytrace_tpu.diff.gradients import partition, render_loss_wavefront
    scene = _simple_scene()
    s = rt.CameraSettings(image_width=16, samples_per_pixel=16, max_depth=6,
                          background=rt.const_background(0.5))
    params, statics = partition(scene)
    key = rng.base_key(3)
    pix = jnp.arange(256, dtype=jnp.int32)
    target = jnp.full((256, 3), 0.25, jnp.float32)
    vg = jax.value_and_grad(render_loss_wavefront, has_aux=True)
    (l0, f0), g0 = vg(params, statics, s, key, pix, target, spp=16,
                      n_iters=140)
    (l1, f1), g1 = vg(params, statics, s, key, pix, target, spp=16,
                      n_iters=140, rotate_k=4)
    assert float(f0) == 1.0 and float(f1) == 1.0
    np.testing.assert_allclose(float(l0), float(l1), rtol=1e-5)
    for a, b in zip(jax.tree_util.tree_leaves(g0),
                    jax.tree_util.tree_leaves(g1)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=2e-4, atol=1e-6)


def test_wavefront_diff_skip_done_matches_and_completes():
    """The lax.cond skip-when-done wrapper must be a pure no-op
    semantically: identical loss AND gradients to skip_done=False at the
    same n_iters, and a generous n_iters bound must complete every
    sample (this is how bench.py guarantees samples_completed == 1.0
    without paying worst-case iterations)."""
    from raytrace_tpu.diff.gradients import partition, render_loss_wavefront
    scene = _simple_scene()
    s = rt.CameraSettings(image_width=16, samples_per_pixel=16, max_depth=6,
                          rr_depth=3, background=rt.const_background(0.5))
    params, statics = partition(scene)
    key = rng.base_key(5)
    pix = jnp.arange(256, dtype=jnp.int32)
    target = jnp.full((256, 3), 0.25, jnp.float32)
    vg = jax.value_and_grad(render_loss_wavefront, has_aux=True)
    (l0, f0), g0 = vg(params, statics, s, key, pix, target, spp=16,
                      n_iters=60, skip_done=False)
    (l1, f1), g1 = vg(params, statics, s, key, pix, target, spp=16,
                      n_iters=60, skip_done=True)
    assert float(f0) == float(f1)
    np.testing.assert_allclose(float(l0), float(l1), rtol=1e-6)
    for a, b in zip(jax.tree_util.tree_leaves(g0),
                    jax.tree_util.tree_leaves(g1)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-6, atol=1e-8)
    # generous bound (spp * max_depth is the hard worst case) completes
    # everything; cond-skip skips the unused tail
    (l2, f2), g2 = vg(params, statics, s, key, pix, target, spp=16,
                      n_iters=16 * 6 + 2, skip_done=True)
    assert float(f2) == 1.0
    # and at an n_iters where samples do NOT all complete and which is
    # not a multiple of skip_chunk, skip_done must run EXACTLY n_iters
    # (final short chunk), not round up — loss/grads must still match
    (l3, f3), g3 = vg(params, statics, s, key, pix, target, spp=16,
                      n_iters=21, skip_done=False)
    (l4, f4), g4 = vg(params, statics, s, key, pix, target, spp=16,
                      n_iters=21, skip_done=True)
    assert float(f3) < 1.0, "case must exercise the incomplete path"
    assert float(f3) == float(f4)
    np.testing.assert_allclose(float(l3), float(l4), rtol=1e-6)
    for a, b in zip(jax.tree_util.tree_leaves(g3),
                    jax.tree_util.tree_leaves(g4)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-6, atol=1e-8)


def test_wavefront_diff_two_phase_schedule_matches_single():
    """The two-phase completion schedule (compact unfinished lanes into a
    narrower phase after the full-width iterations) must reproduce the
    single-phase loss AND gradients when every sample completes: the
    compacted lanes carry their absolute (pixel, sample) RNG coordinates,
    so the estimator is the identical sample sum, re-associated only at
    the final scatter-add."""
    from raytrace_tpu.diff.gradients import partition, render_loss_wavefront
    scene = _simple_scene()
    s = rt.CameraSettings(image_width=16, samples_per_pixel=16, max_depth=6,
                          rr_depth=3, background=rt.const_background(0.5))
    params, statics = partition(scene)
    key = rng.base_key(7)
    pix = jnp.arange(256, dtype=jnp.int32)
    target = jnp.full((256, 3), 0.25, jnp.float32)
    vg = jax.value_and_grad(render_loss_wavefront, has_aux=True)
    (l0, f0), g0 = vg(params, statics, s, key, pix, target, spp=16,
                      n_iters=160)
    # phase A 60 iters full width, then 128 lanes, then a 64-lane tail —
    # total iteration opportunity >= the single-phase 160
    (l1, f1), g1 = vg(params, statics, s, key, pix, target, spp=16,
                      n_iters=60, schedule=((60, 128), (60, 64)))
    assert float(f0) == 1.0, "single-phase must complete for the comparison"
    assert float(f1) == 1.0, "two-phase dropped samples (width too small?)"
    np.testing.assert_allclose(float(l0), float(l1), rtol=1e-5)
    for a, b in zip(jax.tree_util.tree_leaves(g0),
                    jax.tree_util.tree_leaves(g1)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=2e-4, atol=1e-6)
    # incomplete-schedule path: overflow lanes drop samples, frac < 1,
    # and the result is still finite/valid
    (l2, f2), g2 = vg(params, statics, s, key, pix, target, spp=16,
                      n_iters=10, schedule=((4, 128),))
    assert float(f2) < 1.0
    assert np.isfinite(float(l2))
    for a in jax.tree_util.tree_leaves(g2):
        assert np.all(np.isfinite(np.asarray(a)))


def test_wavefront_diff_balanced_matches_unbalanced():
    """Cost-balanced antithetic pixel assignment (per-chunk permutation
    maps from a forward cost prepass) must reproduce the unrotated loss
    AND gradients exactly when every lane completes: RNG keys are
    absolute (pixel, sample), and each chunk map is a permutation, so
    the estimator is the same sum re-ordered."""
    from raytrace_tpu.diff.gradients import partition, render_loss_wavefront
    from raytrace_tpu.render.integrator import (
        _antithetic_maps, lane_cost_estimate,
    )
    scene = _simple_scene()
    s = rt.CameraSettings(image_width=16, samples_per_pixel=16, max_depth=6,
                          background=rt.const_background(0.5))
    params, statics = partition(scene)
    key = rng.base_key(3)
    pix = jnp.arange(256, dtype=jnp.int32)
    cost = lane_cost_estimate(scene, s, key, pix, spp_est=2)
    assert cost.shape == (256,) and float(cost.min()) >= 2.0
    # each antithetic map must be a permutation of all lane slots
    for m in _antithetic_maps(cost, 4):
        assert np.array_equal(np.sort(np.asarray(m)), np.arange(256))
    target = jnp.full((256, 3), 0.25, jnp.float32)
    vg = jax.value_and_grad(render_loss_wavefront, has_aux=True)
    (l0, f0), g0 = vg(params, statics, s, key, pix, target, spp=16,
                      n_iters=140)
    (l1, f1), g1 = vg(params, statics, s, key, pix, target, spp=16,
                      n_iters=140, rotate_k=4, pixel_cost=cost)
    assert float(f0) == 1.0 and float(f1) == 1.0
    np.testing.assert_allclose(float(l0), float(l1), rtol=1e-5)
    for a, b in zip(jax.tree_util.tree_leaves(g0),
                    jax.tree_util.tree_leaves(g1)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=2e-4, atol=1e-6)


# ---------------------------------------------------------------------------
# Volume (constant-medium) gradients — Geometry.hs:298-330's density is a
# first-class scene parameter; VERDICT r4 weak #6.
# ---------------------------------------------------------------------------

def _fog_scene(density=0.8):
    """Light quad viewed through a fog sphere: transmittance depends
    strongly on density, so d(mean radiance)/d(density) is large."""
    world = rt.group([
        rt.with_material(rt.light_source(rt.constant_texture(4.0)),
                         rt.parallelogram([-2, -2, -4], [4, 0, 0],
                                          [0, 4, 0])),
        rt.with_material(rt.isotropic(rt.constant_texture(0.3)),
                         rt.constant_medium(density,
                                            rt.sphere([0, 0, -2], 1.0))),
    ])
    return rt.compile_scene(world)


_FOG_CAM = rt.CameraSettings(
    image_width=16, samples_per_pixel=8, max_depth=12,
    center=np.asarray([0.0, 0.0, 1.0]), look_at=np.asarray([0.0, 0.0, -2.0]),
    vfov=1.0, background=rt.const_background(0.0))


def _fog_mean(scene, seed, spp=8):
    pix = jnp.arange(256, dtype=jnp.int32)
    img = render_tile(scene, _FOG_CAM, rng.base_key(seed), pix,
                      jnp.arange(spp, dtype=jnp.int32), differentiable=True)
    return jnp.mean(img)


def test_volume_density_gradient_matches_fd():
    """d(mean radiance)/d(density) via the score-function weight
    (integrator.bounce diff path) vs FD of the *expected* loss.

    The scatter position is sampled, so the estimator is statistical:
    AD averages the score-function gradient over seeds, FD uses
    independent seeds at density +- eps.  Generous tolerance."""
    scene = _fog_scene()
    params, statics = partition(scene)

    def f(dens, seed):
        p2 = params.replace(volumes=params.volumes.replace(density=dens))
        return _fog_mean(combine(p2, statics), seed)

    d0 = jnp.asarray([0.8], jnp.float32)
    gf = jax.jit(jax.value_and_grad(f))
    gs = [float(gf(d0, s)[1][0]) for s in range(4)]
    g_ad = float(np.mean(gs))
    fj = jax.jit(f)
    eps = 0.15
    hi = np.mean([float(fj(d0 + eps, s)) for s in range(4, 10)])
    lo = np.mean([float(fj(d0 - eps, s)) for s in range(4, 10)])
    g_fd = (hi - lo) / (2 * eps)
    # denser fog blocks more of the light: both must be clearly negative
    assert g_ad < -0.05 and g_fd < -0.05, (g_ad, g_fd)
    np.testing.assert_allclose(g_ad, g_fd, rtol=0.35)


def test_volume_density_gradient_value_unchanged():
    """The score weight is exactly 1.0 in value: the rendered radiance
    must be bit-identical to a run with density detached."""
    scene = _fog_scene()
    params, statics = partition(scene)

    def f(dens):
        p2 = params.replace(volumes=params.volumes.replace(density=dens))
        return _fog_mean(combine(p2, statics), 0)

    v0 = float(f(jnp.asarray([0.8])))
    v1 = float(f(jax.lax.stop_gradient(jnp.asarray([0.8]))))
    assert v0 == v1


def test_volume_albedo_gradient_matches_fd():
    """Medium albedo gradient: same-seed FD is noise-free (albedo does
    not perturb the sampling chain)."""
    scene = _fog_scene()

    def f(a):
        c0 = scene.textures.c0
        # texture row of the isotropic medium material
        row = int(np.asarray(scene.materials.tex)[
            int(np.asarray(scene.volumes.mat)[0])])
        c0 = c0.at[row].set(a)
        s2 = scene.replace(textures=scene.textures.replace(c0=c0))
        return _fog_mean(s2, 0)

    g_auto = float(jax.grad(f)(jnp.float32(0.3)))
    eps = 1e-2
    g_fd = (float(f(0.3 + eps)) - float(f(0.3 - eps))) / (2 * eps)
    assert np.isfinite(g_auto) and g_auto > 0.0
    np.testing.assert_allclose(g_auto, g_fd, rtol=0.05)


def test_volume_boundary_geometry_gradient_finite():
    """Gradients w.r.t. the medium's boundary geometry (reparameterized
    through the crossing scan) are finite; full-scene grad has no NaNs."""
    scene = _fog_scene()
    params, statics = partition(scene)

    def f(params):
        return _fog_mean(combine(params, statics), 0)

    g = jax.grad(f)(params)
    for leaf in jax.tree_util.tree_leaves(g):
        assert np.all(np.isfinite(np.asarray(leaf)))
    # the boundary sphere's rows live in scene.volumes.prims
    gb = np.asarray(g.volumes.prims.p0)
    assert np.all(np.isfinite(gb))
