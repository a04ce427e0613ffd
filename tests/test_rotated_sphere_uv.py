"""Rotated-instance sphere UVs.

The reference inverse-transforms the *ray* (Geometry.hs:382-391), so
``sphereUV`` (Geometry.hs:100-104) is evaluated in OBJECT space and a
rotated textured sphere shows a rotated texture (demo2's earth is
``transform (... !*! rotateY (pi/2)) (sphere ...)``, test/Main.hs:292).
The compiler bakes the rotation and records a static world->object
rotation per rotated sphere row (scene/compile.py); UV evaluation
un-rotates the outward normal (ops/intersect.py:apply_sphere_rotations).
"""
import numpy as np
import jax.numpy as jnp

import raytrace_tpu as rt
from raytrace_tpu.ops.intersect import (
    apply_sphere_rotations, make_hit_record, nearest_hit_t,
)

# the correction is compiled only for materials whose texture CONSUMES uv
# (constant-texture rotated spheres — demo2's 1000-sphere cloud — skip it)
M = rt.lambertian(rt.uv_texture(lambda uv: jnp.stack(
    [uv[..., 0], uv[..., 1], jnp.zeros_like(uv[..., 0])], axis=-1)))
CENTER = np.asarray([0.0, 0.0, -3.0])
ANGLE = np.pi / 2


def _rot_scene(angle=ANGLE, axis="y"):
    rot = {"x": rt.rotate_x, "y": rt.rotate_y, "z": rt.rotate_z}[axis](angle)
    world = rt.transform(
        rt.compose(rt.translate(CENTER), rot),
        rt.with_material(M, rt.sphere([0.0, 0.0, 0.0], 1.0)))
    return rt.compile_scene(world)


def _probe_uv(scene, d):
    """UV of the hit for a single ray from the origin along ``d``."""
    o = jnp.zeros((1, 3), jnp.float32)
    d = jnp.asarray(np.asarray(d, np.float32)[None])
    d = d / jnp.linalg.norm(d, axis=-1, keepdims=True)
    time = jnp.zeros((1,), jnp.float32)
    t, idx = nearest_hit_t(scene.prims, None, o, d, time,
                           jnp.full((1,), 1e-4), jnp.full((1,), jnp.inf))
    rec = make_hit_record(scene.prims, idx, o, d, time,
                          jnp.where(jnp.isfinite(t), t, 1.0))
    assert bool(rec.hit[0])
    return np.asarray(rec.uv[0])


def _expected_uv(outward_world, rot_w2o):
    n = rot_w2o @ np.asarray(outward_world, np.float64)
    u = np.arctan2(n[0], n[2]) / (2 * np.pi) + 0.5
    v = np.arccos(np.clip(-n[1], -1.0, 1.0)) / np.pi
    return np.asarray([u, v])


def test_compile_records_rotation():
    scene = _rot_scene()
    assert len(scene.prims.sphere_rots) == 1
    row, r9 = scene.prims.sphere_rots[0]
    assert int(scene.prims.kind[row]) == 0  # PRIM_SPHERE
    r = np.asarray(r9).reshape(3, 3)
    # world->object of rotate_y(pi/2) is rotate_y(-pi/2)
    exp = np.asarray(rt.rotate_y(-ANGLE))[:3, :3]
    np.testing.assert_allclose(r, exp, atol=1e-6)
    # unrotated spheres record nothing
    plain = rt.compile_scene(rt.with_material(
        M, rt.sphere(CENTER, 1.0)))
    assert plain.prims.sphere_rots == ()
    # rotated spheres with uv-blind (constant) textures record nothing
    # (demo2's 1000-sphere cloud must not compile a 1000-entry chain)
    const = rt.compile_scene(rt.transform(
        rt.compose(rt.translate(CENTER), rt.rotate_y(ANGLE)),
        rt.with_material(rt.lambertian(rt.constant_texture(0.5)),
                         rt.sphere([0.0, 0.0, 0.0], 1.0))))
    assert const.prims.sphere_rots == ()


def test_uv_rotates_with_instance():
    """A 90-deg y-rotation moves the hit's longitude by a quarter turn."""
    scene = _rot_scene()
    # ray straight down -z hits outward normal +z (world)
    uv = _probe_uv(scene, [0.0, 0.0, -1.0])
    rot_w2o = np.asarray(rt.rotate_y(-ANGLE))[:3, :3]
    np.testing.assert_allclose(uv, _expected_uv([0, 0, 1], rot_w2o),
                               atol=1e-5)
    # unrotated: u = 0.5 at the +z point; the rotated instance gives 0.25
    assert abs(uv[0] - 0.25) < 1e-5
    plain = rt.compile_scene(rt.with_material(M, rt.sphere(CENTER, 1.0)))
    uv_plain = _probe_uv(plain, [0.0, 0.0, -1.0])
    assert abs(uv_plain[0] - 0.5) < 1e-5
    # v unchanged by a y-rotation
    np.testing.assert_allclose(uv[1], uv_plain[1], atol=1e-5)


def test_uv_random_directions_all_axes():
    rng = np.random.default_rng(7)
    for axis in ("x", "y", "z"):
        angle = 0.7
        scene = _rot_scene(angle, axis)
        rot = {"x": rt.rotate_x, "y": rt.rotate_y,
               "z": rt.rotate_z}[axis](-angle)
        rot_w2o = np.asarray(rot)[:3, :3]
        for _ in range(5):
            d = CENTER + 0.6 * rng.normal(size=3)
            dn = d / np.linalg.norm(d)
            uv = _probe_uv(scene, d)
            # outward normal at the first hit: (p - c)/r with p = t*dn
            # solve |t*dn - c| = 1, take the near root
            b = -float(dn @ CENTER)
            disc = b * b - (float(CENTER @ CENTER) - 1.0)
            t = -b - np.sqrt(disc)
            outward = t * dn - CENTER
            np.testing.assert_allclose(
                uv, _expected_uv(outward, rot_w2o), atol=1e-4)


def test_diff_path_matches():
    from raytrace_tpu.ops.diff_intersect import make_diff_surface_hit
    scene = _rot_scene()
    p = scene.prims
    n = 64
    rng = np.random.default_rng(5)
    o = jnp.zeros((n, 3), jnp.float32)
    d = np.tile(CENTER, (n, 1)) + 0.5 * rng.normal(size=(n, 3))
    d = jnp.asarray(d / np.linalg.norm(d, axis=-1, keepdims=True),
                    jnp.float32)
    time = jnp.zeros((n,), jnp.float32)
    hit_fn = make_diff_surface_hit(False, 1e-4, has_box=p.has_box,
                                   sphere_rots=p.sphere_rots)
    t, idx, normal, front, uv, mat = hit_fn(
        (p.p0, p.e1, p.e2, p.uvs, p.mv0, p.mv1),
        (p.kind.astype(jnp.float32), p.mat.astype(jnp.float32)),
        o, d, time)
    t_ref, i_ref = nearest_hit_t(p, None, o, d, time,
                                 jnp.full((n,), 1e-4),
                                 jnp.full((n,), jnp.inf))
    rec = make_hit_record(p, i_ref, o, d, time,
                          jnp.where(jnp.isfinite(t_ref), t_ref, 1.0))
    hit = np.isfinite(np.asarray(t_ref))
    np.testing.assert_allclose(np.asarray(uv)[hit],
                               np.asarray(rec.uv)[hit], atol=1e-5)


def test_render_level_uv_texture():
    """Render-level check: a uv-readout emissive texture on a rotated
    sphere reports the object-space u at the probe point."""
    from raytrace_tpu.core import rng as rrng
    from raytrace_tpu.render.integrator import trace

    tex = rt.uv_texture(lambda uv: jnp.stack(
        [uv[..., 0], uv[..., 1], jnp.zeros_like(uv[..., 0])], axis=-1))
    light = rt.light_source(tex)

    def render_probe(world):
        scene = rt.compile_scene(world)
        s = rt.CameraSettings(
            center=jnp.zeros(3), look_at=jnp.asarray(CENTER, jnp.float32),
            vfov=0.02, image_width=1, aspect_ratio=1.0,
            samples_per_pixel=1, max_depth=2,
            background=rt.const_background(0.0))
        o = jnp.zeros((8, 3), jnp.float32)
        d = jnp.tile(jnp.asarray([[0.0, 0.0, -1.0]], jnp.float32), (8, 1))
        time = jnp.zeros((8,), jnp.float32)
        keys = rrng.ray_keys_fast(rrng.base_key(0),
                                  jnp.arange(8, dtype=jnp.int32),
                                  jnp.zeros(8, jnp.int32))
        return np.asarray(trace(scene, s, o, d, time, keys))[0]

    plain = render_probe(rt.with_material(light, rt.sphere(CENTER, 1.0)))
    rot = render_probe(rt.transform(
        rt.compose(rt.translate(CENTER), rt.rotate_y(ANGLE)),
        rt.with_material(light, rt.sphere([0, 0, 0], 1.0))))
    assert abs(plain[0] - 0.5) < 1e-4   # unrotated u at +z
    assert abs(rot[0] - 0.25) < 1e-4    # rotated by a quarter turn
    assert abs(plain[1] - rot[1]) < 1e-4
