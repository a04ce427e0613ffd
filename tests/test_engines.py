"""Engine-selection observability: the report must match the drivers'
actual choices per scene class (silent fallbacks must be visible and
assertable)."""
import numpy as np

import raytrace_tpu as rt
from raytrace_tpu.utils.engines import engine_report
from raytrace_tpu.utils.profiling import RenderStats


def _cornell_like():
    """Small dense scene: constant/checker textures, <= 16 behaviors."""
    world = rt.group([
        rt.with_material(rt.lambertian(rt.constant_texture([0.7, 0.2, 0.2])),
                         rt.sphere([0, 0, -3], 1.0)),
        rt.with_material(rt.light_source(rt.constant_texture(4.0)),
                         rt.parallelogram([-1, 2, -4], [2, 0, 0],
                                          [0, 0, 2])),
    ])
    return rt.compile_scene(world)


def _mesh_scene(n=300):
    """Triangle soup big enough for kind segmentation, < 8192 rows."""
    rs = np.random.RandomState(0)
    p0 = rs.uniform(-1, 1, (n, 3))
    tris = [rt.triangle(p, p + [0.1, 0, 0], p + [0, 0.1, 0]) for p in p0]
    world = rt.with_material(
        rt.lambertian(rt.constant_texture(0.5)), rt.group(tris))
    return rt.compile_scene(world, accel="dense")


def _fog_scene():
    world = rt.group([
        rt.with_material(rt.light_source(rt.constant_texture(4.0)),
                         rt.parallelogram([-2, -2, -4], [4, 0, 0],
                                          [0, 4, 0])),
        rt.with_material(rt.isotropic(rt.constant_texture(0.3)),
                         rt.constant_medium(0.8, rt.sphere([0, 0, -2], 1.0))),
    ])
    return rt.compile_scene(world)


_CAM = rt.CameraSettings(image_width=256, samples_per_pixel=4, max_depth=4,
                         background=rt.const_background(0.5))


def test_cornell_class_engines():
    scene = _cornell_like()
    rep = engine_report(scene, _CAM)
    assert rep == {"driver": "stationary", "intersect": "dense-scan",
                   "backward": None, "volumes": None}
    rep_d = engine_report(scene, _CAM, diff=True)
    assert rep_d["driver"] == "diff-wavefront"
    assert rep_d["backward"] == "winner-replay"


def test_mesh_class_engines(monkeypatch):
    scene = _mesh_scene()
    rep = engine_report(scene, _CAM)
    # 300 rows: below SORT_MIN_PRIMS -> stationary dense scan
    assert rep["driver"] == "stationary"
    assert rep["intersect"] == "dense-scan"
    # the report follows the driver threshold it mirrors
    from raytrace_tpu.render import render as render_mod
    monkeypatch.setattr(render_mod, "SORT_MIN_PRIMS", 8)
    assert engine_report(scene, _CAM)["driver"] == "sorted"


def test_bvh_class_engines():
    scene = rt.compile_scene(
        rt.with_material(rt.lambertian(rt.constant_texture(0.5)),
                         rt.group([rt.sphere([i, 0, -5], 0.4)
                                   for i in range(8)])), accel="bvh")
    rep = engine_report(scene, _CAM)
    assert rep["intersect"] == "bvh"
    assert rep["driver"] == "stationary"       # the sorted driver is dense
    # the diff path's custom-VJP hit always scans the table
    assert engine_report(scene, _CAM, diff=True)["intersect"] == "dense-scan"


def test_fog_class_engines():
    scene = _fog_scene()
    rep = engine_report(scene, _CAM)
    assert rep["volumes"] == "crossing-scan"
    rep_d = engine_report(scene, _CAM, diff=True)
    assert rep_d["volumes"] == "crossing-scan"
    assert rep_d["backward"] == "winner-replay"


def test_queue_driver_small_images():
    scene = _cornell_like()
    s = _CAM.replace(image_width=64)     # 4096 px < stationary minimum
    rep = engine_report(scene, s)
    assert rep["driver"] == "queue"


def test_engines_ride_render_stats():
    scene = _cornell_like()
    st = RenderStats()
    rep = st.record_engines(scene, _CAM)
    st.add_launch(dict(segments=10, iterations=1, lanes=128), 4, 0.1)
    rec = st.record()
    assert rec["engines"] == rep
    assert rec["engines"]["intersect"] == "dense-scan"
