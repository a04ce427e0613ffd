"""Mesh-scale scenes from a seeded generator, and an end-to-end render of
one of them.

``uv_sphere`` triangulates a closed lat-lon sphere; ``build_scene`` puts
it on a ground quad under an area light.  ``chip_smoke.py`` imports
both to drive the dense-table and BVH intersection paths at mesh scale.

Usage: python tools/bench_bigmesh.py [--lat 160] [--lon 160] [--width 512]
                                     [--spp 16] [--gpu] [--out img.png]
Prints one JSON line with the device, the triangle count and rays/s.
"""
import argparse
import json
import os
import sys
import time

import numpy as np


def uv_sphere(n_lat: int, n_lon: int):
    """Lat-lon sphere triangulation: 2 * n_lon * (n_lat - 1) triangles
    (the pole quads collapse into single triangles)."""
    th = np.linspace(0, np.pi, n_lat + 1)
    ph = np.linspace(0, 2 * np.pi, n_lon, endpoint=False)
    tt, pp = np.meshgrid(th, ph, indexing="ij")        # [n_lat+1, n_lon]
    v = np.stack([np.sin(tt) * np.cos(pp), np.cos(tt),
                  np.sin(tt) * np.sin(pp)], -1).reshape(-1, 3)
    vid = np.arange((n_lat + 1) * n_lon).reshape(n_lat + 1, n_lon)
    f = []
    for i in range(n_lat):
        a = vid[i]
        b = vid[i + 1]
        an = np.roll(a, -1)
        bn = np.roll(b, -1)
        if i > 0:
            f.append(np.stack([a, b, an], -1))
        if i < n_lat - 1:
            f.append(np.stack([an, b, bn], -1))
    return v, np.concatenate(f).astype(np.int64)


def build_scene(n_lat: int, n_lon: int, width: int = 512, spp: int = 16,
                depth: int = 8):
    """(scene, settings, n_triangles) for a uv-sphere mesh of
    ``2 * n_lon * (n_lat - 1)`` triangles."""
    import jax.numpy as jnp
    import raytrace_tpu as rt
    v, f = uv_sphere(n_lat, n_lon)
    mesh = rt.Mesh(vertices=v * 1.5, uv=np.zeros((0, 2)), faces=f,
                   uv_faces=np.full_like(f, -1))
    world = rt.group([
        rt.with_material(rt.lambertian(rt.constant_texture([0.7, 0.6, 0.5])),
                         rt.triangle_mesh(mesh)),
        rt.with_material(rt.lambertian(rt.constant_texture([0.5, 0.5, 0.5])),
                         rt.parallelogram([-50, -1.51, -50], [100, 0, 0],
                                          [0, 0, 100])),
        rt.with_material(rt.light_source(rt.constant_texture(8.0)),
                         rt.parallelogram([-3, 8, -3], [6, 0, 0],
                                          [0, 0, 6])),
    ])
    scene = rt.compile_scene(world)
    settings = rt.CameraSettings(
        center=jnp.asarray([0.0, 1.5, -7.0]),
        look_at=jnp.asarray([0.0, 0.0, 0.0]),
        vfov=0.7, aspect_ratio=1.0, image_width=width,
        samples_per_pixel=spp, max_depth=depth,
        background=rt.const_background(0.05))
    return scene, settings, f.shape[0]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--lat", type=int, default=160)   # 160x160 ~ 50.9k tris
    ap.add_argument("--lon", type=int, default=160)
    ap.add_argument("--spp", type=int, default=16)
    ap.add_argument("--width", type=int, default=512)
    ap.add_argument("--gpu", action="store_true",
                    help="run on the GPU (fails if there is none)")
    ap.add_argument("--out", default=None, help="write the image here")
    args = ap.parse_args()

    import jax
    if not args.gpu:
        jax.config.update("jax_platforms", "cpu")
    elif jax.devices()[0].platform != "gpu":
        ap.error(f"--gpu: no GPU found (devices: {jax.devices()})")
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from raytrace_tpu.render.render import render_accumulate
    from raytrace_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()

    scene, settings, n_tris = build_scene(args.lat, args.lon, args.width,
                                          args.spp)
    n_rows = scene.prims.kind.shape[0]
    print(f"tris={n_tris} rows={n_rows} bvh={scene.bvh is not None}",
          file=sys.stderr, flush=True)

    n_pix = settings.image_width * settings.image_height
    acc, _ = render_accumulate(scene, settings, seed=0, spp=args.spp)
    acc.block_until_ready()
    best = float("inf")
    for r in range(3):
        t0 = time.perf_counter()
        acc, _ = render_accumulate(scene, settings, seed=r + 1,
                                   spp=args.spp)
        acc.block_until_ready()
        best = min(best, time.perf_counter() - t0)
    if args.out:
        from raytrace_tpu.render.image import write_image
        write_image(args.out, np.asarray(acc / args.spp).reshape(
            settings.image_height, settings.image_width, 3))
    dev = jax.devices()[0]
    print(json.dumps({
        "metric": "bigmesh_primary_rays_per_sec",
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "tris": n_tris, "rows": n_rows,
        "wall_s": best,
        "value": n_pix * args.spp / best,
    }))


if __name__ == "__main__":
    main()
