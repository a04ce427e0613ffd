"""Worker process for the real multi-process jax.distributed test.

Launched N times (one per fake "host") by tests/test_multihost.py.  Each
process owns 2 virtual CPU devices, joins the distributed job via
``multihost.initialize`` (exercising the real coordinator handshake), and
renders the shared test scene through ``multihost.render`` — including
the ``process_allgather`` image assembly.  Process 0 writes the image.

Usage:
  python tools/multihost_worker.py --pid K --nproc N --port P --out F.npy
"""
import argparse
import os
import sys

# per-process virtual CPU devices, BEFORE jax import
os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "")
    + " --xla_force_host_platform_device_count=2"
)

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))


def build():
    import jax.numpy as jnp
    import raytrace_tpu as rt

    red = rt.lambertian(rt.constant_texture([0.65, 0.05, 0.05]))
    white = rt.lambertian(rt.constant_texture([0.73, 0.73, 0.73]))
    light = rt.light_source(rt.constant_texture([5.0, 5.0, 5.0]))
    world = rt.group([
        rt.with_material(white, rt.parallelogram([0, 0, 0], [4, 0, 0],
                                                 [0, 0, 4])),
        rt.with_material(red, rt.sphere([2, 1, 2], 1.0)),
        rt.with_material(light, rt.parallelogram([1, 3.5, 1], [2, 0, 0],
                                                 [0, 0, 2])),
    ])
    scene = rt.compile_scene(world)
    settings = rt.CameraSettings(
        center=jnp.asarray([2.0, 2.0, -4.0]),
        look_at=jnp.asarray([2.0, 1.0, 2.0]),
        vfov=0.9, aspect_ratio=1.0, image_width=24,
        samples_per_pixel=4, max_depth=4,
        background=rt.const_background(0.1))
    return scene, settings


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--pid", type=int, required=True)
    ap.add_argument("--nproc", type=int, required=True)
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    from raytrace_tpu.parallel import multihost

    multihost.initialize(coordinator_address=f"localhost:{args.port}",
                         num_processes=args.nproc, process_id=args.pid)
    assert jax.process_count() == args.nproc, jax.process_count()
    assert len(jax.devices()) == 2 * args.nproc  # global device view

    scene, settings = build()
    img = multihost.render(scene, settings, seed=3)
    if args.pid == 0 and args.out:
        np.save(args.out, img)
    print(f"proc {args.pid}: ok, img mean {float(img.mean()):.6f}",
          flush=True)
    jax.distributed.shutdown()


if __name__ == "__main__":
    main()
