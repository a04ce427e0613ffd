"""Shared CLI plumbing for the scene drivers (the reference's test/Main.hs
scene suite, re-expressed as runnable Python scripts)."""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def scene_main(name, build, default_width, default_spp, default_depth,
               writer="sqrt"):
    """Parse standard flags, render, write the image.

    ``build(args) -> (scene, settings)``.
    """
    p = argparse.ArgumentParser(description=f"render the '{name}' scene")
    p.add_argument("--width", type=int, default=default_width)
    p.add_argument("--spp", type=int, default=default_spp)
    p.add_argument("--depth", type=int, default=default_depth)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--out", default=f"{name}.png")
    p.add_argument("--gpu", action="store_true",
                   help="run on the GPU (fails if there is none) instead "
                        "of the CPU")
    p.add_argument("--lanes", type=int, default=1 << 17,
                   help="wavefront lane-pool size")
    args = p.parse_args()

    import jax
    if not args.gpu:
        jax.config.update("jax_platforms", "cpu")
    elif jax.devices()[0].platform != "gpu":
        p.error(f"--gpu: no GPU found (devices: {jax.devices()})")

    import raytrace_tpu as rt
    from raytrace_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()

    scene, settings, seed = build(args)
    if args.seed is not None:
        seed = args.seed
    t0 = time.time()
    img = rt.render(scene, settings, seed=seed, n_lanes=args.lanes,
                    progress=True)
    dt = time.time() - t0
    rays = settings.image_width * settings.image_height * settings.samples_per_pixel
    print(f"{name}: {dt:.1f}s, {rays/dt/1e6:.2f}M primary rays/s")
    if writer == "sqrt":
        rt.write_image_sqrt(args.out, img)
    else:
        rt.write_image(args.out, img)
    print(f"wrote {args.out}")
    return img
