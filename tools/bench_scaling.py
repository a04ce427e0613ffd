"""Scaling-efficiency harness.

Measures persistent-wavefront rays/s of the Cornell config at mesh sizes
1, 2, 4, ... over the available devices and reports parallel efficiency
(rays/s at N devices over N x rays/s at 1 device).

By default the harness runs on virtual CPU devices — that validates the
sharding path and the *work* distribution, not device throughput.
``--gpu`` runs on the machine's GPUs (fails if there are none).

Usage:
    python tools/bench_scaling.py [--devices 8] [--width 300] [--spp 16]
                                  [--gpu]
"""
import argparse
import json
import os
import sys
import time

p = argparse.ArgumentParser()
p.add_argument("--devices", type=int, default=8)
p.add_argument("--width", type=int, default=300)
p.add_argument("--spp", type=int, default=16)
p.add_argument("--gpu", action="store_true",
               help="use the GPUs instead of virtual CPU devices")
args = p.parse_args()

import jax

if not args.gpu:
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", args.devices)
elif jax.devices()[0].platform != "gpu":
    p.error(f"--gpu: no GPU found (devices: {jax.devices()})")

import numpy as np
from jax.sharding import Mesh

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from __graft_entry__ import _cornell_scene_and_settings
from raytrace_tpu.core import rng
from raytrace_tpu.parallel.sharding import sharded_wavefront_render_fn
from raytrace_tpu.utils.compile_cache import enable_compile_cache

enable_compile_cache()
if not args.gpu:
    print("NOTE: virtual CPU devices share the same physical cores — "
          "efficiency below validates the sharding path, not device "
          "scaling. Run with --gpu for device numbers.",
          file=sys.stderr, flush=True)

scene, settings = _cornell_scene_and_settings(width=args.width, spp=args.spp,
                                              depth=20)
settings = settings.replace(rr_depth=3)
n_pix = settings.image_width * settings.image_height
key = rng.base_key(0)

results = {}
n = 1
sizes = []
while n <= len(jax.devices()):
    sizes.append(n)
    n *= 2
for nd in sizes:
    mesh = Mesh(np.asarray(jax.devices()[:nd]).reshape(nd, 1), ("dp", "sp"))
    fn = sharded_wavefront_render_fn(mesh, n_pix, args.spp)
    acc = fn(scene, settings, key)
    acc.block_until_ready()
    best = float("inf")
    for r in range(3):
        k = rng.base_key(r + 1)
        t0 = time.perf_counter()
        acc = fn(scene, settings, k)
        acc.block_until_ready()
        best = min(best, time.perf_counter() - t0)
    dt = best
    rays_s = n_pix * args.spp / dt
    results[nd] = rays_s
    base = results[sizes[0]]
    eff = rays_s / (base * nd / sizes[0])
    print(f"devices={nd:3d}  rays/s={rays_s/1e6:8.2f}M  "
          f"efficiency={eff:.3f}", flush=True)

dev = jax.devices()[0]
print(json.dumps({
    "metric": "wavefront_scaling_efficiency",
    "device": {"platform": dev.platform, "kind": dev.device_kind,
               "count": len(jax.devices())},
    "sizes": sizes,
    "rays_per_sec": {str(k): round(v, 1) for k, v in results.items()},
    "efficiency_at_max": round(
        results[sizes[-1]] / (results[sizes[0]] * sizes[-1]), 3),
}))
