"""Benchmark: Cornell-box 600 px / 200 spp / depth 50 primary rays/s on one
GPU — forward (exact estimator and Russian roulette) and forward+backward.

Prints ONE JSON line on stdout:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N, "device": ...}

Baseline (BASELINE.md): the reference renders Cornell 600px/200spp/depth50
with redirection in ~60 s on a laptop — ~1.2 M primary rays/s, CPU,
forward only.  ``vs_baseline`` is our fwd+bwd primary-rays/s over that
forward-only 1.2 M/s.

Fails (non-zero exit, no JSON line) when JAX finds no GPU.  Extra
diagnostics go to stderr.
"""
import json
import os
import subprocess
import sys
import time

import jax
import jax.numpy as jnp

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

BASELINE_RAYS_PER_S = 1.2e6

WIDTH = 600          # Cornell config (test/Main.hs:188-218)
SPP = 200
DEPTH = 50
BWD_BATCHES = 2
BWD_PIX = 1 << 18
BWD_SPP = 64
# full-width scan iterations, then the compacted completion tail
# (render/integrator.py:trace_wavefront_diff ``schedule``)
BWD_ITERS = 205
BWD_SCHEDULE = ((25, 1 << 14), (100, 1 << 12))
# stored residuals instead of remat: 19.1 GB of temporaries at this shape
# (compiled memory_analysis) and 0.58 s vs 0.80 s per step, measured on
# an H100 80GB HBM3 at a 400 W power limit
BWD_REMAT = False


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def card_name_and_power_limit() -> str:
    """``nvidia-smi`` name and power limit of the cards (a child process
    that does not use JAX)."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def main():
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"bench.py: no GPU found (devices: {jax.devices()})")
    from raytrace_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    from __graft_entry__ import _cornell_scene_and_settings
    from raytrace_tpu.core import rng
    from raytrace_tpu.diff.gradients import partition, render_loss_wavefront
    from raytrace_tpu.render.render import render_accumulate
    from raytrace_tpu.utils.engines import engine_report

    card = card_name_and_power_limit()
    log(f"device: {dev.platform} {dev.device_kind} x{len(jax.devices())}; "
        f"card: {card}")
    scene, settings = _cornell_scene_and_settings(
        width=WIDTH, spp=SPP, depth=DEPTH)
    n_pix = settings.image_width * settings.image_height

    # ---- forward: the production persistent-wavefront path ----
    def time_fwd(s):
        acc, _ = render_accumulate(scene, s, spp=SPP, spp_chunk=SPP)
        acc.block_until_ready()
        best = float("inf")
        for r in range(3):
            t0 = time.perf_counter()
            acc, _ = render_accumulate(scene, s, seed=r + 1, spp=SPP,
                                       spp_chunk=SPP)
            acc.block_until_ready()
            best = min(best, time.perf_counter() - t0)
        if not bool(jnp.all(jnp.isfinite(acc))):
            raise RuntimeError("non-finite forward accumulator")
        return n_pix * SPP / best

    fwd_rays_s_exact = time_fwd(settings)
    log(f"forward (exact estimator): {fwd_rays_s_exact/1e6:.2f}M rays/s")
    # Russian roulette from depth 2 (opt-in; unbiased — see
    # tests/test_integrator.py::test_russian_roulette_unbiased)
    settings_rr = settings.replace(rr_depth=2)
    fwd_rays_s = time_fwd(settings_rr)
    log(f"forward (RR from depth 2): {fwd_rays_s/1e6:.2f}M rays/s")

    # ---- forward+backward: differentiable regenerative wavefront ----
    params, statics = partition(scene)
    vg = jax.jit(jax.value_and_grad(render_loss_wavefront, has_aux=True),
                 static_argnames=("spp", "n_iters", "remat", "schedule"))
    key = rng.base_key(0)

    def run_bwd(i):
        start = (i * 131) % max(n_pix - BWD_PIX, 1)
        pix = jnp.arange(start, start + BWD_PIX, dtype=jnp.int32) % n_pix
        target = jnp.zeros((BWD_PIX, 3), jnp.float32)
        return vg(params, statics, settings_rr, key, pix, target,
                  spp=BWD_SPP, n_iters=BWD_ITERS, remat=BWD_REMAT,
                  schedule=BWD_SCHEDULE)

    (loss, frac), grads = run_bwd(0)
    jax.block_until_ready((loss, grads))
    best_dt = float("inf")
    for r in range(3):
        t0 = time.perf_counter()
        for i in range(BWD_BATCHES):
            (loss, frac), grads = run_bwd(r * BWD_BATCHES + i)
        jax.block_until_ready((loss, grads))
        best_dt = min(best_dt, time.perf_counter() - t0)
    if not bool(jnp.isfinite(loss)):
        raise RuntimeError("non-finite loss in fwd+bwd bench")
    bwd_rays_s = BWD_BATCHES * BWD_PIX * BWD_SPP / best_dt
    log(f"fwd+bwd: {bwd_rays_s/1e6:.2f}M rays/s loss={float(loss):.4f} "
        f"samples_completed={float(frac):.4f}")

    print(json.dumps({
        "metric": "cornell600_200spp_depth50_fwd_bwd_primary_rays_per_sec",
        "value": bwd_rays_s,
        "unit": "rays/s",
        "vs_baseline": bwd_rays_s / BASELINE_RAYS_PER_S,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "card": card,
        "forward_only_rays_per_sec": fwd_rays_s,
        "forward_only_exact_estimator_rays_per_sec": fwd_rays_s_exact,
        "samples_completed": float(frac),
        "russian_roulette": "depth>=2 (unbiased; exact-estimator numbers "
                            "also reported)",
        "engines": engine_report(scene, settings_rr, diff=True),
        "engines_fwd": engine_report(scene, settings_rr),
    }))


if __name__ == "__main__":
    main()
