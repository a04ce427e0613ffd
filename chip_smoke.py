"""Smoke test of the path tracer on the GPU.

Drives the main path once through the entry points a user calls, at the
reference's configurations, and checks what comes out:

1. device — platform, device kind and count, JAX version, ``XLA_FLAGS``,
   the compile-cache directory, and the card's name and power limit
   (``nvidia-smi``, a child process that does not use JAX);
2. numerics — the card against this repo's own XLA path on the CPU
   device of the same process, same seed: the Cornell forward image and
   the differentiable loss and gradients at 64 px / 16 spp, plus the
   one-hot gather (bit-exact) and the intersection contraction (f32
   rounding, not TF32) at Cornell scale;
3. forward — ``render_accumulate`` on Cornell, demo2 and two generated
   meshes (one on the dense table, one above the dense cap on the BVH);
4. train — three ``optax.adam`` steps of the sharded training step at
   the benchmark's fwd+bwd shape.

``--four-cards`` runs only the sharded paths (``parallel/sharding.py``)
on a four-card mesh, each against the same call on one card.

Usage:
    python chip_smoke.py                 # one GPU, phases 1-4
    python chip_smoke.py --four-cards    # four GPUs, sharded paths only

When JAX finds no GPU, or any phase fails, the script exits non-zero and
prints no result line.  Otherwise the last line of stdout is
    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}
"""
import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

# ---- phase 2 tolerances ---------------------------------------------------
# The card and the CPU run the same program on the same RNG stream, but
# XLA orders sums differently on each and uses other approximations of
# the transcendentals.  So a path decision that sits within rounding of
# its threshold can flip — at Cornell's wall seams and box edges two
# walls tie for the nearest hit — and the rest of that sample's path is
# then a different (equally valid) draw, moving its pixel by up to
# (light radiance) / spp.  At depth 50 and 16 spp a few percent of the
# pixels hold such a sample.  So: the typical pixel agrees to rounding,
# most pixels agree closely, and the image mean agrees to well within
# its Monte-Carlo noise.
PIXEL_TOL = 1e-3        # |card - cpu| per pixel, relative to the image mean
MIN_CLOSE_SHARE = 0.9   # share of pixels that must be within PIXEL_TOL
MEDIAN_TOL = 1e-4       # median pixel difference, relative to the mean
MEAN_RTOL = 5e-3        # image mean
LOSS_RTOL = 1e-3
# Gradients are sums over all lanes, taken by scatter-adds whose order
# is not fixed on the card, on top of the rare flipped paths above.
GRAD_RTOL = 1e-2        # relative L2 error over all gradient leaves
# An f32 sum of three products is within 4 ulp-units of the f64 result
# (3 roundings of the sum, 1 of each product).  TF32 (10 mantissa bits)
# would miss this bound by ~500x.
BDOT_ULPS = 4.0

# ---- phase 3: the reference's configurations ------------------------------
# name -> (image width, spp, max depth); all run at full size (~1 minute
# of rendering on one H100 in all)
FORWARD_CONFIGS = {
    "cornell": (600, 200, 50),
    "demo2": (400, 250, 4),
    "mesh5k": (600, 100, 10),
    "mesh100k": (600, 100, 10),
}
# uv-sphere (n_lat, n_lon): 2 * n_lon * (n_lat - 1) triangles
MESH_LATLON = {"mesh5k": (51, 50), "mesh100k": (224, 224)}

# ---- phase 4: bench.py's fwd+bwd shape -----------------------------------
TRAIN_LANES = 1 << 18
TRAIN_SPP = 64
TRAIN_ITERS = 205
TRAIN_SCHEDULE = ((25, 1 << 14), (100, 1 << 12))
TRAIN_STEPS = 3
# Store each wavefront iteration's residuals instead of recomputing the
# forward in the backward: compiled memory_analysis on an H100 80GB HBM3
# gives 19.1 GB of temporaries without remat (3.2 GB with it), which
# fits the card's 60 GB JAX share, and a step takes 0.58 s instead of
# 0.80 s (400 W power limit).
TRAIN_REMAT = False

# ---- --four-cards ---------------------------------------------------------
FOUR_CARDS = 4
FOUR_CARD_RENDER_SPP = 16


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# helpers (kept free of device work so the tests can run them on the CPU)
# ---------------------------------------------------------------------------

def parse_card_lines(text: str) -> list:
    """``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
    output -> ``[(name, power_limit), ...]``, one entry per card."""
    cards = []
    for line in text.strip().splitlines():
        fields = [f.strip() for f in line.rsplit(",", 1)]
        if len(fields) != 2 or not fields[0] or not fields[1]:
            raise ValueError(f"unexpected nvidia-smi line: {line!r}")
        cards.append((fields[0], fields[1]))
    if not cards:
        raise ValueError("nvidia-smi printed no card")
    return cards


def card_lines() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout


def result_line(devices) -> str:
    d = devices[0]
    return json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(devices)}})


def phases_to_run(four_cards: bool) -> tuple:
    return ("four_cards",) if four_cards else (
        "device", "numerics", "forward", "train")


def image_agreement(a, b) -> dict:
    """Per-pixel and mean agreement of two radiance images (PIXEL_TOL,
    MIN_CLOSE_SHARE, MEDIAN_TOL, MEAN_RTOL)."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    scale = max(float(np.abs(b).mean()), 1e-12)
    per_pixel = np.abs(a - b).reshape(-1, a.shape[-1]).max(axis=-1) / scale
    close = float(np.mean(per_pixel <= PIXEL_TOL))
    median = float(np.median(per_pixel))
    mean_rel = abs(float(a.mean()) - float(b.mean())) / scale
    return {"close_share": close, "median_rel": median, "mean_rel": mean_rel,
            "worst_pixel_rel": float(per_pixel.max()),
            "ok": (close >= MIN_CLOSE_SHARE and median <= MEDIAN_TOL
                   and mean_rel <= MEAN_RTOL)}


def rel_l2(a_leaves, b_leaves) -> float:
    a = np.concatenate([np.ravel(np.asarray(x, np.float64))
                        for x in a_leaves])
    b = np.concatenate([np.ravel(np.asarray(x, np.float64))
                        for x in b_leaves])
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(f"FAILED: {what}")


# ---------------------------------------------------------------------------
# scenes
# ---------------------------------------------------------------------------

def cornell(width, spp, depth):
    from __graft_entry__ import _cornell_scene_and_settings
    return _cornell_scene_and_settings(width=width, spp=spp, depth=depth)


def build_forward_scene(name: str, width: int, spp: int, depth: int):
    if name == "cornell":
        return cornell(width, spp, depth)
    if name == "demo2":
        sys.path.insert(0, os.path.join(REPO, "scenes"))
        import demo2
        scene, settings, _seed = demo2.build(argparse.Namespace(
            width=width, spp=spp, depth=depth))
        return scene, settings
    sys.path.insert(0, os.path.join(REPO, "tools"))
    import bench_bigmesh
    scene, settings, _ = bench_bigmesh.build_scene(
        *MESH_LATLON[name], width=width, spp=spp, depth=depth)
    return scene, settings


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_device(cache_dir: str) -> None:
    import jax
    devs = jax.devices()
    d = devs[0]
    log(f"[device] platform={d.platform} kind={d.device_kind} "
        f"count={len(devs)} jax={jax.__version__}")
    log(f"[device] XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r} "
        f"compile_cache={cache_dir}")


def phase_numerics() -> None:
    import jax
    import jax.numpy as jnp
    from raytrace_tpu.core import rng
    from raytrace_tpu.core.vecmath import gather_rows, onehot_rows
    from raytrace_tpu.diff.gradients import partition, render_loss_wavefront
    from raytrace_tpu.ops.intersect import _bdot
    from raytrace_tpu.render.render import render_accumulate

    gpu = jax.devices()[0]
    cpu = jax.devices("cpu")[0]
    width, spp, depth = 64, 16, 50

    def run(device):
        with jax.default_device(device):
            scene, settings = cornell(width, spp, depth)
            acc, _ = render_accumulate(scene, settings, seed=0, spp=spp)
            img = np.asarray(acc) / spp
            params, statics = partition(scene)
            n_pix = width * width
            target = jnp.full((n_pix, 3), 0.25, jnp.float32)
            vg = jax.jit(jax.value_and_grad(render_loss_wavefront,
                                            has_aux=True),
                         static_argnames=("spp",))
            (loss, frac), grads = vg(
                params, statics, settings, rng.base_key(0),
                jnp.arange(n_pix, dtype=jnp.int32), target, spp=spp)
            leaves = [np.asarray(g) for g in jax.tree_util.tree_leaves(grads)]
            return img, float(loss), float(frac), leaves

    t0 = time.perf_counter()
    img_g, loss_g, frac_g, grads_g = run(gpu)
    t_gpu = time.perf_counter() - t0
    t0 = time.perf_counter()
    img_c, loss_c, frac_c, grads_c = run(cpu)
    t_cpu = time.perf_counter() - t0
    agree = image_agreement(img_g, img_c)
    log(f"[numerics] cornell {width}px {spp}spp forward: "
        f"close_share={agree['close_share']:.6f} (>= {MIN_CLOSE_SHARE}) "
        f"median_rel={agree['median_rel']:.3e} (<= {MEDIAN_TOL}) "
        f"mean_rel={agree['mean_rel']:.3e} (<= {MEAN_RTOL}) "
        f"worst_pixel_rel={agree['worst_pixel_rel']:.3e} "
        f"mean_radiance={img_g.mean():.6f} "
        f"(card {t_gpu:.1f}s, cpu {t_cpu:.1f}s incl. compile)")
    check(agree["ok"], "forward image vs CPU reference")
    loss_rel = abs(loss_g - loss_c) / max(abs(loss_c), 1e-30)
    grad_rel = rel_l2(grads_g, grads_c)
    log(f"[numerics] diff loss card={loss_g:.8f} cpu={loss_c:.8f} "
        f"rel={loss_rel:.3e} (<= {LOSS_RTOL}); grads rel_l2={grad_rel:.3e} "
        f"(<= {GRAD_RTOL}); samples_completed card={frac_g} cpu={frac_c}")
    check(loss_rel <= LOSS_RTOL, "diff loss vs CPU reference")
    check(grad_rel <= GRAD_RTOL, "gradients vs CPU reference")
    check(frac_g == 1.0 and frac_c == 1.0, "samples_completed == 1.0")
    check(all(np.all(np.isfinite(g)) for g in grads_g), "finite gradients")

    # full-mantissa f32 values at Cornell scale (~555)
    r = np.random.default_rng(7)
    table = r.uniform(0.0, 555.0, (64, 9)).astype(np.float32)
    idx = r.integers(0, 64, 4096).astype(np.int32)
    got = np.asarray(jax.jit(lambda t, i: gather_rows(onehot_rows(i, 64), t))(
        jax.device_put(table, gpu), jax.device_put(idx, gpu)))
    exact = bool(np.array_equal(got, table[idx]))
    log(f"[numerics] gather_rows bit-exact: {exact}")
    check(exact, "gather_rows bit-exact")
    x = r.uniform(-555.0, 555.0, (4096, 3)).astype(np.float32)
    y = r.uniform(-555.0, 555.0, (24, 3)).astype(np.float32)
    got = np.asarray(jax.jit(_bdot)(jax.device_put(x, gpu),
                                    jax.device_put(y, gpu)), np.float64)
    x64, y64 = x.astype(np.float64), y.astype(np.float64)
    ref = x64 @ y64.T
    bound = BDOT_ULPS * 2.0 ** -24 * (np.abs(x64) @ np.abs(y64).T)
    worst = float(np.max(np.abs(got - ref) / bound))
    log(f"[numerics] _bdot worst error / ({BDOT_ULPS} ulp bound) = "
        f"{worst:.3f} (<= 1)")
    check(worst <= 1.0, "_bdot within f32 rounding")


def phase_forward() -> None:
    import jax
    import jax.numpy as jnp
    from raytrace_tpu.render.render import render_accumulate
    from raytrace_tpu.utils.engines import engine_report

    for name, (width, spp, depth) in FORWARD_CONFIGS.items():
        scene, settings = build_forward_scene(name, width, spp, depth)
        n_pix = settings.image_width * settings.image_height
        def render(sc, st, seed, spp=spp):
            return render_accumulate(sc, st, seed, spp=spp)[0]

        t0 = time.perf_counter()
        compiled = jax.jit(render).lower(scene, settings, 0).compile()
        t_compile = time.perf_counter() - t0
        t0 = time.perf_counter()
        acc = compiled(scene, settings, 0)
        acc.block_until_ready()
        wall = time.perf_counter() - t0
        finite = bool(jnp.all(jnp.isfinite(acc)))
        mean = float(jnp.mean(acc)) / spp
        log(f"[forward] {name}: {width}px spp={spp} depth={depth} "
            f"rows={scene.prims.kind.shape[0]} "
            f"engines={engine_report(scene, settings)} "
            f"compile_s={t_compile:.2f} wall_s={wall:.3f} "
            f"primary_rays_per_s={n_pix * spp / wall:.4e} "
            f"mean_radiance={mean:.6f} finite={finite}")
        check(finite and mean > 0.0, f"forward {name} finite, non-black")


def phase_train() -> None:
    import jax
    import jax.numpy as jnp
    import optax
    from raytrace_tpu.core import rng
    from raytrace_tpu.parallel.sharding import make_mesh, sharded_train_step_fn

    scene, settings = cornell(600, TRAIN_SPP, 50)
    settings = settings.replace(rr_depth=2)
    step = sharded_train_step_fn(
        make_mesh(1), settings, optimizer=optax.adam(1e-2), spp=TRAIN_SPP,
        n_iters=TRAIN_ITERS, remat=TRAIN_REMAT, schedule=TRAIN_SCHEDULE)
    pix = jnp.arange(TRAIN_LANES, dtype=jnp.int32)
    samp = jnp.arange(TRAIN_SPP, dtype=jnp.int32)
    target = jnp.full((TRAIN_LANES, 3), 0.1, jnp.float32)
    key = rng.base_key(0)
    opt_state = step.init(scene)
    t0 = time.perf_counter()
    compiled = step.with_state.lower(scene, opt_state, key, pix, samp,
                                     target).compile()
    t_compile = time.perf_counter() - t0
    m = compiled.memory_analysis()
    log(f"[train] remat={TRAIN_REMAT} compile_s={t_compile:.2f} "
        f"memory_analysis: argument={m.argument_size_in_bytes} "
        f"output={m.output_size_in_bytes} temp={m.temp_size_in_bytes} "
        f"generated_code={m.generated_code_size_in_bytes}")
    sc = scene
    for i in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        loss, sc, opt_state, frac = compiled(sc, opt_state, key, pix, samp,
                                             target)
        loss = float(loss)
        frac = float(frac)
        dt = time.perf_counter() - t0
        log(f"[train] step {i}: loss={loss:.6f} samples_completed={frac} "
            f"wall_s={dt:.3f} fwd_bwd_primary_rays_per_s="
            f"{TRAIN_LANES * TRAIN_SPP / dt:.4e}")
        check(np.isfinite(loss), "finite loss")
        check(frac == 1.0, "samples_completed == 1.0")
    moved = sum(float(jnp.sum(jnp.abs(a - b))) for a, b in zip(
        jax.tree_util.tree_leaves(scene), jax.tree_util.tree_leaves(sc))
        if jnp.issubdtype(a.dtype, jnp.floating))
    peak = (jax.devices()[0].memory_stats() or {}).get("peak_bytes_in_use")
    log(f"[train] param_delta={moved:.4e} peak_bytes_in_use={peak}")
    check(moved > 0.0, "parameters moved")


def phase_four_cards() -> None:
    import jax
    import jax.numpy as jnp
    import optax
    from raytrace_tpu.core import rng
    from raytrace_tpu.diff.gradients import partition
    from raytrace_tpu.parallel.sharding import (
        make_mesh, sharded_train_step_fn, sharded_wavefront_render_fn,
    )

    devs = jax.devices()
    check(len(devs) >= FOUR_CARDS, f"{FOUR_CARDS} devices (have {len(devs)})")
    mesh4 = make_mesh(FOUR_CARDS)
    mesh1 = make_mesh(1)
    log(f"[four_cards] mesh (dp, sp) = {dict(mesh4.shape)}")

    def spread(x, what):
        devices = {s.device for s in x.addressable_shards}
        check(len(devices) == FOUR_CARDS, f"{what} on all {FOUR_CARDS} cards "
              f"(found {len(devices)})")

    # --- sharded forward render ---
    scene, settings = cornell(600, FOUR_CARD_RENDER_SPP, 50)
    n_pix = settings.image_width * settings.image_height
    key = rng.base_key(0)
    accs, walls = {}, {}
    for tag, mesh in (("4", mesh4), ("1", mesh1)):
        fn = sharded_wavefront_render_fn(mesh, n_pix, FOUR_CARD_RENDER_SPP)
        fn(scene, settings, key).block_until_ready()      # compile
        t0 = time.perf_counter()
        acc = fn(scene, settings, key)
        acc.block_until_ready()
        walls[tag] = time.perf_counter() - t0
        accs[tag] = acc
    spread(accs["4"], "render output")
    agree = image_agreement(np.asarray(accs["4"])[:n_pix],
                            np.asarray(accs["1"])[:n_pix])
    log(f"[four_cards] render cornell 600px spp={FOUR_CARD_RENDER_SPP}: "
        f"wall_s 4 cards={walls['4']:.3f} 1 card={walls['1']:.3f} "
        f"close_share={agree['close_share']:.6f} "
        f"median_rel={agree['median_rel']:.3e} "
        f"mean_rel={agree['mean_rel']:.3e}")
    check(agree["ok"], "4-card render vs 1-card render")

    # --- sharded train step (SGD, so the update is -lr * gradient) ---
    lr = 1e-3
    settings = cornell(600, TRAIN_SPP, 50)[1].replace(rr_depth=2)
    pix = jnp.arange(TRAIN_LANES, dtype=jnp.int32)
    samp = jnp.arange(TRAIN_SPP, dtype=jnp.int32)
    target = jnp.full((TRAIN_LANES, 3), 0.1, jnp.float32)
    res = {}
    for tag, mesh in (("4", mesh4), ("1", mesh1)):
        step = sharded_train_step_fn(
            mesh, settings, optimizer=optax.sgd(lr), spp=TRAIN_SPP,
            n_iters=TRAIN_ITERS, remat=TRAIN_REMAT, schedule=TRAIN_SCHEDULE)
        opt_state = step.init(scene)
        out = step.with_state(scene, opt_state, key, pix, samp, target)
        jax.block_until_ready(out)                           # compile
        t0 = time.perf_counter()
        loss, sc, _, frac = step.with_state(scene, opt_state, key, pix,
                                            samp, target)
        jax.block_until_ready(sc)
        res[tag] = (float(loss), float(frac), sc,
                    time.perf_counter() - t0)
    p0 = jax.tree_util.tree_leaves(partition(scene)[0])
    grads = {t: [(a - b) / lr for a, b in zip(
        p0, jax.tree_util.tree_leaves(partition(res[t][2])[0]))]
        for t in res}
    for leaf in jax.tree_util.tree_leaves(partition(res["4"][2])[0]):
        spread(leaf, "updated parameters")
    loss_rel = abs(res["4"][0] - res["1"][0]) / max(abs(res["1"][0]), 1e-30)
    grad_rel = rel_l2(grads["4"], grads["1"])
    log(f"[four_cards] train step: loss 4 cards={res['4'][0]:.8f} "
        f"1 card={res['1'][0]:.8f} rel={loss_rel:.3e} (<= {LOSS_RTOL}) "
        f"grads rel_l2={grad_rel:.3e} (<= {GRAD_RTOL}) "
        f"samples_completed={res['4'][1]}/{res['1'][1]} "
        f"wall_s 4 cards={res['4'][3]:.3f} 1 card={res['1'][3]:.3f}")
    check(loss_rel <= LOSS_RTOL, "4-card loss vs 1-card loss")
    check(grad_rel <= GRAD_RTOL, "4-card gradients vs 1-card gradients")
    check(res["4"][1] == 1.0 and res["1"][1] == 1.0,
          "samples_completed == 1.0")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the sharded paths on a 4-card mesh, "
                         "each against the same call on one card")
    args = ap.parse_args(argv)

    import jax
    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"chip_smoke: no GPU found (devices: {devices})",
              file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from raytrace_tpu.utils.compile_cache import enable_compile_cache
    cache_dir = enable_compile_cache()

    smi = card_lines()
    parse_card_lines(smi)
    for line in smi.strip().splitlines():
        log(line.strip())
    for phase in phases_to_run(args.four_cards):
        t0 = time.perf_counter()
        if phase == "device":
            phase_device(cache_dir)
        elif phase == "numerics":
            phase_numerics()
        elif phase == "forward":
            phase_forward()
        elif phase == "train":
            phase_train()
        else:
            phase_four_cards()
        log(f"[{phase}] done in {time.perf_counter() - t0:.1f}s")
    print(result_line(jax.devices()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
