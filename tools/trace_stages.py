"""Device time per wavefront stage, from one ``jax.profiler`` trace.

Renders a scene once with the pixel-stationary wavefront (compiling it),
then again under ``jax.profiler.trace``, and sums the device time of
every kernel by the trace span its HLO op belongs to: ``intersect``,
``volume_crossing`` and ``shade`` (render/integrator.py:bounce), or
``other`` (regeneration, RNG, accumulation, loop control).  Each sum is
divided by the wavefront iteration count.  A kernel is attributed
through the ``op_name`` metadata of its HLO instruction in the compiled
module (for a fusion: the span most of its fused ops carry).  The trace
runs with XLA's command buffers off (``--xla_gpu_enable_command_buffer=``)
so that each kernel is its own trace event instead of one graph launch
per loop body; launch gaps are then part of the window.

Usage:
    python tools/trace_stages.py --scene cornell|demo2 [--width W]
                                 [--spp N] [--out DIR]
Prints one JSON line; the raw trace stays under ``--out``.
"""
import argparse
import collections
import glob
import json
import os
import re
import sys
import time

SPANS = ("volume_crossing", "intersect", "shade")
_INSTR = re.compile(r"^\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=.*")
_OP_NAME = re.compile(r'op_name="([^"]*)"')
_CALLS = re.compile(r"calls=%?([\w.\-]+)")
_COMP = re.compile(r"^\s*(?:ENTRY\s+)?%?([\w.\-]+)\s.*\{\s*$")


def span_of(op_name: str) -> str:
    for s in SPANS:
        if f"/{s}/" in op_name or op_name.endswith(f"/{s}"):
            return s
    return "other"


def hlo_spans(hlo_text: str) -> dict:
    """HLO instruction name -> span, from the compiled module's text."""
    comp_ops = collections.defaultdict(list)   # computation -> op_names
    instr_op, instr_calls = {}, {}
    comp = None
    for line in hlo_text.splitlines():
        m = _COMP.match(line)
        if m and "=" not in line.split("{")[0]:
            comp = m.group(1)
            continue
        m = _INSTR.match(line)
        if not m:
            continue
        name = m.group(1)
        op = _OP_NAME.search(line)
        if op:
            instr_op[name] = op.group(1)
            if comp is not None:
                comp_ops[comp].append(op.group(1))
        c = _CALLS.search(line)
        if c:
            instr_calls[name] = c.group(1)
    out = {}
    for name in set(instr_op) | set(instr_calls):
        spans = [span_of(o) for o in comp_ops.get(instr_calls.get(name), [])]
        if spans:
            out[name] = collections.Counter(spans).most_common(1)[0][0]
        else:
            out[name] = span_of(instr_op.get(name, ""))
    return out


def reduce_trace(xplane_path: str, spans: dict) -> dict:
    """Sum kernel device time by span; busy = union of kernel intervals."""
    from jax.profiler import ProfileData
    pd = ProfileData.from_file(xplane_path)
    per_span = collections.Counter()
    n_events = collections.Counter()
    unmapped = collections.Counter()
    intervals = []
    for plane in pd.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            if not line.name.startswith("Stream"):
                continue
            for ev in line.events:
                stats = dict(ev.stats)
                op = str(stats.get("hlo_op", ev.name))
                span = spans.get(op)
                if span is None:
                    unmapped[op] += ev.duration_ns
                    span = "other"
                per_span[span] += ev.duration_ns
                n_events[span] += 1
                intervals.append((ev.start_ns, ev.start_ns + ev.duration_ns))
    intervals.sort()
    busy, end, start0 = 0.0, None, None
    for a, b in intervals:
        start0 = a if start0 is None else start0
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    window = (end - start0) if intervals else 0.0
    return {"span_ns": dict(per_span), "events": dict(n_events),
            "busy_ns": busy, "window_ns": window,
            "unmapped_top": unmapped.most_common(5)}


def build(name: str, width: int, spp: int):
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, repo)
    if name == "cornell":
        from __graft_entry__ import _cornell_scene_and_settings
        return _cornell_scene_and_settings(width=width, spp=spp, depth=50)
    sys.path.insert(0, os.path.join(repo, "scenes"))
    import demo2
    scene, settings, _ = demo2.build(argparse.Namespace(
        width=width, spp=spp, depth=4))
    return scene, settings


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--scene", choices=("cornell", "demo2"),
                    default="cornell")
    ap.add_argument("--width", type=int, default=600)
    ap.add_argument("--spp", type=int, default=8)
    ap.add_argument("--out", default="trace_out")
    args = ap.parse_args()

    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_gpu_enable_command_buffer=")
    import jax
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"trace_stages: no GPU found (devices: {jax.devices()})")
    scene, settings = build(args.scene, args.width, args.spp)
    from raytrace_tpu.core import rng
    from raytrace_tpu.render.integrator import trace_wavefront_stationary
    from raytrace_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()

    n_pix = settings.image_width * settings.image_height
    rot = next((k for k in range(8, 1, -1) if args.spp % k == 0), 1)

    def run(scene, settings, key):
        return trace_wavefront_stationary(scene, settings, key, n_pix,
                                          args.spp, rotate_k=rot,
                                          with_stats=True)

    fn = jax.jit(run)
    compiled = fn.lower(scene, settings, rng.base_key(0)).compile()
    spans = hlo_spans(compiled.as_text())
    acc, st = compiled(scene, settings, rng.base_key(0))
    acc.block_until_ready()
    out_dir = os.path.join(args.out, args.scene)
    t0 = time.perf_counter()
    with jax.profiler.trace(out_dir):
        acc, st = compiled(scene, settings, rng.base_key(1))
        acc.block_until_ready()
    wall = time.perf_counter() - t0
    iters = int(st["iterations"])
    path = sorted(glob.glob(os.path.join(
        out_dir, "plugins", "profile", "*", "*.xplane.pb")))[-1]
    red = reduce_trace(path, spans)
    per_iter_ms = {k: v / iters / 1e6 for k, v in red["span_ns"].items()}
    print(json.dumps({
        "scene": args.scene, "width": args.width, "spp": args.spp,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "iterations": iters, "lanes": int(st["lanes"]),
        "wall_s_traced": wall,
        "per_iteration_ms": per_iter_ms,
        "kernel_events": red["events"],
        "busy_share": red["busy_ns"] / max(red["window_ns"], 1.0),
        "window_ms": red["window_ns"] / 1e6,
        "unmapped_top": red["unmapped_top"],
        "xplane": path,
    }))


if __name__ == "__main__":
    main()
