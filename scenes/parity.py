"""Golden-image parity vs the reference's own rendered PNGs.

The reference repo checks in renders of its scenes; this script renders
the same configurations with this framework and compares downsampled
images (Monte-Carlo parity is statistical, not bitwise — SURVEY.md §7
hard part (b)).  The comparison scale to beat is the reference's *own*
internal noise: |cornell_redirect - cornell_noisy| averages ~0.015 at
64px, i.e. two renders of the same scene by the reference itself differ
by that much.

Usage:  python scenes/parity.py [--quick] [--cpu]   (GPU unless --cpu)
Prints one JSON line per scene plus a summary verdict.
"""
import argparse
import json
import os
import subprocess
import sys
import tempfile

import numpy as np
from PIL import Image

HERE = os.path.dirname(os.path.abspath(__file__))
REF = "/root/reference"

CASES = [
    # (scene script, args, reference png, resize, mode)
    # mode "pixel": strict statistical pixel parity (deterministic scene).
    # mode "brightness": the scene GENERATION is random (Haskell StdGen
    # streams are unreproducible outside GHC), so small-object layout
    # differs; compare global brightness + eyeball the composition.
    ("cornell_box.py", ["--width", "600", "--spp", "200", "--depth", "50"],
     "cornell_box_redirect.png", (64, 64), "pixel"),
    ("readme_example.py", ["--width", "600", "--spp", "50"],
     "example_image.png", (64, 36), "pixel"),
    # pawnTest (test/Main.hs:323-344: 500px, 400spp, depth 20, vfov 80)
    ("pawn_test.py", ["--width", "500", "--spp", "400", "--depth", "20"],
     "pawn_demo.png", (64, 64), "pixel"),
    # README hero image (test/Main.hs:136-186): 400+ randomly placed
    # spheres from the scene RNG -> layout differs by construction
    ("demo1.py", ["--width", "1200", "--spp", "500", "--depth", "50"],
     "demo1.png", (64, 36), "brightness"),
    # demo2.png is 800px but its spp/depth are not recorded in the
    # reference; excluded (depth changes truncation bias, not just noise).
]


def load(path, size):
    im = Image.open(path).convert("RGB")
    return np.asarray(im.resize(size, Image.BILINEAR), float) / 255.0


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true",
                    help="render at reduced spp (for smoke checks)")
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--reuse", action="store_true",
                    help="reuse existing /tmp/parity_* renders")
    args = ap.parse_args()

    results = []
    for script, sargs, ref_png, size, mode in CASES:
        ref_path = os.path.join(REF, ref_png)
        if not os.path.exists(ref_path):
            print(f"skip {script}: no reference render {ref_png}")
            continue
        out = os.path.join(tempfile.gettempdir(), f"parity_{ref_png}")
        if args.reuse and os.path.exists(out):
            print(f"reusing {out}", flush=True)
            ours = load(out, size)
            ref = load(ref_path, size)
            diff = np.abs(ours - ref)
            results.append({
                "scene": script, "reference": ref_png,
                "mean_abs_diff": round(float(diff.mean()), 5),
                "p95_abs_diff": round(float(np.percentile(diff, 95)), 5),
                "max_abs_diff": round(float(diff.max()), 5),
                "mean_ours": round(float(ours.mean()), 5),
                "mean_ref": round(float(ref.mean()), 5),
                "mode": mode,
            })
            print(json.dumps(results[-1]), flush=True)
            continue
        cmd = [sys.executable, os.path.join(HERE, script), *sargs,
               "--out", out]
        if not args.cpu:
            cmd.append("--gpu")
        if args.quick:
            cmd = [c if c != "200" else "32" for c in cmd]
            cmd = [c if c != "50" else "16" for c in cmd]
        r = subprocess.run(cmd)
        if r.returncode != 0:
            print(f"skip {script}: render failed (rc={r.returncode})")
            continue
        ours = load(out, size)
        ref = load(ref_path, size)
        diff = np.abs(ours - ref)
        rec = {
            "scene": script,
            "reference": ref_png,
            "mean_abs_diff": round(float(diff.mean()), 5),
            "p95_abs_diff": round(float(np.percentile(diff, 95)), 5),
            "max_abs_diff": round(float(diff.max()), 5),
            "mean_ours": round(float(ours.mean()), 5),
            "mean_ref": round(float(ref.mean()), 5),
            "mode": mode,
        }
        print(json.dumps(rec), flush=True)
        results.append(rec)

    ok = all(
        (r["mean_abs_diff"] < 0.02) if r["mode"] == "pixel"
        else (abs(r["mean_ours"] - r["mean_ref"])
              < 0.05 * max(r["mean_ref"], 1e-6))
        for r in results)
    print(json.dumps({"parity": "PASS" if ok else "FAIL",
                      "criterion": "pixel scenes: mean_abs_diff < 0.02 "
                      "(reference's own inter-render noise is ~0.015); "
                      "random-layout scenes: mean brightness within 5%"}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
