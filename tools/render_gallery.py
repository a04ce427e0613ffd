"""Render every reference scene into docs/renders/ (visual evidence of
the full capability surface; compare with the PNGs in /root/reference).

Moderate settings (not the full reference spp) — these are eyeball
artifacts, PARITY.md holds the statistical comparisons.

Each scene renders in its own process, one after the other, so only one
process holds the device at a time.

Usage: python tools/render_gallery.py [--cpu]     (GPU unless --cpu)
"""
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(REPO, "docs", "renders")

SCENES = [
    ("readme_example.py", ["--width", "400", "--spp", "100"]),
    ("metal_test.py", ["--width", "400", "--spp", "100"]),
    ("noise_test.py", ["--width", "400", "--spp", "100"]),
    ("quad_test.py", ["--width", "400", "--spp", "100"]),
    ("cuboid_test.py", ["--width", "400", "--spp", "100"]),
    ("sphere_uv_test.py", []),
    ("demo1.py", ["--width", "600", "--spp", "100", "--depth", "50"]),
    ("cornell_box.py", ["--width", "400", "--spp", "200", "--depth", "50"]),
    ("cornell_smoke.py", ["--width", "400", "--spp", "200", "--depth", "50"]),
    ("demo2.py", ["--width", "400", "--spp", "100", "--depth", "4"]),
    ("pawn_test.py", ["--width", "400", "--spp", "200", "--depth", "20"]),
    ("lommel_seeliger_test.py", ["--width", "400", "--spp", "200"]),
    ("bunny_test.py", ["--width", "400", "--spp", "100", "--depth", "10"]),
]


def main():
    cpu = "--cpu" in sys.argv
    os.makedirs(OUT, exist_ok=True)
    for script, sargs in SCENES:
        name = script.replace(".py", ".png")
        out = os.path.join(OUT, name)
        cmd = [sys.executable, os.path.join(REPO, "scenes", script), *sargs,
               "--out", out]
        if not cpu:
            cmd.append("--gpu")
        r = subprocess.run(cmd)
        print(f"rendered {name}" if r.returncode == 0 else f"FAILED {script}",
              flush=True)


if __name__ == "__main__":
    main()
