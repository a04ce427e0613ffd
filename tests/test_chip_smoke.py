"""The parts of ``chip_smoke.py`` that run without a GPU: its refusal to
run on the CPU, the compile-cache rule, the contract line, the phase
selection, the ``nvidia-smi`` parsing and the image comparison."""
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest

import chip_smoke
from raytrace_tpu.utils import compile_cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_exits_nonzero_without_gpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    assert "no GPU" in out.stderr


@pytest.fixture
def restore_cache_dir():
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


def test_cache_follows_env_variable(monkeypatch, restore_cache_dir):
    jax.config.update("jax_compilation_cache_dir", None)
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/some/cache")
    assert compile_cache.enable_compile_cache() == "/some/cache"
    # the variable is JAX's own: nothing is set in code
    assert jax.config.jax_compilation_cache_dir is None


def test_cache_falls_back_to_fixed_path(monkeypatch, restore_cache_dir):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = compile_cache.enable_compile_cache()
    assert path == os.path.join(REPO, ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == path


def test_result_line_has_exactly_the_contract_keys():
    class Dev:
        platform = "gpu"
        device_kind = "NVIDIA H100 80GB HBM3"

    line = chip_smoke.result_line([Dev()])
    obj = json.loads(line)
    assert obj == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1}}
    assert "\n" not in line


def test_four_cards_selects_only_its_phase():
    assert chip_smoke.phases_to_run(True) == ("four_cards",)
    single = chip_smoke.phases_to_run(False)
    assert single == ("device", "numerics", "forward", "train")
    assert "four_cards" not in single


def test_nvidia_smi_line_parses():
    text = "NVIDIA H100 80GB HBM3, 700.00 W\nNVIDIA H100 80GB HBM3, 500.00 W\n"
    assert chip_smoke.parse_card_lines(text) == [
        ("NVIDIA H100 80GB HBM3", "700.00 W"),
        ("NVIDIA H100 80GB HBM3", "500.00 W")]
    for bad in ("", "NVIDIA H100 80GB HBM3\n", ", 700.00 W\n"):
        with pytest.raises(ValueError):
            chip_smoke.parse_card_lines(bad)


def test_image_agreement_tolerates_rare_flips_only():
    rng = np.random.default_rng(0)
    ref = rng.uniform(0.1, 1.0, (4096, 3))
    assert chip_smoke.image_agreement(ref * (1 + 1e-6), ref)["ok"]
    flipped = ref.copy()
    idx = rng.choice(4096, 200, replace=False)     # ~5% of pixels hold
    flipped[idx] += rng.normal(0.0, 0.05, (200, 3))  # a re-drawn sample
    assert chip_smoke.image_agreement(flipped, ref)["ok"]
    # a systematic 1% error, or every pixel off by 1e-3, is not rounding
    assert not chip_smoke.image_agreement(ref * 1.01, ref)["ok"]
    assert not chip_smoke.image_agreement(ref + 1e-3, ref)["ok"]
    noisy = ref.copy()
    noisy[:820] *= 1.05                            # 20% of pixels off
    assert not chip_smoke.image_agreement(noisy, ref)["ok"]
