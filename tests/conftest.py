"""Test configuration.

By default the suite runs on the CPU with 8 virtual devices, so the
sharding tests run without accelerator hardware (SURVEY.md §4
implication (c)).  Tests that need the GPU carry the ``gpu`` marker and
take the ``gpu_device`` fixture, which skips them when JAX sees no GPU.
Run them on a GPU machine with

    JAX_PLATFORMS=cuda python -m pytest tests -m gpu
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "")
    + " --xla_force_host_platform_device_count=8"
)

import jax  # noqa: E402
import pytest  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a GPU (skips with a reason when there is none)")


@pytest.fixture
def gpu_device():
    """The first GPU device; skips the test when JAX sees none.  Decided
    here, at run time, never at import: every xdist worker must collect
    the same tests."""
    gpus = [d for d in jax.devices() if d.platform == "gpu"]
    if not gpus:
        pytest.skip("needs a GPU; run `JAX_PLATFORMS=cuda python -m pytest "
                    "tests -m gpu` on a GPU machine")
    return gpus[0]


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_per_module():
    """Free compiled executables between test modules.

    The full suite compiles hundreds of XLA CPU programs; letting them
    accumulate segfaults the compiler deterministically around test
    ~150 (reproduced twice at test_sharding.py:50 — any half of the
    suite plus that test passes, the whole suite does not).  Per-module
    compilation state is self-contained, so clearing costs only a few
    re-traces."""
    yield
    jax.clear_caches()
