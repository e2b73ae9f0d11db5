"""Test configuration.

Tests run on a virtual 8-device CPU mesh so sharded code paths execute
without accelerator hardware.  Tests marked ``chip`` need an NVIDIA GPU:
they skip elsewhere and run on the card with

  BDSP_TEST_PLATFORMS=cuda python -m pytest tests/ -m chip

Note: jax is pre-imported in this environment, so platform selection must go
through jax.config (env vars are too late).

Configuration matrix (the analog of the reference's feature-matrix CI,
Makefile:6-16, which re-runs the suite under scalar/SSE2/AVX2 builds):
the suite honors two env vars so ``make test-matrix`` can run it under
{planar complex on/off} x {x64 on/off}:

  BDSP_TEST_X64=0        f32/c64-only run (f64 flavors unavailable; tests
                         marked ``requires_x64`` skip, tolerance-based
                         asserts scale to the reference's own f32 golden
                         tolerance — convolution.rs:638 uses 1e-4 for f32)
  BDSP_PLANAR_COMPLEX=1  complex data travels as two real planes across
                         every program boundary (_planar.py)
"""
import os

import jax
import pytest

# Pin the autotune cache so the lazy calibration (triggered by large
# convolutions) loads deterministic reference-gate values instead of
# timing CPU sweeps in every test process.  test_autotune overrides this
# per-test to exercise the measure+persist path.
os.environ.setdefault(
    "BDSP_AUTOTUNE_CACHE",
    os.path.join(os.path.dirname(__file__), "data", "autotune_pinned.json"))

jax.config.update("jax_num_cpu_devices", 8)
jax.config.update("jax_platforms",
                  os.environ.get("BDSP_TEST_PLATFORMS", "cpu"))
# f64 flavors are part of the API surface; the default run exercises both
# precisions.  BDSP_TEST_X64=0 is the f32-only configuration of the matrix.
X64 = os.environ.get("BDSP_TEST_X64", "1") not in ("", "0", "false")
jax.config.update("jax_enable_x64", X64)


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "requires_x64: test depends on f64/c128 flavors (skipped when "
        "BDSP_TEST_X64=0)")
    config.addinivalue_line(
        "markers",
        "chip: test needs an NVIDIA GPU (skipped elsewhere; run on the card "
        "with BDSP_TEST_PLATFORMS=cuda)")


@pytest.fixture(autouse=True)
def _chip_only(request):
    """Skips ``chip`` tests unless JAX runs on a GPU — decided here, at
    test time, so every xdist worker collects the same tests."""
    if request.node.get_closest_marker("chip") is not None \
            and jax.devices()[0].platform != "gpu":
        pytest.skip("needs an NVIDIA GPU: run on the card with "
                    "BDSP_TEST_PLATFORMS=cuda python -m pytest tests/ -m chip")


def pytest_collection_modifyitems(config, items):
    if X64:
        return
    skip = pytest.mark.skip(reason="f64 flavors disabled (BDSP_TEST_X64=0)")
    for item in items:
        if "requires_x64" in item.keywords:
            item.add_marker(skip)
