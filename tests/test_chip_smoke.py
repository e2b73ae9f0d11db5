"""chip_smoke.py and the shared harness (profiling): the peak table, the
compile-cache path, the device checks, the phase selection and the closing
line — plus the on-card check of the flagship chain (``chip`` marker)."""
import json
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import bench_all  # noqa: E402
import chip_smoke  # noqa: E402
from basic_dsp_tpu import profiling, reference  # noqa: E402


@pytest.mark.parametrize("kind", ["cpu", "NVIDIA A100-SXM4-80GB",
                                  "NVIDIA H100 PCIe", "nvidia h100 80gb hbm3"])
def test_unknown_device_kind_raises(kind):
    with pytest.raises(KeyError, match="no peak table entry"):
        profiling.peaks(kind)


def test_h100_row_and_compulsory_floor():
    p = profiling.peaks("NVIDIA H100 80GB HBM3")
    assert p["hbm_bytes_per_s"] == 3.35e12
    assert p["f32_flops"] == 67e12 and p["bf16_flops"] == 989e12
    assert profiling.compulsory_floor_s(
        3.35e9, "NVIDIA H100 80GB HBM3") == pytest.approx(1e-3)


def test_cache_dir_follows_env(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert profiling.compile_cache_dir(chip_smoke.ROOT) == str(tmp_path)


def test_cache_dir_defaults_to_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert profiling.compile_cache_dir(chip_smoke.ROOT) == os.path.join(
        chip_smoke.ROOT, ".jax_cache")
    assert chip_smoke.ROOT == os.path.dirname(os.path.abspath(
        chip_smoke.__file__))


def test_last_line_format():
    dev = {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1}
    line = chip_smoke.last_line(dev)
    assert line == ('{"ok": true, "device": {"platform": "gpu", "kind": '
                    '"NVIDIA H100 80GB HBM3", "count": 1}}')
    assert json.loads(line)["device"] == dev


@pytest.mark.parametrize("four,expected", [
    (True, ("sharded",)),
    (False, ("main", "accuracy", "plain", "f64")),
])
def test_phase_selection(four, expected):
    assert chip_smoke.phases_for(four) == expected
    assert set(chip_smoke.phases_for(four)) <= set(chip_smoke.PHASE_FUNCS)


def test_cpu_platform_refused(capsys):
    with pytest.raises(RuntimeError, match="no GPU"):
        profiling.require_gpu()
    with pytest.raises(RuntimeError, match="no GPU"):
        chip_smoke.run(False)
    with pytest.raises(RuntimeError, match="no GPU"):
        bench_all.setup()
    assert '"ok"' not in capsys.readouterr().out


def test_four_option_parsed(monkeypatch):
    seen = []
    monkeypatch.setattr(chip_smoke, "run", lambda four: seen.append(four)
                        or 0)
    assert chip_smoke.main(["--four"]) == 0
    assert chip_smoke.main([]) == 0
    assert seen == [True, False]


@pytest.mark.chip
def test_flagship_on_card():
    """The flagship chain on the card at 64K samples: f32 grade against
    the float64 reference (a TF32 matmul would miss 1e-5)."""
    import jax
    sizes = dict(bench_all.SIZES, flagship_n=1 << 16)
    cfg = bench_all.flagship(sizes)
    got = np.asarray(jax.jit(cfg.fn)(*cfg.args))
    assert reference.max_rel_err(got, cfg.ref()) < cfg.tol
