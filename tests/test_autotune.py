"""Autotune calibration: lazy trigger, measured sweep,
per-device-kind persistence, and cache pickup in a fresh process state —
the analog of the reference's threading.rs:39-193 self-calibration +
print_calibration (threading.rs:282-289)."""
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest

import basic_dsp_tpu as bd
from basic_dsp_tpu import autotune, config
from tools import create_complex_data


@pytest.fixture
def fresh_cache(tmp_path, monkeypatch):
    path = tmp_path / "autotune.json"
    monkeypatch.setenv("BDSP_AUTOTUNE_CACHE", str(path))
    saved_cfg = config.default_config()
    autotune._reset_for_tests()
    yield path
    autotune._reset_for_tests()
    config.set_default_config(saved_cfg)


def test_calibrate_measures_installs_and_persists(fresh_cache):
    entry = autotune.calibrate(n=1 << 14,
                               block_candidates=(1024, 2048),
                               crossover_kernels=(96,),
                               iters=2)
    assert entry["fft_block_len"] in (1024, 2048)
    assert entry["direct_conv_max_imp_len"] >= 202  # never below the gate
    # installed into the live default config
    assert config.default_config().fft_block_len == entry["fft_block_len"]
    # persisted per device_kind
    on_disk = json.loads(fresh_cache.read_text())
    assert entry["device_kind"] in on_disk
    assert (on_disk[entry["device_kind"]]["fft_block_len"]
            == entry["fft_block_len"])
    report = autotune.print_calibration()
    assert "fft_block_len" in report and "toeplitz" in report


def test_fresh_process_picks_cache_without_measuring(fresh_cache):
    fresh_cache.write_text(json.dumps({
        autotune._device_kind(): {
            "device_kind": autotune._device_kind(),
            "fft_block_len": 8192,
            "direct_conv_max_imp_len": 256,
        }}))
    # Simulated fresh process: no in-memory state.
    autotune._reset_for_tests()
    entry = autotune.ensure_calibrated()
    assert entry["source"] == "cache"  # loaded, not measured
    assert config.default_config().fft_block_len == 8192
    assert config.default_config().direct_conv_max_imp_len == 256
    # Idempotent.
    assert autotune.ensure_calibrated() is entry


def test_lazy_trigger_on_first_large_convolution(fresh_cache):
    fresh_cache.write_text(json.dumps({
        autotune._device_kind(): {
            "device_kind": autotune._device_kind(),
            "fft_block_len": 2048,
            "direct_conv_max_imp_len": 202,
        }}))
    autotune._reset_for_tests()
    assert autotune._state is None
    n = config.default_config().overlap_save_min_len + 24
    x = bd.to_complex_time_vec(create_complex_data(1, n, dtype=np.complex64))
    h = bd.to_complex_time_vec(create_complex_data(2, 17,
                                                   dtype=np.complex64))
    x.convolve_signal(h)
    assert autotune._state is not None, "large conv must trigger calibration"
    assert config.default_config().fft_block_len == 2048


def test_small_convolution_does_not_trigger(fresh_cache):
    autotune._reset_for_tests()
    x = bd.to_complex_time_vec(create_complex_data(3, 256,
                                                   dtype=np.complex64))
    h = bd.to_complex_time_vec(create_complex_data(4, 9, dtype=np.complex64))
    x.convolve_signal(h)
    assert autotune._state is None
