"""Self-calibration — the device analog of the reference's one-time multicore
calibration (multicore_support/threading.rs:39-193): the reference times
sin() sweeps on first parallel use, fits thresholds with linear regression,
and caches the result for the process lifetime; ``print_calibration``
(threading.rs:282-289) reports the fit.

Here the tunables are the dispatch knobs of the convolution engine:

* ``fft_block_len`` — block length of the blocked overlap-save pipeline;
* ``direct_conv_max_imp_len`` — the Toeplitz-matmul <-> blocked-FFT
  crossover kernel length.

Calibration runs lazily on the first large convolution (the analog of
threading.rs:190-193), takes a few seconds (compile-dominated), and
persists per ``device_kind`` to a JSON cache so a fresh process picks the
tuned values without re-timing (the reference re-calibrates per process;
we improve on that since compiling for an accelerator costs much more).
"""
from __future__ import annotations

import json
import os
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from . import config as _config

# device_kind -> {"fft_block_len": int, "direct_conv_max_imp_len": int,
#                 "timings": {...}}
_state: Optional[dict] = None
_results: Dict[str, List[Tuple[int, float]]] = {}


def _cache_path() -> str:
    env = os.environ.get("BDSP_AUTOTUNE_CACHE")
    if env:
        return env
    base = os.environ.get("XDG_CACHE_HOME",
                          os.path.join(os.path.expanduser("~"), ".cache"))
    return os.path.join(base, "basic_dsp_tpu", "autotune.json")


def _device_kind() -> str:
    import jax
    dev = jax.devices()[0]
    kind = getattr(dev, "device_kind", "") or dev.platform
    return str(kind)


def _load_cache() -> dict:
    try:
        with open(_cache_path()) as f:
            return json.load(f)
    except (OSError, ValueError):
        return {}


def _save_cache(all_kinds: dict) -> None:
    path = _cache_path()
    try:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as f:
            json.dump(all_kinds, f, indent=1, sort_keys=True)
    except OSError:
        pass  # read-only environments: calibration stays process-local


def _install(entry: dict) -> None:
    global _state
    _state = entry
    import dataclasses
    cfg = _config.default_config()
    _config.set_default_config(dataclasses.replace(
        cfg,
        direct_conv_max_imp_len=int(entry.get(
            "direct_conv_max_imp_len", cfg.direct_conv_max_imp_len)),
        fft_block_len=int(entry.get("fft_block_len", 0)),
    ))


def ensure_calibrated() -> dict:
    """Lazy one-time calibration (threading.rs:190-193 analog): loads the
    per-device-kind cache if present, otherwise times the sweeps and
    persists them.  Returns the installed entry."""
    global _state
    if _state is not None:
        return _state
    kind = _device_kind()
    cache = _load_cache()
    if kind in cache:
        _install(cache[kind])
        _state["source"] = "cache"
        return _state
    entry = calibrate()
    entry["source"] = "measured"
    return entry


def _time_fn(f, *args, iters: int) -> float:
    """Median-of-3 per-iteration seconds."""
    f(*args).block_until_ready()  # compile + warm
    ts = []
    for _ in range(3):
        t0 = time.perf_counter()
        f(*args).block_until_ready()
        ts.append((time.perf_counter() - t0) / iters)
    return sorted(ts)[1]


def calibrate(n: int = 1 << 19,
              block_candidates: Tuple[int, ...] = (1024, 2048, 4096, 8192),
              crossover_kernels: Tuple[int, ...] = (96, 160, 224, 320),
              iters: int = 4) -> dict:
    """Times the tunables on the actual device and installs + persists the
    winners.  One-time cost is a few seconds (compile-dominated) —
    mirroring the reference's 200-500 ms calibration contract
    (threading.rs:237) scaled to accelerator compile costs."""
    import jax
    import jax.numpy as jnp

    from .ops import conv_ops

    rng = np.random.default_rng(0)
    x_re = jnp.asarray(rng.normal(size=n).astype(np.float32))
    x_im = jnp.asarray(rng.normal(size=n).astype(np.float32))

    def loop(step):
        @jax.jit
        def f(x_re, x_im, h_re):
            x = x_re + 1j * x_im
            h = h_re.astype(jnp.complex64)

            def body(_, carry):
                y = step(carry, h)
                return y / (jnp.abs(y[0]) + 1.0)

            return jnp.abs(jax.lax.fori_loop(0, iters, body, x)[0])

        return f

    # --- knob 1: overlap-save block length (128-tap workload) -----------
    h128 = jnp.asarray(rng.normal(size=128).astype(np.float32))
    block_times = []
    for fl in block_candidates:
        if fl < 256:
            continue
        f = loop(lambda x, h, fl=fl: conv_ops.overlap_save(x, h, True, fl))
        block_times.append((fl, _time_fn(f, x_re, x_im, h128, iters=iters)))
    best_block = min(block_times, key=lambda t: t[1])[0]
    _results["fft_block_len"] = block_times

    # --- knob 2: Toeplitz <-> blocked-FFT crossover kernel length --------
    # Time both paths at each kernel length; the crossover is the largest
    # m where the matmul path still wins (the reference's SIMD gate analog,
    # convolution.rs:499: imp_len <= 202).
    crossover = 0
    xo_times = []
    for m in crossover_kernels:
        hm = jnp.asarray(rng.normal(size=m).astype(np.float32))
        f_t = loop(lambda x, h: conv_ops.toeplitz_conv(x, h, True))
        f_b = loop(lambda x, h, fl=best_block:
                   conv_ops.overlap_save(x, h, True,
                                         conv_ops.pick_fft_len(m, fl)))
        tt = _time_fn(f_t, x_re, x_im, hm, iters=iters)
        tb = _time_fn(f_b, x_re, x_im, hm, iters=iters)
        xo_times.append((m, tt, tb))
        if tt <= tb:
            crossover = max(crossover, m)
    _results["crossover"] = xo_times
    # Never tune below the reference's proven gate.
    direct_max = max(crossover, 202)

    entry = {
        "fft_block_len": int(best_block),
        "direct_conv_max_imp_len": int(direct_max),
        "device_kind": _device_kind(),
        "timings": {
            "fft_block_len": [[int(fl), float(dt)] for fl, dt in block_times],
            "crossover": [[int(m), float(tt), float(tb)]
                          for m, tt, tb in xo_times],
            "workload_n": n,
        },
    }
    cache = _load_cache()
    cache[entry["device_kind"]] = entry
    _save_cache(cache)
    _install(entry)
    return entry


def print_calibration() -> str:
    """Debug report of the fitted table (reference print_calibration,
    threading.rs:282-289)."""
    lines = []
    if _state is None:
        lines.append("not calibrated (runs lazily on the first large "
                     "convolution, or call autotune.calibrate())")
    else:
        lines.append(f"device_kind: {_state.get('device_kind', '?')} "
                     f"(source: {_state.get('source', 'measured')})")
        lines.append(f"fft_block_len: {_state.get('fft_block_len')}")
        lines.append("direct_conv_max_imp_len: "
                     f"{_state.get('direct_conv_max_imp_len')}")
        t = _state.get("timings", {})
        for fl, dt in t.get("fft_block_len", []):
            n = t.get("workload_n", 0)
            lines.append(f"  overlap_save fft_len={fl}: {dt * 1e3:.3f} "
                         f"ms/iter ({n / dt / 1e6:.0f} Msamples/s)")
        for m, tt, tb in t.get("crossover", []):
            lines.append(f"  m={m}: toeplitz {tt * 1e3:.3f} ms vs "
                         f"blocked {tb * 1e3:.3f} ms")
    report = "\n".join(lines)
    print(report)
    return report


def _reset_for_tests() -> None:
    """Clears process-local state so tests can exercise the lazy path."""
    global _state
    _state = None
    _results.clear()
