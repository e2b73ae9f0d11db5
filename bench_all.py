"""Benchmark suite over the BASELINE.md configurations, one JSON line each.

1. flagship: 4M-sample complex64 signal, 128-tap raised-cosine FIR,
   Hamming window, |fftshift(FFT)| (``pipelines.fir_fft_chain``);
2. cfg1: windowed FFT magnitude of a 1M real sine;
3. cfg2: 4M complex raised-cosine FIR (``conv_ops.convolve_signal``);
4. cfg3: fractional resampling x1.5 of 1M samples, two planes;
5. cfg4: modulation chain, 131072 PRBS symbols, RC pulse shaping x10;
6. cfg5: 1024-channel polyphase channelizer + FM demod over 4M samples.

Each configuration carries its numpy float64 reference (used by
``chip_smoke.py``) and its compulsory bytes: the input read plus the output
write.  ``floor_share`` is the time those bytes take at the card's
published HBM peak (``profiling.PEAKS``) over the measured time — a lower
bound on the work, not a model of it.  Timing is ``profiling.time_op``.

Usage: ``python bench_all.py [--json FILE]`` on a machine with a GPU.
"""
import argparse
import collections
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

SIZES = {
    "flagship_n": 1 << 22, "fir_taps": 128,
    "cfg1_n": 1 << 20,
    "cfg2_n": 1 << 22,
    "cfg3_n": 1 << 20,
    "cfg4_symbols": 1 << 17,
    "cfg5_n": 1 << 22, "channels": 1024,
    "iters": 20, "reps": 5,
}

# fn(*args) is the measured call; ref() its float64 reference and
# err(got, want) the error compared with tol; floor_bytes the compulsory
# input + output bytes.
Config = collections.namedtuple(
    "Config", "metric fn args samples ref err tol floor_bytes")


def _rng(seed):
    return np.random.default_rng(seed)


def complex_signal(n, seed):
    r = _rng(seed)
    return (r.normal(size=n) + 1j * r.normal(size=n)).astype(np.complex64)


def rc_taps(m):
    """The flagship's 128-tap raised-cosine FIR, unit DC gain."""
    from basic_dsp_tpu import reference
    t = (np.arange(m) - m // 2) * 0.25
    taps = reference.raised_cosine(0.35)(t)
    return (taps / taps.sum()).astype(np.float32)


def flagship(sizes):
    import jax.numpy as jnp
    from basic_dsp_tpu import pipelines, reference
    from basic_dsp_tpu.windows import HammingWindow

    n, m = sizes["flagship_n"], sizes["fir_taps"]
    x = complex_signal(n, 0)
    taps = rc_taps(m)
    win = np.asarray(HammingWindow().sample(n, dtype=jnp.float32))

    def ref():
        filt = reference.convolve_circular_centered(x, taps)
        return reference.shifted_spectrum_mag(filt * win)

    return Config("fir_fft_chain_4m", pipelines.fir_fft_chain,
                  (jnp.asarray(x), jnp.asarray(taps), jnp.asarray(win)), n,
                  ref, reference.max_rel_err, 1e-5, 8 * n + 4 * n)


def cfg1(sizes):
    import jax.numpy as jnp
    from basic_dsp_tpu import pipelines, reference
    from basic_dsp_tpu.windows import HammingWindow

    n = sizes["cfg1_n"]
    sine = np.sin(2 * np.pi * 0.01 * np.arange(n)).astype(np.float32)
    w = np.asarray(HammingWindow().sample(n, dtype=jnp.float32))
    return Config("windowed_fft_magnitude_1m", pipelines.windowed_spectrum,
                  (jnp.asarray(sine), jnp.asarray(w)), n,
                  lambda: reference.shifted_spectrum_mag(
                      sine.astype(np.float64) * w),
                  reference.max_rel_err, 1e-5, 4 * n + 4 * n)


def cfg2(sizes):
    import jax.numpy as jnp
    from basic_dsp_tpu import reference
    from basic_dsp_tpu.ops import conv_ops

    n, m = sizes["cfg2_n"], sizes["fir_taps"]
    x = complex_signal(n, 1)
    h = reference.raised_cosine(0.35)((np.arange(m) - m // 2) * 0.25
                                      ).astype(np.complex64)

    def fn(x, h):
        return conv_ops.convolve_signal(x, h, True)

    return Config("rc_fir_4m", fn, (jnp.asarray(x), jnp.asarray(h)), n,
                  lambda: reference.convolve_circular_centered(x, h),
                  reference.max_rel_err, 1e-5, 16 * n)


def _stacked_err(got, want):
    from basic_dsp_tpu import reference
    return reference.max_rel_err(np.stack(got), want)


def cfg3(sizes):
    import jax.numpy as jnp
    from basic_dsp_tpu import reference
    from basic_dsp_tpu.conv_types import SincFunction
    from basic_dsp_tpu.ops import interp_ops

    n = sizes["cfg3_n"]
    r = _rng(2)
    a_re = r.normal(size=n).astype(np.float32)
    a_im = r.normal(size=n).astype(np.float32)

    def fn(xr, xi):
        f = SincFunction()
        return (interp_ops.interpolatef(xr, f, 1.5, 0.0, 10, 1.0),
                interp_ops.interpolatef(xi, f, 1.5, 0.0, 10, 1.0))

    def ref():
        return np.stack([reference.interpolatef(p, reference.sinc, 1.5,
                                                0.0, 10) for p in
                         (a_re, a_im)])

    return Config("interpolatef_1_5x_1m", fn,
                  (jnp.asarray(a_re), jnp.asarray(a_im)), n, ref,
                  _stacked_err, 1e-5, 8 * n + 8 * (n * 3 // 2))


def cfg4(sizes):
    import jax.numpy as jnp
    from basic_dsp_tpu import pipelines, reference

    n = sizes["cfg4_symbols"]
    r = _rng(3)
    s_re = r.choice([-0.5, 0.5], n).astype(np.float32)
    s_im = r.choice([-0.5, 0.5], n).astype(np.float32)

    def ref():
        rc = reference.raised_cosine(0.35)
        return np.stack([reference.interpolatef(p, rc, 10.0, 0.0, 10)
                         for p in (s_re, s_im)])

    return Config("modulation_chain_131k_symbols",
                  pipelines.modulation_chain_planar,
                  (jnp.asarray(s_re), jnp.asarray(s_im)), 10 * n, ref,
                  _stacked_err, 1e-5, 8 * n + 8 * 10 * n)


def cfg5(sizes):
    import jax.numpy as jnp
    from basic_dsp_tpu import reference
    from basic_dsp_tpu.parallel import channelizer

    n, C = sizes["cfg5_n"], sizes["channels"]
    x = complex_signal(n, 4)
    proto = (np.hamming(C * 8) / C).astype(np.float32)

    def fn(x, p):
        return channelizer.channelize_and_demod(x, p, C)

    return Config("channelizer_1024ch_4m", fn,
                  (jnp.asarray(x), jnp.asarray(proto)), n,
                  lambda: reference.channelize_and_demod(x, proto, C),
                  lambda got, want: reference.wrapped_angle_error(
                      got, want[0], want[1]),
                  1e-5, 8 * n + 4 * n)


CONFIGS = (flagship, cfg1, cfg2, cfg3, cfg4, cfg5)


def measure(cfg, sizes, device_kind):
    """Times one configuration; returns its result record."""
    from basic_dsp_tpu import profiling
    t = profiling.time_op(cfg.fn, *cfg.args, iters=sizes["iters"],
                          reps=sizes["reps"])
    floor = profiling.compulsory_floor_s(cfg.floor_bytes, device_kind)
    return {"metric": cfg.metric,
            "value": cfg.samples / t["per_iter_s"] / 1e6,
            "unit": "Msamples/s",
            "measured_ms": t["per_iter_s"] * 1e3,
            "min_ms": t["min_per_iter_s"] * 1e3,
            "max_ms": t["max_per_iter_s"] * 1e3,
            "compile_s": t["compile_s"],
            "compulsory_bytes": cfg.floor_bytes,
            "floor_ms": floor * 1e3,
            "floor_share": floor / t["per_iter_s"]}


def setup():
    """Compile cache, GPU check, peak-table check and card; returns
    (device summary, card string)."""
    from basic_dsp_tpu import profiling
    profiling.enable_compile_cache(ROOT)
    dev = profiling.require_gpu()
    profiling.peaks(dev["kind"])          # an unknown card is an error
    return dev, profiling.card_name_and_power()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--json", type=str, default=None,
                    help="also write the table to FILE")
    args = ap.parse_args(argv)
    dev, card = setup()
    results = []
    for build in CONFIGS:
        rec = measure(build(SIZES), SIZES, dev["kind"])
        rec.update(device=dev, card=card)
        results.append(rec)
        print(json.dumps(rec), flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"device": dev, "card": card, "configs": results}, f,
                      indent=1)
        print(f"# wrote {args.json}", file=sys.stderr)


if __name__ == "__main__":
    main()
