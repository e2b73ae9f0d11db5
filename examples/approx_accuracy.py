"""Accuracy of the fast-math family — port of reference
examples/approx_accuracy.rs.

The reference compares its SIMD polynomial approximations (`sin_approx`,
`ln_approx`, ... from simd_extensions/approximations.rs) against the exact
functions and prints per-sample error rows in plot_csv_data.py format.
Here the `*_approx` family evaluates through f32 XLA transcendentals, and
the example additionally reports the matmul-precision dial
(`bd.set_matmul_precision`) on a FIR — the same exact-vs-fast trade on
the matrix units.

Usage: python approx_accuracy.py          # CSV rows to stdout, maxima to stderr
"""
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import basic_dsp_tpu as bd


def print_diff(name, is_relative, x_vec, std_func, approx_func):
    should = std_func(x_vec)
    is_ = approx_func(x_vec)
    diff = should.sub(is_).abs()
    if is_relative:
        diff = diff.div(x_vec)
    row = diff.to_numpy()
    print(f"{name}, " + ", ".join(str(v) for v in row) + ", ")
    print(f"{name} max, {diff.statistics().max}", file=sys.stderr)


def main():
    bd.enable_x64()
    x_delta = 1e-3
    n = 10_000
    xs = x_delta * np.arange(1, n + 1)
    print("X, " + ", ".join(str(v) for v in xs) + ", ")
    x_vec = bd.to_real_time_vec(xs)

    print_diff("Sin", False, x_vec, lambda v: v.sin(),
               lambda v: v.sin_approx())
    print_diff("Cos", False, x_vec, lambda v: v.cos(),
               lambda v: v.cos_approx())
    print_diff("Ln", True, x_vec, lambda v: v.ln(), lambda v: v.ln_approx())
    print_diff("Exp", True, x_vec, lambda v: v.exp(),
               lambda v: v.exp_approx())
    print_diff("Log2", True, x_vec, lambda v: v.log(2.0),
               lambda v: v.log_approx(2.0))
    print_diff("Expf2", True, x_vec, lambda v: v.expf(2.0),
               lambda v: v.expf_approx(2.0))
    print_diff("Powf2", True, x_vec, lambda v: v.powf(2.0),
               lambda v: v.powf_approx(2.0))

    # The matmul dial: same FIR at every precision tier vs the exact
    # default.
    rng = np.random.default_rng(0)
    # f32 on purpose: the dial only matters for f32 contractions (f64
    # matmuls ignore the precision tiers).
    sig = bd.to_real_time_vec(rng.normal(size=4096).astype(np.float32))
    taps = bd.to_real_time_vec(
        np.sinc(np.linspace(-4, 4, 33)).astype(np.float32))
    exact = sig.convolve_signal(taps).to_numpy()
    for tier in ("high", "default"):
        bd.set_matmul_precision(tier)
        err = np.abs(sig.convolve_signal(taps).to_numpy() - exact).max()
        print(f"FIR matmul precision={tier} max abs err, {err}",
              file=sys.stderr)
    bd.set_matmul_precision("highest")


if __name__ == "__main__":
    main()
