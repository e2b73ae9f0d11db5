"""Compares the resamplers — port of reference
examples/interpolatef_vs_interpolate.py (which drives the C ABI from
Python and plots; here the native Python API is the surface).

Three routes to the same 2x upsample of a windowed tone burst:

* ``interpolatef`` — time-domain convolution against an analytic sinc
  (reference interpolation.rs:387-482; the banded-matmul polyphase path),
* ``interpolate`` / ``interpft`` — FFT zero-pad resampling
  (interpolation.rs:542-605),
* ``scipy.signal.resample`` — the numpy-ecosystem baseline.

Writes CSV rows (plot with the reference's plot_csv_data.py or any CSV
tool) and prints max deviations between the routes.

Usage: python interpolatef_vs_interpolate.py [out.csv]
"""
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import basic_dsp_tpu as bd


def main(out_path=None):
    n = 512
    t = np.arange(n)
    burst = (np.sin(2 * np.pi * 0.03 * t)
             * np.hanning(n)).astype(np.float32)
    v = bd.to_real_time_vec(burst)

    time_domain = v.interpolatef(bd.SincFunction(), 2.0, 0.0, 32).to_numpy()
    freq_domain = v.interpft(2 * n).to_numpy()

    from scipy import signal
    scipy_out = signal.resample(burst, 2 * n)

    d_tf = np.abs(time_domain - freq_domain).max()
    d_fs = np.abs(freq_domain - scipy_out).max()
    print(f"interpolatef vs interpft   max diff: {d_tf:.3e}")
    print(f"interpft     vs scipy      max diff: {d_fs:.3e}")

    rows = [("X", np.arange(2 * n) / 2.0),
            ("interpolatef", time_domain),
            ("interpft", freq_domain),
            ("scipy_resample", scipy_out)]
    lines = [name + ", " + ", ".join(str(float(x)) for x in arr) + ", "
             for name, arr in rows]
    if out_path:
        with open(out_path, "w") as f:
            f.write("\n".join(lines) + "\n")
        print(f"wrote {out_path}")
    else:
        print("\n".join(line[:120] + "..." for line in lines))


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else None)
