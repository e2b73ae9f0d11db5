"""Size-sweep benchmark tables — port of reference examples/bench_tables.rs
(1e3 -> 1e8 sweep, CSV output for plotting with plot_csv_data.py).

Covers the reference's per-op bench surface (benches/real_bench.rs:14-47,
complex_bench.rs:17-163, time_freq_bench.rs:15-53): real
offset/scale/abs/square/sqrt/root/powf/ln/exp/sin (+_approx variants)/
wrap/unwrap/mul/reverse/swap_halves, the complex elementwise set,
convolve_signal, interpolatei/f, and the plain/windowed FFT round trips.

Measurement discipline is ``profiling.time_op``: the median of warm
reps of an in-jit loop whose full-array fold carry feeds each output back
into the next input, so XLA can neither hoist nor dead-code the body (see
CLAUDE.md measurement traps).

Usage: python bench_tables.py [max_exp] [out.csv] [--with-f64]
"""
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def build_ops():
    """op name -> (needs_aux, fn(x_re, x_im, aux, carry) -> out).

    ``carry`` is an offset added to the input; the timing loop passes 0
    and perturbs the first argument itself (``profiling.time_op``).
    """
    import jax.numpy as jnp

    from basic_dsp_tpu import vector as _vec
    from basic_dsp_tpu.conv_types import SincFunction
    from basic_dsp_tpu.ops import approx_ops, conv_ops, fft_ops, interp_ops

    sinc = SincFunction()

    def cplx(x_re, x_im, carry):
        return (x_re + carry) + 1j * x_im

    ops = {
        # --- real elementwise (real_bench.rs:59-346) ---
        "real_offset": lambda r, i, a, c: (r + c) + 5.0,
        "real_scale": lambda r, i, a, c: (r + c) * 2.0,
        "real_abs": lambda r, i, a, c: jnp.abs(r + c),
        "real_square": lambda r, i, a, c: (r + c) * (r + c),
        "real_sqrt": lambda r, i, a, c: jnp.sqrt(jnp.abs(r + c)),
        "real_root": lambda r, i, a, c: jnp.abs(r + c) ** (1.0 / 3.0),
        "real_powf": lambda r, i, a, c: jnp.abs(r + c) ** 2.5,
        "real_ln": lambda r, i, a, c: jnp.log(jnp.abs(r + c) + 1.0),
        "real_ln_approx":
            lambda r, i, a, c: approx_ops.ln_approx(jnp.abs(r + c) + 1.0),
        "real_exp": lambda r, i, a, c: jnp.exp((r + c) * 1e-3),
        "real_exp_approx":
            lambda r, i, a, c: approx_ops.exp_approx((r + c) * 1e-3),
        "real_sin": lambda r, i, a, c: jnp.sin(r + c),
        "real_sin_approx": lambda r, i, a, c: approx_ops.sin_approx(r + c),
        "real_wrap": lambda r, i, a, c: _vec._fmod(r + c, 8.0),
        "real_unwrap": lambda r, i, a, c: _vec._unwrap(r + c, 8.0),
        "real_mul": lambda r, i, a, c: (r + c) * i,
        "reverse": lambda r, i, a, c: (r + c)[::-1],
        "swap_halves": lambda r, i, a, c: fft_ops.fft_shift(r + c),
        # --- complex elementwise (complex_bench.rs:17-81) ---
        "complex_offset": lambda r, i, a, c: cplx(r, i, c) + (2 + 1j),
        "complex_scale": lambda r, i, a, c: cplx(r, i, c) * (2 + 0.5j),
        "complex_sin": lambda r, i, a, c: jnp.sin(cplx(r, i, c)),
        "complex_conj": lambda r, i, a, c: jnp.conj(cplx(r, i, c)),
        "complex_magnitude": lambda r, i, a, c: jnp.abs(cplx(r, i, c)),
        "complex_mul":
            lambda r, i, a, c: cplx(r, i, c) * (i + 1j * r),
        # --- convolution / interpolation (complex_bench.rs:83-163) ---
        "convolve_signal":
            lambda r, i, a, c: conv_ops.convolve_signal(
                cplx(r, i, c), a[0] + 1j * a[1], True),
        "interpolatei":
            lambda r, i, a, c: interp_ops.interpolatei(
                cplx(r, i, c), sinc, 2, True),
        "interpolatef":
            lambda r, i, a, c: interp_ops.interpolatef(
                cplx(r, i, c), sinc, 1.5, 0.0, 12, 1.0),
        # --- FFT family (time_freq_bench.rs:15-53) ---
        "plain_fft_ifft":
            lambda r, i, a, c: fft_ops.plain_ifft(
                fft_ops.plain_fft(cplx(r, i, c))) / r.shape[-1],
        "window":
            lambda r, i, a, c: cplx(r, i, c) * a[0],
        "fft_ifft":
            lambda r, i, a, c: fft_ops.ifft_shifted(
                fft_ops.fft_shifted(cplx(r, i, c))),
    }
    return ops


def main(max_exp=7, out_path="bench_tables.csv", with_f64=False):
    import jax.numpy as jnp

    from basic_dsp_tpu import profiling
    from basic_dsp_tpu.windows import HammingWindow
    import basic_dsp_tpu as bd

    rng = np.random.default_rng(0)
    ops = build_ops()
    rows = ["op,size,msamples_per_s,us_per_call"]
    for exp in range(3, max_exp + 1):
        n = 10 ** exp
        x_re = jnp.asarray(rng.normal(size=n).astype(np.float32))
        x_im = jnp.asarray(rng.normal(size=n).astype(np.float32))
        h = (jnp.asarray(rng.normal(size=32).astype(np.float32)),
             jnp.asarray(rng.normal(size=32).astype(np.float32)))
        win = HammingWindow().sample(n)
        iters = max(3, min(30, 10 ** 7 // n))
        for name, body in ops.items():
            if name in ("convolve_signal", "interpolatei", "interpolatef") \
                    and n > 10 ** 7:
                continue  # shape-changing/conv ops: cap the sweep
            aux = h if name == "convolve_signal" else (win, win)

            def fn(r, i, a1, a2, body=body):
                return body(r, i, (a1, a2), 0.0)

            try:
                sec = profiling.time_op(fn, x_re, x_im, aux[0], aux[1],
                                        iters=iters)["per_iter_s"]
            except Exception as e:  # geometry misfit etc.: record, move on
                print(f"{name}, {n}: SKIP ({type(e).__name__})", flush=True)
                continue
            rows.append(f"{name},{n},{n / sec / 1e6:.1f},{sec * 1e6:.2f}")
            print(rows[-1], flush=True)
        # vector_creation (real_bench.rs:59-65): host construction cost
        t0 = time.perf_counter()
        reps = max(1, 10 ** 6 // n)
        for _ in range(reps):
            bd.to_real_time_vec(np.zeros(n, np.float32))
        dt = (time.perf_counter() - t0) / reps
        rows.append(f"vector_creation,{n},{n / dt / 1e6:.1f},{dt * 1e6:.2f}")
        print(rows[-1], flush=True)
        if with_f64:
            # the reference benches the 64-bit flavors of offset and sin
            # (real_bench.rs:100-110, 337-346)
            from basic_dsp_tpu import config as _cfg
            _cfg.enable_x64()
            x64 = jnp.asarray(rng.normal(size=n))
            for name, body in (("real_offset_f64",
                                lambda r, i, a, c: (r + c) + 5.0),
                               ("real_sin_f64",
                                lambda r, i, a, c: jnp.sin(r + c))):
                sec = profiling.time_op(
                    lambda r, i, a, body=body: body(r, i, a, 0.0),
                    x64, x64, win, iters=iters)["per_iter_s"]
                rows.append(
                    f"{name},{n},{n / sec / 1e6:.1f},{sec * 1e6:.2f}")
                print(rows[-1], flush=True)
    with open(out_path, "w") as f:
        f.write("\n".join(rows) + "\n")
    print(f"wrote {out_path}")


if __name__ == "__main__":
    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    max_exp = int(args[0]) if args else 7
    out = args[1] if len(args) > 1 else "bench_tables.csv"
    main(max_exp, out, with_f64="--with-f64" in sys.argv)
