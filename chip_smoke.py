"""On-card proof that the DSP chains run on an NVIDIA GPU.

Usage (from the root of the checkout, on a machine with a GPU):

    python chip_smoke.py          # one card: main path, accuracy, plain-path
                                  # timings, f64
    python chip_smoke.py --four   # four cards of one host: the sharded
                                  # layer against the same ops on one card

Every phase runs at the sizes of BASELINE.md (4M-sample signals, 1024
channels), compares each result once with the numpy float64 reference in
``basic_dsp_tpu.reference`` and prints its error beside its tolerance;
timings are printed with the card's name and power limit.  The script
refuses to run without a GPU, runs in one process, and exits non-zero if
any phase failed.  The last line of a passing run is one JSON object that
names the devices JAX used.
"""
import argparse
import json
import os
import sys
import time
import traceback

import numpy as np

import bench_all
from bench_all import ROOT, complex_signal, rc_taps

# Full sizes: the bench_all configurations plus this script's own cases.
SIZES = dict(bench_all.SIZES, os_n=1 << 22, os_taps=384, os_fft_len=4096,
             f64_n=1 << 20, four_n=1 << 24, four_interp_n=1 << 22,
             four_mat_n=1 << 20, four_mat_channels=8)

PHASES_ONE = ("main", "accuracy", "plain", "f64")
PHASES_FOUR = ("sharded",)


def phases_for(four: bool):
    """Phases one run executes: ``--four`` runs the sharded path only."""
    return PHASES_FOUR if four else PHASES_ONE


def last_line(dev) -> str:
    """The closing JSON line of a passing run."""
    return json.dumps({"ok": True, "device": {
        "platform": dev["platform"], "kind": dev["kind"],
        "count": dev["count"]}})


class Report:
    """Collects the pass/fail verdict of every check across phases."""

    def __init__(self, card: str, device_kind: str):
        self.card = card
        self.device_kind = device_kind
        self.failed = []

    def check(self, name: str, err: float, tol: float) -> None:
        ok = bool(np.isfinite(err) and err <= tol)
        print(f"  {name}: max rel err {err:.3e} (tolerance {tol:.0e}) "
              f"{'OK' if ok else 'FAIL'}", flush=True)
        if not ok:
            self.failed.append(name)

    def timing(self, name: str, t: dict, samples: int,
               floor_bytes: float = 0.0) -> None:
        from basic_dsp_tpu import profiling
        ms = t["per_iter_s"] * 1e3
        line = (f"  {name}: {ms:.4f} ms/iter (min {t['min_per_iter_s']*1e3:.4f}"
                f", max {t['max_per_iter_s']*1e3:.4f}), "
                f"{samples / t['per_iter_s'] / 1e6:.1f} Msamples/s")
        if floor_bytes:
            floor = profiling.compulsory_floor_s(floor_bytes,
                                                 self.device_kind)
            line += (f", compulsory-bytes floor {floor * 1e3:.4f} ms "
                     f"({floor_bytes / 1e6:.1f} MB), floor share "
                     f"{floor / t['per_iter_s']:.3f}")
        line += f", compile {t['compile_s']:.1f} s [{self.card}]"
        print(line, flush=True)


def _memory(fn, args) -> str:
    import jax
    ma = jax.jit(fn).lower(*args).compile().memory_analysis()
    if ma is None:
        return "memory_analysis: not available"
    fields = ("argument_size_in_bytes", "output_size_in_bytes",
              "temp_size_in_bytes", "generated_code_size_in_bytes")
    return "memory_analysis: " + ", ".join(
        f"{f.replace('_size_in_bytes', '')} {getattr(ma, f, 0) / 2**20:.1f}"
        f" MiB" for f in fields)


def phase_main(report, sizes, state):
    """Flagship + configs 1-5: compile, memory, one reference check,
    timing."""
    import jax
    from basic_dsp_tpu import profiling

    print("# phase main: flagship and configs 1-5", flush=True)
    for build in bench_all.CONFIGS:
        name = build.__name__
        try:
            cfg = build(sizes)
            name = f"{build.__name__} {cfg.metric}"
            print(f" {name}", flush=True)
            print(f"  {_memory(cfg.fn, cfg.args)}", flush=True)
            got = jax.tree_util.tree_map(np.asarray,
                                         jax.jit(cfg.fn)(*cfg.args))
            want = cfg.ref()
            if build is bench_all.flagship:
                state["flagship"] = (cfg.fn, cfg.args, want)
            report.check(name, cfg.err(got, want), cfg.tol)
            t = profiling.time_op(cfg.fn, *cfg.args, iters=sizes["iters"],
                                  reps=sizes["reps"])
            report.timing(name, t, cfg.samples, cfg.floor_bytes)
        except Exception:
            traceback.print_exc()
            report.failed.append(name)
    stats = jax.devices()[0].memory_stats() or {}
    print(f"  peak_bytes_in_use {stats.get('peak_bytes_in_use', 0) / 2**20:.1f}"
          f" MiB [{report.card}]", flush=True)


def _interp_case(report, name, factor, n, delay=0.0, conv_len=10,
                 cplx=True, seed=42):
    import basic_dsp_tpu as bd
    from basic_dsp_tpu import reference
    r = np.random.default_rng(seed)
    re = r.normal(size=n).astype(np.float32)
    if cplx:
        im = r.normal(size=n).astype(np.float32)
        v = bd.interleave_to_complex_time_vec(re, im)
        x = re.astype(np.complex128) + 1j * im
    else:
        v = bd.to_real_time_vec(re)
        x = re.astype(np.float64)
    got = v.interpolatef(bd.SincFunction(), factor, delay,
                         conv_len).to_numpy()
    want = reference.interpolatef(x, reference.sinc, factor, delay,
                                  conv_len)
    report.check(f"interpolatef {name}", reference.max_rel_err(got, want),
                 2e-4)


def phase_accuracy(report, sizes, state):
    """Public-API accuracy at precision "highest", then the flagship under
    the "high" and "default" matmul-precision dial."""
    import jax
    import basic_dsp_tpu as bd
    from basic_dsp_tpu import profiling, reference

    print("# phase accuracy: precision 'highest'", flush=True)
    cases = [("rational 1.5x complex", 1.5, 300, {}),
             ("integer 2x complex", 2.0, 256, {}),
             ("integer 4x real", 4.0, 250, {"cplx": False}),
             ("rational 1.5x real", 1.5, 200, {"cplx": False}),
             ("tiny n=8 (gather path)", 1.5, 8, {}),
             ("64/63 (gate fallback)", 64 / 63, 63 * 16, {}),
             ("delay=0.25 rational 1.5x", 1.5, 300, {"delay": 0.25}),
             ("fractional 0.77x (gather path)", 0.77, 300, {}),
             ("4/3", 4 / 3, 300, {}),
             ("rational 1.5x real 64k (banded matmul)", 1.5, 1 << 16,
              {"cplx": False})]
    for name, factor, n, kw in cases:
        _interp_case(report, name, factor, n, **kw)
    r = np.random.default_rng(7)
    n, m = 3000, 31
    x = complex_signal(n, 8)
    h = (r.normal(size=m) + 1j * r.normal(size=m)).astype(np.complex64)
    got = bd.to_complex_time_vec(x).convolve_signal(
        bd.to_complex_time_vec(h)).to_numpy()
    report.check("convolve_signal toeplitz 3000 x 31 taps",
                 reference.max_rel_err(
                     got, reference.convolve_circular_centered(x, h)), 1e-5)

    if "flagship" not in state:
        report.failed.append("precision dial (no flagship result)")
        return
    fn, args, want = state["flagship"]
    print("# precision dial on the flagship chain", flush=True)
    try:
        for prec in ("high", "default"):
            bd.set_matmul_precision(prec)
            jax.clear_caches()
            got = np.asarray(jax.jit(fn)(*args))
            err = reference.max_rel_err(got, want)
            t = profiling.time_op(fn, *args, iters=sizes["iters"],
                                  reps=sizes["reps"])
            print(f"  flagship at precision {prec!r}: max rel err "
                  f"{err:.3e}", flush=True)
            report.timing(f"flagship at precision {prec!r}", t,
                          sizes["flagship_n"])
    finally:
        bd.set_matmul_precision("highest")
        jax.clear_caches()


def phase_plain(report, sizes, state):
    """Plain XLA paths that replaced the retired kernels: time each and
    print its share of the compulsory-bytes floor; then the autotune
    calibration."""
    import jax
    import jax.numpy as jnp
    from basic_dsp_tpu import autotune, profiling, reference
    from basic_dsp_tpu.ops import conv_ops, fourstep

    print("# phase plain: XLA paths of the retired kernels", flush=True)
    n = sizes["flagship_n"]
    x = complex_signal(n, 5)
    xd = jnp.asarray(x)
    want = reference.shifted_spectrum_mag(x)

    def cufft_mag(z):
        return jnp.abs(jnp.fft.fftshift(jnp.fft.fft(z)))

    for name, fn in (("four-step dif_spectrum_mag 4M c64",
                      fourstep.dif_spectrum_mag),
                     ("cuFFT |fftshift(fft)| 4M c64", cufft_mag)):
        try:
            report.check(name, reference.max_rel_err(
                np.asarray(jax.jit(fn)(xd)), want), 1e-5)
            report.timing(name, profiling.time_op(
                fn, xd, iters=sizes["iters"], reps=sizes["reps"]), n,
                8 * n + 4 * n)
        except Exception:
            traceback.print_exc()
            report.failed.append(name)

    name = "overlap_save 4M c64 x 384 taps, fft_len 4096"
    try:
        no, mo, fl = sizes["os_n"], sizes["os_taps"], sizes["os_fft_len"]
        xo = complex_signal(no, 6)
        ho = complex_signal(mo, 7) / mo

        def osave(z, h):
            return conv_ops.overlap_save(z, h, True, fl)

        args = (jnp.asarray(xo), jnp.asarray(ho))
        report.check(name, reference.max_rel_err(
            np.asarray(jax.jit(osave)(*args)),
            reference.convolve_circular_centered(xo, ho)), 1e-5)
        report.timing(name, profiling.time_op(
            osave, *args, iters=sizes["iters"], reps=sizes["reps"]), no,
            16 * no)
    except Exception:
        traceback.print_exc()
        report.failed.append(name)
    print("  (cfg3 resampler and cfg5 channelizer: floor shares in phase "
          "main)", flush=True)

    print("# autotune calibration on this device", flush=True)
    try:
        entry = autotune.calibrate()
        print(f"  chose fft_block_len {entry['fft_block_len']}, "
              f"direct_conv_max_imp_len {entry['direct_conv_max_imp_len']}"
              f" [{report.card}]", flush=True)
        autotune.print_calibration()
    except Exception:
        traceback.print_exc()
        report.failed.append("autotune")


def phase_f64(report, sizes, state):
    """complex128/float64 flavors on the card against numpy at 1e-9."""
    import basic_dsp_tpu as bd
    from basic_dsp_tpu import reference

    print("# phase f64", flush=True)
    bd.enable_x64()
    n = sizes["f64_n"]
    r = np.random.default_rng(9)
    z = r.normal(size=n) + 1j * r.normal(size=n)
    got = bd.to_complex_time_vec(z).plain_fft().to_numpy()
    if got.dtype != np.complex128:
        report.failed.append(f"f64 plain_fft dtype {got.dtype}")
    report.check("c128 plain_fft 1M", reference.max_rel_err(
        got, np.fft.fft(z)), 1e-9)
    h = r.normal(size=128) + 1j * r.normal(size=128)
    got = bd.to_complex_time_vec(z).convolve_signal(
        bd.to_complex_time_vec(h)).to_numpy()
    report.check("c128 convolve_signal 1M x 128 taps", reference.max_rel_err(
        got, reference.convolve_circular_centered(z, h)), 1e-9)
    xr = r.normal(size=n) * 10.0 + 3.0
    st = bd.to_real_time_vec(xr).statistics()
    want = np.array([xr.sum(), xr.mean(), np.sqrt(np.mean(xr ** 2)),
                     xr.min(), xr.max()])
    got = np.array([st.sum, st.average, st.rms, st.min, st.max],
                   np.float64)
    report.check("f64 statistics 1M", reference.max_rel_err(got, want),
                 1e-9)


def phase_sharded(report, sizes, state):
    """The sharded layer on a 1-D mesh of four devices against the same
    op on one device."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    from basic_dsp_tpu import config, matrix, reference
    from basic_dsp_tpu.conv_types import SincFunction
    from basic_dsp_tpu.ops import conv_ops, interp_ops, stats_ops
    from basic_dsp_tpu.parallel import (channelizer, sharded_convolve_mat,
                                        sharded_convolve_signal,
                                        sharded_fft, sharded_interpolatef,
                                        sharded_statistics, shard_time_axis)

    print("# phase sharded: 1-D mesh of 4 devices", flush=True)
    mesh = config.make_mesh(4)
    one = jax.devices()[0]
    n = sizes["four_n"]
    x = complex_signal(n, 10)
    x1 = jax.device_put(x, one)
    xs = shard_time_axis(jnp.asarray(x), mesh)
    taps = rc_taps(sizes["fir_taps"]).astype(np.complex64)
    C = sizes["channels"]
    proto = jnp.asarray((np.hamming(C * 8) / C).astype(np.float32))
    ni = sizes["four_interp_n"]
    xi = complex_signal(ni, 11)
    xis = shard_time_axis(jnp.asarray(xi), mesh)
    Cm, nm = sizes["four_mat_channels"], sizes["four_mat_n"]
    xm = np.stack([complex_signal(nm, 20 + c) for c in range(Cm)])
    imp = np.random.default_rng(12).normal(size=(Cm, Cm, 5)).astype(np.float32)
    xms = jax.device_put(xm, NamedSharding(mesh, P(mesh.axis_names[0],
                                                   None)))
    cases = [
        ("sharded_convolve_signal 16M c64, 128 taps",
         lambda: sharded_convolve_signal(xs, jnp.asarray(taps), mesh),
         lambda: conv_ops.convolve_signal(x1, jax.device_put(taps, one),
                                          True)),
        ("sharded_fft 16M c64",
         lambda: sharded_fft.sharded_fft(xs, mesh),
         lambda: jnp.fft.fft(x1)),
        ("sharded_channelize_and_demod 16M, 1024 ch",
         lambda: channelizer.sharded_channelize_and_demod(
             jnp.asarray(x), proto, C, mesh),
         lambda: channelizer.channelize_and_demod(
             x1, jax.device_put(proto, one), C)),
        ("sharded_interpolatef x1.5 4M c64",
         lambda: sharded_interpolatef(xis, SincFunction(), 1.5, 0.0, 10,
                                      mesh),
         lambda: interp_ops.interpolatef(jax.device_put(xi, one),
                                         SincFunction(), 1.5, 0.0, 10,
                                         1.0)),
        ("sharded_convolve_mat 8 ch x 1M c64, 5 taps",
         lambda: sharded_convolve_mat(xms, imp, mesh),
         lambda: matrix._convolve_mat(jax.device_put(xm, one),
                                      jax.device_put(imp, one), True)),
    ]
    for name, sharded, single in cases:
        try:
            t0 = time.perf_counter()
            got = sharded()
            got.block_until_ready()
            t_sh = time.perf_counter() - t0
            devs = sorted(d.id for d in got.devices())
            want = single()
            print(f"  {name}: output on devices {devs}, one-device result "
                  f"on {sorted(d.id for d in want.devices())}; first call "
                  f"incl. compile {t_sh:.1f} s", flush=True)
            if len(devs) != 4:
                report.failed.append(f"{name}: output on {devs}")
            if "channelize" in name:
                # Angles: compare both against the float64 definition,
                # weighted by |z| (reference.wrapped_angle_error).
                ang, amp = reference.channelize_and_demod(
                    x, np.asarray(proto), C)
                report.check(name, reference.wrapped_angle_error(
                    np.asarray(got), ang, amp), 1e-5)
                report.check(name + " (one device)",
                             reference.wrapped_angle_error(
                                 np.asarray(want), ang, amp), 1e-5)
            else:
                report.check(name, reference.max_rel_err(
                    np.asarray(got), np.asarray(want)), 1e-5)
        except Exception:
            traceback.print_exc()
            report.failed.append(name)
    name = "sharded_statistics 16M c64"
    try:
        st = sharded_statistics(xs, mesh)
        st1 = stats_ops.statistics(x1, True)
        got = np.array([st.sum, st.rms, st.min, st.max], np.complex128)
        want = np.array([st1.sum, st1.rms, st1.min, st1.max], np.complex128)
        print(f"  {name}: sharded sum {st.sum}, single {st1.sum}",
              flush=True)
        report.check(name, reference.max_rel_err(got, want), 1e-5)
    except Exception:
        traceback.print_exc()
        report.failed.append(name)


PHASE_FUNCS = {"main": phase_main, "accuracy": phase_accuracy,
               "plain": phase_plain, "f64": phase_f64,
               "sharded": phase_sharded}


def run(four: bool, sizes=None) -> int:
    """Runs the phases; returns the process exit code."""
    import jax
    from basic_dsp_tpu import profiling

    cache = profiling.enable_compile_cache(ROOT)
    dev = profiling.require_gpu()
    # Any calibration (explicit in phase plain, lazy on a large
    # convolve_signal) persists inside the checkout.
    os.environ.setdefault("BDSP_AUTOTUNE_CACHE", os.path.join(
        ROOT, "chiprun_out", "autotune.json"))
    profiling.peaks(dev["kind"])          # an unknown card is an error
    card = profiling.card_name_and_power()
    print(f"# device: platform {dev['platform']}, device_kind "
          f"{dev['kind']!r}, count {dev['count']}", flush=True)
    print("# card (nvidia-smi --query-gpu=name,power.limit):", flush=True)
    print(card, flush=True)
    print(f"# peaks: {profiling.PEAKS_SOURCE}", flush=True)
    print(f"# compile cache: {cache}", flush=True)
    if four and dev["count"] < 4:
        raise RuntimeError(f"--four needs 4 devices, JAX sees "
                           f"{dev['count']}")
    report = Report(card, dev["kind"])
    state = {}
    t0 = time.perf_counter()
    for ph in phases_for(four):
        try:
            PHASE_FUNCS[ph](report, sizes or SIZES, state)
        except Exception:
            traceback.print_exc()
            report.failed.append(f"phase {ph}")
    print(f"# wall time {time.perf_counter() - t0:.1f} s", flush=True)
    if report.failed:
        print("# FAILED: " + "; ".join(report.failed), flush=True)
        return 1
    print(last_line(dev), flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the sharded path on four devices")
    args = ap.parse_args(argv)
    return run(args.four)


if __name__ == "__main__":
    sys.exit(main())
