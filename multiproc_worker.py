"""Multi-process worker: one simulated HOST of the (host, device) mesh.

Launched by bench_multihost.py as N separate OS processes, each owning
``local_devices`` XLA CPU devices; ``jax.distributed.initialize`` joins
them into one runtime whose global device list spans every process —
collectives on the mesh's host axis genuinely cross a process boundary,
which the single-process virtual meshes of the test suite cannot show.

Every sharded op's equality check runs against the single-device oracle
computed locally from the same seeded input.  Worker 0 prints one JSON
line with the results; bench_multihost.py collects it.
"""
import json
import sys
import time

import jax

jax.config.update("jax_platforms", "cpu")


def main():
    pid = int(sys.argv[1])
    nproc = int(sys.argv[2])
    port = int(sys.argv[3])
    local_devices = int(sys.argv[4])
    n = int(sys.argv[5]) if len(sys.argv) > 5 else 1 << 16
    jax.config.update("jax_num_cpu_devices", local_devices)
    jax.distributed.initialize(coordinator_address=f"localhost:{port}",
                               num_processes=nproc, process_id=pid)

    import jax.numpy as jnp
    import numpy as np
    from jax.experimental import multihost_utils

    from basic_dsp_tpu import config as bd_config
    from basic_dsp_tpu.conv_types import SincFunction
    from basic_dsp_tpu.ops import conv_ops, interp_ops, stats_ops
    from basic_dsp_tpu.parallel import (channelizer, sharded_convolve_signal,
                                        sharded_fft, sharded_interpolatef,
                                        sharded_statistics, shard_time_axis)

    assert len(jax.devices()) == nproc * local_devices
    assert len(jax.local_devices()) == local_devices
    # The (host, chip) mesh: the host axis IS the process boundary.
    mesh = bd_config.make_mesh(shape=(nproc, local_devices))

    rng = np.random.default_rng(0)  # same seed everywhere: identical input
    x = jnp.asarray((rng.normal(size=n) + 1j * rng.normal(size=n))
                    .astype(np.complex64))
    h = jnp.asarray((rng.normal(size=31) + 1j * rng.normal(size=31))
                    .astype(np.complex64))
    xs = shard_time_axis(x, mesh)

    checks = {}

    def gather(a):
        return multihost_utils.process_allgather(a, tiled=True)

    # 1) sequence-parallel FIR with cross-process halo exchange
    out = sharded_convolve_signal(xs, h, mesh)
    ref = conv_ops.convolve_signal_fft(x, h, True)
    err = float(np.max(np.abs(gather(out) - np.asarray(ref))))
    scale = float(np.max(np.abs(np.asarray(ref))))
    checks["sharded_convolve_signal"] = {"max_abs_err": err,
                                         "ok": err < 1e-4 * max(scale, 1)}

    # 2) collective statistics (psum across the process boundary)
    st = sharded_statistics(xs, mesh)
    oracle = stats_ops.statistics(x, True)
    checks["sharded_statistics"] = {
        "ok": bool(st.count == oracle.count
                   and abs(complex(st.sum) - complex(oracle.sum))
                   < 1e-3 * max(abs(complex(oracle.sum)), 1)
                   and abs(complex(st.rms) - complex(oracle.rms))
                   < 1e-4 * abs(complex(oracle.rms)))}

    # 3) distributed four-step FFT (all_to_all reshard crosses processes)
    spec = sharded_fft.sharded_fft(xs, mesh)
    want = np.fft.fft(np.asarray(x))
    errf = float(np.max(np.abs(gather(spec) - want)))
    checks["sharded_fft"] = {"max_abs_err": errf,
                             "ok": errf < 1e-2 * float(np.max(np.abs(want)))}

    # 4) sequence-parallel fractional resampler
    res = sharded_interpolatef(xs, SincFunction(), 1.5, 0.0, 10, mesh)
    refr = interp_ops.interpolatef(x, SincFunction(), 1.5, 0.0, 10, 1.0)
    erri = float(np.max(np.abs(gather(res) - np.asarray(refr))))
    checks["sharded_interpolatef"] = {
        "max_abs_err": erri,
        "ok": erri < 1e-3 * float(np.max(np.abs(np.asarray(refr))))}

    # 5) channel-parallel channelizer + FM demod
    C = 8
    proto = jnp.asarray((np.hamming(C * 8) / C).astype(np.float32))
    dem = channelizer.sharded_channelize_and_demod(x, proto, C, mesh)
    demr = channelizer.channelize_and_demod(x, proto, C)
    errc = float(np.max(np.abs(gather(dem) - np.asarray(demr))))
    checks["sharded_channelizer"] = {"max_abs_err": errc, "ok": errc < 1e-3}

    # 6) measured cross-process scaling point: per-call time of the
    # sharded FIR on the full (nproc x local) mesh.  Barrier first so
    # every process times the same steady-state window.
    multihost_utils.sync_global_devices("bench_start")
    iters = 20
    outb = sharded_convolve_signal(xs, h, mesh)
    outb.block_until_ready()
    t0 = time.perf_counter()
    for _ in range(iters):
        outb = sharded_convolve_signal(xs, h, mesh)
    outb.block_until_ready()
    mp_ms = (time.perf_counter() - t0) / iters * 1e3

    # single-process baseline on THIS process's local devices only
    local_mesh = jax.sharding.Mesh(np.array(jax.local_devices()), ("dsp",))
    xl = shard_time_axis(x, local_mesh)
    outl = sharded_convolve_signal(xl, h, local_mesh)
    outl.block_until_ready()
    t0 = time.perf_counter()
    for _ in range(iters):
        outl = sharded_convolve_signal(xl, h, local_mesh)
    outl.block_until_ready()
    sp_ms = (time.perf_counter() - t0) / iters * 1e3

    result = {
        "ok": all(c["ok"] for c in checks.values()),
        "n_processes": nproc,
        "local_devices_per_process": local_devices,
        "global_devices": len(jax.devices()),
        "signal_len": n,
        "checks": checks,
        "timing": {
            "sharded_fir_2proc_ms": round(mp_ms, 3),
            "sharded_fir_1proc_local_ms": round(sp_ms, 3),
            "note": "same global problem size; the 2-proc mesh adds a "
                    "genuine cross-process halo handoff — "
                    "on shared-core CPU hosts this measures overhead "
                    "structure, not a speedup",
        },
    }
    multihost_utils.sync_global_devices("bench_end")
    if pid == 0:
        print("MULTIHOST_RESULT " + json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
