"""Timing, device peaks and profiling helpers — the observability subsystem.

The reference has only ``print_calibration`` and bench harnesses
(SURVEY.md §5).  This module is the one timing harness of the repository
(``bench.py``, ``bench_all.py`` and ``chip_smoke.py`` all use it), the one
table of device peaks, and a thin wrapper over the jax profiler.

Timing discipline: compile and warm every shape first, then time reps that
each end in ``block_until_ready`` and report the median.  Each rep runs the
op ``iters`` times inside one ``lax.fori_loop`` whose ARRAY carry folds
every output element back into the next iteration's input: a partial read
(``out.ravel()[:1]``) lets XLA slice-propagate through matmul-only bodies
and dead-code most of the work, and an un-fed-back carry lets XLA hoist the
loop-invariant body out of the loop.
"""
from __future__ import annotations

import contextlib
import os
import statistics
import subprocess
import time
from typing import Callable, Dict

import jax
import jax.numpy as jnp

# Published peaks keyed by ``jax.devices()[0].device_kind``.  Source:
# NVIDIA H100 Tensor Core GPU data sheet, SXM5 column, dense rates without
# sparsity, at the card's full 700 W power limit.  A device that is not in
# the table is an error, not a default.
PEAKS: Dict[str, Dict[str, float]] = {
    "NVIDIA H100 80GB HBM3": {
        "hbm_bytes_per_s": 3.35e12,
        "f32_flops": 67e12,
        "tf32_flops": 495e12,
        "bf16_flops": 989e12,
    },
}
PEAKS_SOURCE = ("NVIDIA H100 data sheet, SXM5, dense, 700 W: "
                "3.35 TB/s HBM, 67 TFLOP/s f32, 495 TF32, 989 bf16")


def peaks(device_kind: str) -> Dict[str, float]:
    """The published peaks of ``device_kind``; raises KeyError for a
    device the table does not know."""
    try:
        return PEAKS[device_kind]
    except KeyError:
        raise KeyError(f"no peak table entry for device_kind "
                       f"{device_kind!r}; add its data-sheet row to "
                       f"profiling.PEAKS") from None


def compulsory_floor_s(nbytes: float, device_kind: str) -> float:
    """Least time to move ``nbytes`` (the op's compulsory input reads plus
    output writes) at the device's published HBM peak."""
    return nbytes / peaks(device_kind)["hbm_bytes_per_s"]


def compile_cache_dir(checkout: str) -> str:
    """``JAX_COMPILATION_CACHE_DIR`` when set, else ``<checkout>/.jax_cache``
    — a fixed path, since the path is part of the cache's key."""
    return (os.environ.get("JAX_COMPILATION_CACHE_DIR")
            or os.path.join(checkout, ".jax_cache"))


def enable_compile_cache(checkout: str) -> str:
    """Points JAX's persistent compilation cache at
    :func:`compile_cache_dir` and returns the directory."""
    path = compile_cache_dir(checkout)
    jax.config.update("jax_compilation_cache_dir", path)
    return path


def card_name_and_power() -> str:
    """``name, power.limit`` of the card as ``nvidia-smi`` reports it (a
    child process that does not import JAX)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


def device_summary() -> Dict[str, object]:
    """platform, device_kind and count of the devices JAX uses."""
    devs = jax.devices()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def require_gpu() -> Dict[str, object]:
    """The device summary; raises unless JAX runs on a GPU (a measurement
    never falls back to the CPU)."""
    dev = device_summary()
    if dev["platform"] != "gpu":
        raise RuntimeError(f"no GPU: JAX runs on {dev['platform']!r}")
    return dev


def _fold(out, n: int):
    """(n,) f32 carry that depends on every element of ``out`` (a pytree
    of arrays)."""
    acc = jnp.zeros((n,), jnp.float32)
    for leaf in jax.tree_util.tree_leaves(out):
        flat = jnp.abs(leaf.ravel()).astype(jnp.float32)
        rows = -(-flat.shape[0] // n)
        flat = jnp.pad(flat, (0, rows * n - flat.shape[0]))
        acc = acc + jnp.sum(flat.reshape(rows, n), axis=0)
    return acc * jnp.float32(1e-20)


def time_op(fn: Callable, *args, iters: int = 10,
            reps: int = 5) -> Dict[str, float]:
    """Times ``fn(*args)``: median over ``reps`` of a ``block_until_ready``
    run of ``iters`` chained calls, compile and warm-up excluded.

    The carry perturbs the first argument (``args[0]``, whose last axis
    sets the carry length) by a factor that is 1 to f32 rounding, so every
    iteration depends on the previous one's full output."""
    x0 = args[0]
    n = int(x0.shape[-1]) if x0.ndim else 1

    @jax.jit
    def looped(*a):
        def step(_, carry):
            scale = (1.0 + carry * 1e-10).astype(a[0].real.dtype)
            return _fold(fn(a[0] * scale, *a[1:]), n)

        return jax.lax.fori_loop(0, iters, step,
                                 jnp.zeros((n,), jnp.float32))

    t0 = time.perf_counter()
    looped(*args).block_until_ready()        # compile + first run
    compile_s = time.perf_counter() - t0
    looped(*args).block_until_ready()        # warm
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        looped(*args).block_until_ready()
        times.append(time.perf_counter() - t0)
    med = statistics.median(times)
    return {"per_iter_s": med / iters, "total_s": med,
            "min_per_iter_s": min(times) / iters,
            "max_per_iter_s": max(times) / iters,
            "compile_s": compile_s}


@contextlib.contextmanager
def trace(log_dir: str):
    """jax profiler trace context (view with TensorBoard / xprof)."""
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
