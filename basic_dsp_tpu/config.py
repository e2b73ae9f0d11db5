"""Runtime configuration of the DSP library.

This is the analog of the reference's ``MultiCoreSettings``
(multicore_support/threading.rs:199-280): where the reference carries
per-vector thread-count thresholds and a one-time calibration, we carry the
device mesh, block sizes for the blocked overlap-save pipeline, and the
matmul-precision dial.  There is no thread fan-out to configure — XLA
parallelizes within a device and ``jax.sharding`` across devices.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import jax
import numpy as np


@dataclasses.dataclass(frozen=True)
class DspConfig:
    """Global knobs, the ``MultiCoreSettings`` analog.

    Attributes:
      overlap_save_min_len: signal length above which ``convolve_signal``
        switches from one big FFT to the blocked overlap-save pipeline
        (reference threshold: 10_000, convolution.rs:530-537).
      overlap_save_min_imp_len: minimum impulse-response length for the
        blocked path (reference: >15).
      overlap_save_len_ratio: ``len > ratio * imp_len`` gate (reference: 10).
      direct_conv_max_imp_len: kernel lengths up to this use the direct
        (gather / matmul) path rather than FFT (reference SIMD gate: 202).
      fft_block_len: 0 = auto (``next_pow2(imp_len)`` per reference
        convolution.rs:536, clamped to ``next_pow2(4*(imp_len-1))``).
    """

    overlap_save_min_len: int = 10_000
    overlap_save_min_imp_len: int = 15
    overlap_save_len_ratio: int = 10
    direct_conv_max_imp_len: int = 202
    direct_conv_min_len: int = 1_000
    fft_block_len: int = 0
    # Production guard: when True, ops that would silently take the
    # per-sample gather path of interpolatef (irrational factors, see
    # interp_ops._warn_gather_path) raise PerformanceError instead of
    # warn-and-proceed.
    fail_on_slow_path: bool = False


_default_config = DspConfig()

# Matmul precision dial.  "highest" (the default) keeps f32 matmuls in
# f32, as the reference's accuracy contract requires; "high" and
# "default" let XLA run f32 matmuls as TF32 on the GPU's tensor cores.
# On an H100 (80GB HBM3, 700 W power limit) the two settings behave the
# same on the flagship chain: max relative error 3.3e-4 instead of
# 3.2e-7, at 0.28 instead of 0.42 ms per 4M samples (chip_smoke.py,
# phase accuracy; PERF.md).  The epoch invalidates cached jit
# programs (see _planar.call) so the dial takes effect immediately.
import os as _os

_matmul_precision = _os.environ.get("BDSP_MATMUL_PRECISION", "highest")
if _matmul_precision not in ("highest", "high", "default"):
    _matmul_precision = "highest"
_precision_epoch = 0


def matmul_precision() -> str:
    return _matmul_precision


def precision_epoch() -> int:
    return _precision_epoch


def set_matmul_precision(precision: str) -> None:
    """Sets the matmul contraction precision: "highest" | "high" |
    "default"."""
    if precision not in ("highest", "high", "default"):
        raise ValueError("precision must be 'highest', 'high' or 'default'")
    global _matmul_precision, _precision_epoch
    if precision != _matmul_precision:
        _matmul_precision = precision
        _precision_epoch += 1


def default_config() -> DspConfig:
    return _default_config


def set_default_config(cfg: DspConfig) -> None:
    """Installs ``cfg`` as the process default.

    Bumps the trace-cache epoch: config fields are consulted at TRACE
    time (dispatch gates pick paths), so cached compiled programs from a
    previous config must not be reused."""
    global _default_config, _precision_epoch
    if cfg != _default_config:
        _precision_epoch += 1
    _default_config = cfg


def enable_x64() -> None:
    """Enable float64/complex128 flavors (the reference's ``64`` types).

    CPUs and GPUs compute f64 natively, so every op keeps the reference's
    contract that f64 flavors compute in f64 (vector_types/mod.rs:121-123).
    The reference's guidance that f64 is roughly two times slower than f32
    understates the gap on a GPU, whose f64 rate is a fraction of its f32
    rate.
    """
    jax.config.update("jax_enable_x64", True)


def make_mesh(n_devices: Optional[int] = None,
              axis_name: str = "dsp",
              shape: Optional[Tuple[int, ...]] = None,
              axis_names: Tuple[str, ...] = ("host", "chip"),
              ) -> jax.sharding.Mesh:
    """Creates the device mesh over which long signals / channels shard.

    Two forms:

    * ``make_mesh(n)`` — 1-D mesh of ``n`` devices, axis ``axis_name``
      (the intra-host case; the reference's multicore analog).
    * ``make_mesh(shape=(H, C))`` — hierarchical ``(host, device)`` mesh:
      H hosts x C devices/host, axes ``axis_names`` outermost-first.  On
      a multi-host deployment (``jax.distributed.initialize`` +
      ``jax.devices()`` spanning processes) the outer axis crosses the
      network between hosts and the inner axis stays inside one host;
      every sharded op in ``basic_dsp_tpu.parallel`` places its
      halo/handoff collectives on the inner axis and only boundary
      handoffs on the outer axis (see parallel/collectives.py).  Sharded
      ops default to sharding over ALL mesh axes host-major, so the same
      call works on either form.  Devices of one host (for example four
      GPUs joined by NVLink) take the 1-D form.
    """
    devices = jax.devices()
    if shape is not None:
        total = int(np.prod(shape))
        if len(devices) < total:
            raise ValueError(f"mesh shape {shape} needs {total} devices, "
                             f"only {len(devices)} visible")
        if len(shape) != len(axis_names):
            raise ValueError("shape and axis_names must have equal length")
        arr = np.array(devices[:total]).reshape(shape)
        return jax.sharding.Mesh(arr, tuple(axis_names))
    if n_devices is not None:
        devices = devices[:n_devices]
    return jax.sharding.Mesh(np.array(devices), (axis_name,))


def distributed_init(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None) -> None:
    """Initializes the multi-host JAX runtime (jax.distributed) so
    ``jax.devices()`` spans every host; call once per process before any
    device op, then build the (host, chip) mesh with
    ``make_mesh(shape=(num_hosts, chips_per_host))``.

    Pass all three arguments: nothing tells JAX of a cluster unless the
    environment does.  Single-process (one host, or the CPU test mesh)
    needs no call."""
    import jax.distributed
    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id)
