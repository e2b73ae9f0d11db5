"""Flagship end-to-end pipelines (the BASELINE.md benchmark configs),
expressed as pure jittable functions over raw arrays."""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from .ops import conv_ops, fft_ops, fourstep


def _shifted_mag(windowed: jnp.ndarray) -> jnp.ndarray:
    """|fftshift(FFT(windowed))| — the DIF four-step (ops/fourstep.py) for
    factorable 1-D lengths, the whole-signal XLA FFT otherwise.

    In the DIF split the stage-1 DFT is a matmul that XLA can fuse with
    the preceding convolution's output.  Whether the four-step beats one
    cuFFT call on a GPU is ROADMAP Speed 5a; chip_smoke.py times both."""
    n = windowed.shape[-1]
    n1, n2 = fourstep.factor(n)
    if windowed.ndim == 1 and n1 >= 64 and n2 % 2 == 0:
        return fourstep.dif_spectrum_mag(windowed, n1)
    return jnp.abs(fft_ops.fft_shifted(windowed))


@functools.partial(jax.jit, static_argnames=("fft_len",))
def fir_fft_chain(x: jnp.ndarray, taps: jnp.ndarray, window: jnp.ndarray,
                  fft_len: int = 0):
    """The flagship chain (BASELINE.md configs #1+#2): centered FIR, then
    a windowed, shifted FFT magnitude spectrum.

    Short kernels (<= 202 taps) take the banded Toeplitz matmul FIR
    (conv_ops.toeplitz_conv), longer ones the blocked overlap-save
    pipeline; the spectrum is :func:`_shifted_mag`.  Mirrors
    convolution.rs:416-450 (FIR) + time_to_freq.rs:158-165 (fft =
    plain_fft + fft_shift) + magnitude.
    """
    m = taps.shape[-1]
    n = x.shape[-1]
    if m <= 202 and n > 1000:
        filtered = conv_ops.toeplitz_conv(x, taps, True)
    else:
        fl = conv_ops.pick_fft_len(m, fft_len) if fft_len else \
            conv_ops.pick_fft_len(m)
        filtered = conv_ops.overlap_save(x, taps, True, fl)
    windowed = filtered * window.astype(filtered.dtype)
    return _shifted_mag(windowed)


@jax.jit
def windowed_spectrum(x: jnp.ndarray, window: jnp.ndarray):
    """Config #1: windowed FFT magnitude of a (real or complex) signal.

    A REAL input stays real all the way to the four-step's stage-1 dot,
    so no complex cast of the whole signal is materialized."""
    return _shifted_mag(x * window.astype(x.dtype))


@functools.partial(jax.jit, static_argnames=("beta", "factor", "delay",
                                             "conv_len"))
def modulation_chain_planar(sr: jnp.ndarray, si: jnp.ndarray,
                            beta: float = 0.35, factor: float = 10.0,
                            delay: float = 0.0, conv_len: int = 10):
    """Config #4 chain (reference examples/modulation.rs:14-41): two PRBS
    symbol channels -> complex baseband via RC pulse-shaping interpolatef
    -> real passband (to_real), all PLANAR.

    The reference sets the two channels as real/imag of one complex vector
    and interpolates it; the RC taps are real, so the two planes resample
    independently and the complex vector never needs to exist.  Returns
    ``(baseband_re, baseband_im)``; the modulated passband output of the
    example is exactly ``baseband_re`` (to_real drops the imag plane).

    Both planes are COMPUTED AND RETURNED — a caller that consumes only
    the real plane lets XLA legitimately skip the imag resample, but the
    reference example writes the complex baseband to disk too, so the
    benchmark consumes both.
    """
    from .ops import interp_ops
    from .conv_types import RaisedCosineFunction

    f = RaisedCosineFunction(beta)
    re = interp_ops.interpolatef(sr, f, factor, delay, conv_len, 1.0)
    im = interp_ops.interpolatef(si, f, factor, delay, conv_len, 1.0)
    return re, im
