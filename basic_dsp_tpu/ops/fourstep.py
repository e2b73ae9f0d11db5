"""Four-step (Bailey) factored FFT with matmul DFT stages and precomputed
twiddles — the hand-scheduled big-FFT path of the flagship spectrum chain.

Factoring N = n1*n2 ourselves lets us (a) run the small-n1 DFT stage as a
matmul that XLA can fuse with the producer of its input, (b) precompute
the twiddle factors on the host, and (c) fold the ``fftshift`` of the
spectrum chain into those constants.  Whether this beats one cuFFT call
on a GPU is ROADMAP Speed 5a: chip_smoke.py times both at 4M samples.

Two factorizations (both verified against ``jnp.fft.fft``):

* **DIF** (``dif_fft``): A[j1, j2] = x[j1*n2 + j2]; stage 1 is the n1-DFT
  matmul, stage 2 the batched minor-axis FFT; natural output needs a final
  (n1, n2) transpose.
* **DIT dual** (``dit_spectrum_mag``): A[j2, j1] = x[j1 + n1*j2] — rows
  are CONSECUTIVE samples, exactly the layout the Toeplitz convolution
  writes, so the chain fuses with no input relayout.  Stage 1 is the
  axis-0 FFT, stage 2 the n1-DFT matmul with the fftshift
  folded into a column rotation of the DFT matrix; the final transpose
  happens on f32 magnitudes (half the bytes of a complex transpose).

Reference anchor: the whole chain realizes time_to_freq.rs:158-165 (fft =
plain_fft + fft_shift) + apply_window + complex_to_real magnitude in one
fused program.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from .. import config


def factor(n: int, n1: int = 0):
    """Splits n = n1 * n2 with n1 the matmul-stage size (128/256
    preferred)."""
    if n1:
        assert n % n1 == 0
        return n1, n // n1
    for cand in (128, 256, 64):
        if n % cand == 0 and n // cand >= cand:
            return cand, n // cand
    # Fallback: closest-to-sqrt factor pair.
    best = 1
    for d in range(1, int(np.sqrt(n)) + 1):
        if n % d == 0:
            best = d
    return best, n // best


@functools.lru_cache(maxsize=16)
def _dif_planes(n1: int, n2: int):
    """(F_re, F_im, T_re, T_im) for the DIF split, as f32 device arrays.
    F[k1, j1] = w_n1^(k1 j1); T[k1, j2] = w_N^(k1 j2)."""
    k1 = np.arange(n1)
    F = np.exp(-2j * np.pi * np.outer(k1, k1) / n1).astype(np.complex64)
    T = np.exp(-2j * np.pi * np.outer(k1, np.arange(n2)) / (n1 * n2)
               ).astype(np.complex64)
    # numpy, NOT device arrays: this cache is shared across traces, and a
    # device constant created inside one trace leaks into the next.
    return (np.ascontiguousarray(F.real), np.ascontiguousarray(F.imag),
            np.ascontiguousarray(T.real), np.ascontiguousarray(T.imag))


@functools.lru_cache(maxsize=16)
def _dit_planes(n1: int, n2: int, shift: bool):
    """(F_re, F_im, T_re, T_im) for the DIT dual.

    T[j2->k2 axis is the big one] T[k2, n1idx] = w_N^(n1idx * k2);
    F[n1idx, k1] = w_n1^(n1idx * k1), with the spectrum fftshift folded in
    as a column rotation (X[k + N/2] <=> k1 + n1/2 in the k1-major output
    layout) when ``shift``.
    """
    N = n1 * n2
    j = np.arange(n1)
    k1 = (j + (n1 // 2 if shift else 0)) % n1  # column rotation = fftshift
    F = np.exp(-2j * np.pi * np.outer(j, k1) / n1).astype(np.complex64)
    T = np.exp(-2j * np.pi * np.outer(np.arange(n2), j) / N
               ).astype(np.complex64)
    # numpy, NOT device arrays (see _dif_planes).
    return (np.ascontiguousarray(F.real), np.ascontiguousarray(F.imag),
            np.ascontiguousarray(T.real), np.ascontiguousarray(T.imag))


def _cmatmul(ar, ai, br, bi, precision):
    """Complex matmul on real planes (four real matmuls)."""
    rr = jnp.matmul(ar, br, precision=precision)
    ri = jnp.matmul(ar, bi, precision=precision)
    ir = jnp.matmul(ai, br, precision=precision)
    ii = jnp.matmul(ai, bi, precision=precision)
    return rr - ii, ri + ir


def dif_fft(x: jnp.ndarray, n1: int = 0) -> jnp.ndarray:
    """Natural-order FFT of the last axis via the DIF four-step."""
    n = x.shape[-1]
    n1, n2 = factor(n, n1)
    Fr, Fi, Tr, Ti = _dif_planes(n1, n2)
    F = jax.lax.complex(Fr, Fi)
    T = jax.lax.complex(Tr, Ti)
    A = x.reshape(x.shape[:-1] + (n1, n2))
    B = jnp.einsum("kj,...jn->...kn", F, A.astype(T.dtype),
                   precision=config.matmul_precision())
    D = jnp.fft.fft(B * T, axis=-1)
    return jnp.swapaxes(D, -1, -2).reshape(x.shape[:-1] + (n,))


def dit_spectrum_mag(xw: jnp.ndarray, n1: int = 0,
                     shift: bool = True) -> jnp.ndarray:
    """|fftshift(FFT(xw))| with zero input relayout and all shifts folded.

    ``xw`` is the already-windowed signal.  Pipeline: view as (n2, n1)
    rows of consecutive samples -> axis-0 FFT -> precomputed twiddle ->
    DFT matmul (fftshift folded into the DFT matrix) -> f32 magnitude
    transpose.
    """
    n = xw.shape[-1]
    n1, n2 = factor(n, n1)
    Fr, Fi, Tr, Ti = _dit_planes(n1, n2, shift)
    A = xw.reshape((n2, n1))
    G = jnp.fft.fft(A, axis=0)                    # stage 1: n2-point FFTs
    Hr = jnp.real(G) * Tr - jnp.imag(G) * Ti      # twiddle (precomputed)
    Hi = jnp.real(G) * Ti + jnp.imag(G) * Tr
    Er, Ei = _cmatmul(Hr, Hi, Fr, Fi, config.matmul_precision())
    mag = jnp.sqrt(Er * Er + Ei * Ei)             # (k2, k1) f32
    return mag.T.reshape(-1)                      # k1-major == shifted X


def dif_spectrum_mag(xw: jnp.ndarray, n1: int = 0,
                     shift: bool = True) -> jnp.ndarray:
    """|fftshift(FFT(xw))| via the DIF split: stage-1 matmul DFT, batched
    minor-axis FFT, fftshift folded into the twiddle as (-1)^j2, final
    transpose on f32 magnitudes."""
    n = xw.shape[-1]
    n1, n2 = factor(n, n1)
    Fr, Fi, Tr, Ti = _dif_planes(n1, n2)
    F = jax.lax.complex(Fr, Fi)
    T = jax.lax.complex(Tr, Ti)
    if shift:
        # D[k1, k2 + n2/2] = FFT(C[j2] * (-1)^j2): fold the k2-roll into
        # the twiddle sign.
        sign = jnp.where(jnp.arange(n2) % 2 == 0, 1.0, -1.0
                         ).astype(T.dtype)
        T = T * sign
    A = xw.reshape((n1, n2))
    B = jnp.matmul(F, A.astype(T.dtype),
                   precision=config.matmul_precision())
    D = jnp.fft.fft(B * T, axis=-1)
    return jnp.abs(D).T.reshape(-1)               # (k2, k1) -> k1-minor
