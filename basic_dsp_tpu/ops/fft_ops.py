"""FFT family: plain/shifted transforms, mirror, fft shift.

Behavioral parity notes (all against the reference):

* ``plain_fft`` == unscaled forward DFT (time_freq/mod.rs:32-63 via rustfft).
* ``plain_ifft`` == *unscaled* inverse DFT — rustfft's inverse has no 1/N, so
  ``plain_ifft(x) == N * jnp.fft.ifft(x)`` (doc example freq_to_time.rs:28-41).
* ``fft`` == ``fft_shift(plain_fft(x))`` (time_to_freq.rs:158-165).
* ``ifft`` == ``plain_ifft(ifft_shift(x / N))`` (freq_to_time.rs:160-168)
  which reduces to ``jnp.fft.ifft(ifftshift(x))``.
* ``fft_shift``/``ifft_shift`` match GNU Octave including odd lengths
  (vector_types/mod.rs:171-191) — identical to numpy's fftshift/ifftshift.
* ``mirror`` rebuilds a full 2N-1 spectrum from a half spectrum
  (time_freq/freq.rs:52-83).

All transforms operate on the last axis so the matrix/channel layer can batch
them (batched FFTs amortize launch and planning costs).
"""
from __future__ import annotations

import jax.numpy as jnp


def fft_shift(x: jnp.ndarray) -> jnp.ndarray:
    """Swap halves after an FFT (== Octave/numpy fftshift, odd-length aware)."""
    return jnp.fft.fftshift(x, axes=-1)


def ifft_shift(x: jnp.ndarray) -> jnp.ndarray:
    """Swap halves before an inverse FFT (== numpy ifftshift)."""
    return jnp.fft.ifftshift(x, axes=-1)


def plain_fft(x: jnp.ndarray) -> jnp.ndarray:
    """Unscaled forward DFT."""
    return jnp.fft.fft(x, axis=-1)


def plain_ifft(x: jnp.ndarray) -> jnp.ndarray:
    """Unscaled inverse DFT (rustfft convention: no 1/N)."""
    n = x.shape[-1]
    return jnp.fft.ifft(x, axis=-1) * n


def fft_shifted(x: jnp.ndarray) -> jnp.ndarray:
    """Forward DFT with the DC bin moved to the center (reference ``fft``)."""
    return fft_shift(plain_fft(x))


def ifft_shifted(x: jnp.ndarray) -> jnp.ndarray:
    """Inverse of :func:`fft_shifted` (reference ``ifft``): scale by 1/N,
    undo the shift, unscaled inverse DFT."""
    return jnp.fft.ifft(ifft_shift(x), axis=-1)


def mirror(x: jnp.ndarray) -> jnp.ndarray:
    """[d0, d1, …, dn-1] -> [d0, …, dn-1, conj(dn-1), …, conj(d1)].

    Reference freq.rs:52-83 (doc example freq.rs:22-31).
    """
    tail = jnp.conj(x[..., 1:][..., ::-1])
    return jnp.concatenate([x, tail], axis=-1)


def unmirror(x: jnp.ndarray, points: int) -> jnp.ndarray:
    """Keep ``points/2 + 1`` bins — inverse of mirror for a symmetric
    spectrum (reference unmirror! macro, time_to_freq.rs:178-186)."""
    return x[..., : points // 2 + 1]
