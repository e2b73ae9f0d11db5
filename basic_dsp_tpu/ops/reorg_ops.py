"""Data reorganization: padding, interleaving, split/merge, reverse, shift.

Behavioral parity with reference general/data_reorganization.rs.  All
functions take/return arrays whose elements are *points* (complex dtype for
complex vectors) — the reference's interleaved-float bookkeeping disappears.

``zero_pad`` follows the buffered variant's Surround split
(data_reorganization.rs:429-443: ``right = diff/2; left = diff - right``)
which is the one exercised by correlation and the Octave-parity tests.
"""
from __future__ import annotations

import functools

import jax.numpy as jnp
import numpy as np

from .. import config


def reverse(x: jnp.ndarray) -> jnp.ndarray:
    return x[..., ::-1]


def swap_halves(x: jnp.ndarray) -> jnp.ndarray:
    """FFT shift of the data (reference swap_halves == swap_halves_priv(true),
    data_reorganization.rs:249-252)."""
    return jnp.fft.fftshift(x, axes=-1)


def zero_pad(x: jnp.ndarray, points: int, option: str) -> jnp.ndarray:
    """Pad with zeros to ``points`` elements.

    option: 'end' | 'surround' | 'center' (reference PaddingOption,
    data_reorganization.rs:45-54).
    """
    n = x.shape[-1]
    diff = points - n
    if diff < 0:
        raise ValueError("zero_pad target smaller than input")
    if diff == 0:
        return x
    widths = [(0, 0)] * (x.ndim - 1)
    if option == "end":
        return jnp.pad(x, widths + [(0, diff)])
    if option == "surround":
        right = diff // 2
        left = diff - right
        return jnp.pad(x, widths + [(left, right)])
    if option == "center":
        right = n // 2
        left = n - right
        mid = jnp.zeros(x.shape[:-1] + (diff,), dtype=x.dtype)
        return jnp.concatenate(
            [x[..., :left], mid, x[..., left:]], axis=-1)
    raise ValueError(f"unknown padding option: {option}")


def zero_interleave(x: jnp.ndarray, factor: int) -> jnp.ndarray:
    """Insert ``factor-1`` zeros after every element
    (data_reorganization.rs:362-397): [a, b] -> [a, 0, b, 0] for factor 2.

    This is the upsampler front-end of ``interpolatei``.
    """
    if factor <= 1:
        return x
    n = x.shape[-1]
    # Kept as the exact scatter+reshape (NOT the phase mux): the mux's
    # one-hot matmuls are not bit-exact wherever the matmul rounds its
    # operands, and inserted zeros must be exactly zero.
    out = jnp.zeros(x.shape[:-1] + (n, factor), dtype=x.dtype)
    out = out.at[..., 0].set(x)
    return out.reshape(x.shape[:-1] + (n * factor,))


def split_into(x: jnp.ndarray, n_targets: int) -> jnp.ndarray:
    """Round-robin polyphase split (data_reorganization.rs:484-512):
    target[i % n][i // n] = x[i].  Returns an (n_targets, len/n) array."""
    n = x.shape[-1]
    return x.reshape(x.shape[:-1] + (n // n_targets, n_targets)).swapaxes(-1, -2)


def merge(parts: jnp.ndarray) -> jnp.ndarray:
    """Inverse of split_into: parts is (n_sources, m); out[i] =
    parts[i % n][i // n] (data_reorganization.rs:522-557)."""
    return parts.swapaxes(-1, -2).reshape(parts.shape[:-2] + (-1,))


@functools.lru_cache(maxsize=64)
def _mux_selector(P: int, Q: int, offs: tuple):
    """One-hot selector for :func:`phase_mux`: ``S[j, p, f] = 1`` iff
    ``p == j % P`` and ``f == (j // P) * Q + offs[p]``.  Shapes:
    (128*P, P, 128*Q)."""
    B = 128 * P
    span = 128 * Q
    j = np.arange(B)
    S = np.zeros((B, P, span), dtype=np.float32)
    S[j, j % P, (j // P) * Q + np.asarray(offs)[j % P]] = 1.0
    return S


def phase_mux(phases: jnp.ndarray, Q: int, offs, out_len: int) -> jnp.ndarray:
    """Fused phase-interleave + stride-``Q`` decimation::

        out[k*P + p] = phases[..., p, k*Q + offs[p]]

    as ONE dense block contraction.  The naive spellings —
    ``jnp.stack(..., -1).reshape`` for the interleave, strided slices or a
    ``(k, Q)``-minor one-hot einsum for the decimation — all create arrays
    whose minor dimension is tiny (P or Q), and the resulting relayouts
    can dominate the whole resampler.

    Blocking by 128 output samples per phase gives every operand a minor
    dimension of at least 128: reshape phases to ``(..., P, nblocks, 128*Q)``,
    contract with a static one-hot ``(128*P, P, 128*Q)`` selector, and the
    flat output ``(..., nblocks*128*P)`` is a contiguous reshape.  Output
    block ``b`` element ``j`` reads phase ``j % P`` at local offset
    ``(j // P)*Q + offs[j % P] < 128*Q``, so blocks never cross and the
    zero padding added to reach a whole number of blocks never lands in a
    valid output sample.
    """
    P = phases.shape[-2]
    n = phases.shape[-1]
    if P * P * Q > 256:
        # Selector would exceed ~16 MB (128P·P·128Q f32); the pathological
        # rational factors that get here are rare — use the small-minor-dim
        # one-hot (slower but bounded memory).  Requires Q | n, offs < Q.
        k = n // Q
        C2 = phases.reshape(phases.shape[:-1] + (k, Q))
        onehot = np.zeros((P, Q), dtype=np.float32)
        onehot[np.arange(P), np.asarray(offs)] = 1.0
        out_kp = jnp.einsum("...pkq,pq->...kp", C2, jnp.asarray(onehot),
                            precision=config.matmul_precision())
        return out_kp.reshape(out_kp.shape[:-2] + (k * P,))[..., :out_len]
    span = 128 * Q
    B = 128 * P
    nblocks = -(-n // span)
    if nblocks * span != n:
        pad = [(0, 0)] * (phases.ndim - 1) + [(0, nblocks * span - n)]
        phases = jnp.pad(phases, pad)
    C3 = phases.reshape(phases.shape[:-1] + (nblocks, span))
    S = jnp.asarray(_mux_selector(P, Q, tuple(int(o) for o in offs)))
    out = jnp.einsum("...pbf,jpf->...bj", C3, S,
                     precision=config.matmul_precision())
    return out.reshape(out.shape[:-2] + (nblocks * B,))[..., :out_len]
