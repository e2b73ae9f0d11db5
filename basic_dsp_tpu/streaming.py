"""Streaming (chunked) processing for production serving.

The reference is a whole-buffer library; serving pipelines instead process
an unbounded signal in chunks.  These helpers carry the small overlap state
between chunks explicitly (pure functions of (chunk, state) — jit/scan
friendly), so a chunked run reproduces the whole-buffer *linear*
convolution exactly (the reference's whole-buffer equivalence contract,
convolution.rs:304-462).
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from .ops import conv_ops


class FirState(NamedTuple):
    """Carry for streaming FIR: the last ``m - 1`` input samples."""

    tail: jnp.ndarray


@functools.partial(jax.jit, static_argnums=(3,))
def _fir_step(chunk, tail, taps, fft_len):
    """One streaming step: (chunk, tail) -> (out, new_tail).

    Module-level and value-agnostic in ``taps`` (a traced argument), so the
    jit cache is shared across all ``StreamingFir`` instances with the same
    shapes/dtypes — equal-tap instances never recompile.

    out[i] = sum_k h[k] * ext[i + m - 1 - k] where ext = [tail, chunk]
    — i.e. the causal part of the linear convolution.
    """
    m = taps.shape[-1]
    ext = jnp.concatenate([tail.astype(chunk.dtype), chunk])
    h = taps.astype(ext.dtype)
    if fft_len >= ext.shape[-1]:
        # Long-kernel / short-chunk regime: blocking degenerates, use one
        # whole-extent FFT linear convolution instead.
        l = int(conv_ops.next_power_of_two(ext.shape[-1] + m - 1))
        lin = jnp.fft.ifft(jnp.fft.fft(ext, n=l) * jnp.fft.fft(h, n=l))
        lin = lin[..., : ext.shape[-1] + m - 1]
    else:
        lin = conv_ops.blocked_linear_conv(ext, h, fft_len)
    out = lin[..., m - 1: m - 1 + chunk.shape[-1]]
    # NOT -(m - 1): — that slice is the whole array when m == 1.  Cast back
    # to the carry dtype so lax.scan's carry structure stays fixed.
    new_tail = ext[..., ext.shape[-1] - (m - 1):].astype(tail.dtype)
    if not jnp.issubdtype(chunk.dtype, jnp.complexfloating):
        out = jnp.real(out).astype(chunk.dtype)
    else:
        out = out.astype(chunk.dtype)
    return out, new_tail


class StreamingFir:
    """Causal-aligned streaming FIR with the centered-kernel taps.

    For chunk sequence x_0, x_1, … the concatenated outputs equal the
    *linear* centered convolution of the concatenated input, delayed by
    ``c - 1`` samples (the lookahead of the centered kernel becomes latency,
    as in any real-time filter).
    """

    def __init__(self, taps: jnp.ndarray):
        import numpy as np
        # Taps stay HOST numpy until the jitted step traces them (same
        # rule as conv_types tables).
        self.taps = np.asarray(jax.device_get(taps))
        self.m = int(self.taps.shape[-1])
        self.fft_len = conv_ops.pick_fft_len(self.m)

    def init_state(self, dtype=jnp.complex64) -> FirState:
        dt = jnp.result_type(dtype, self.taps.dtype)
        return FirState(tail=jnp.zeros((max(self.m - 1, 0),), dtype=dt))

    def process(self, chunk: jnp.ndarray,
                state: FirState) -> Tuple[jnp.ndarray, FirState]:
        """Processes one chunk; returns (out, new_state) with
        ``len(out) == len(chunk)``."""
        out, new_tail = _fir_step(chunk, state.tail, self.taps, self.fft_len)
        return out, FirState(tail=new_tail)


def stream_chunks(fir: StreamingFir, x: jnp.ndarray,
                  chunk_size: int) -> jnp.ndarray:
    """Runs a whole signal through the streaming FIR via lax.scan (the
    verification harness for chunked == whole-buffer).  A non-divisible
    tail is processed as one final shorter chunk — no samples dropped."""
    n = x.shape[-1]
    nb = n // chunk_size
    state = fir.init_state(x.dtype)
    pieces = []
    if nb:
        chunks = x[: nb * chunk_size].reshape(nb, chunk_size)

        def step(st, chunk):
            out, new_state = fir.process(chunk, st)
            return new_state, out

        state, outs = jax.lax.scan(step, state, chunks)
        pieces.append(outs.reshape(-1))
    rem = x[nb * chunk_size:]
    if rem.shape[-1]:
        out, state = fir.process(rem, state)
        pieces.append(out)
    if len(pieces) == 1:
        return pieces[0]
    return jnp.concatenate(pieces)


class ResamplerState(NamedTuple):
    """Carry for the streaming resampler: the last ``T`` input samples."""

    tail: jnp.ndarray


@functools.partial(jax.jit, static_argnums=(3, 4, 5))
def _resample_step(chunk, tail, M, poly_p, poly_q, nb):
    """One streaming step: (chunk, tail) -> (out, new_tail).

    Module-level and value-agnostic in ``M`` (the banded resampling
    matrix rides as a traced argument), so the jit cache is shared across
    StreamingResampler instances with equal geometry.
    """
    from .ops import interp_ops

    T = tail.shape[-1]
    ext = jnp.concatenate([tail.astype(chunk.dtype), chunk], axis=-1)

    def one_plane(pl):
        return interp_ops._direct_apply(pl, M, poly_p, poly_q, nb)

    if jnp.issubdtype(chunk.dtype, jnp.complexfloating):
        out = jax.lax.complex(one_plane(jnp.real(ext)),
                              one_plane(jnp.imag(ext)))
    else:
        out = one_plane(ext)
    new_tail = ext[..., ext.shape[-1] - T:].astype(tail.dtype)
    return out.astype(chunk.dtype), new_tail


class StreamingResampler:
    """Chunked fractional resampler for rational factors ``P/Q`` — the
    streaming counterpart of ``interpolatef`` (reference
    interpolation.rs:387-482 semantics on an unbounded signal).

    Each chunk of ``S`` input samples (``S`` divisible by ``128*Q``)
    yields exactly ``S*P//Q`` output samples via the banded-matmul direct
    resampler (ops/interp_ops._direct_apply) on the tail-extended chunk.
    The concatenated outputs equal the *linear* (zero-padded) resample of
    the concatenated input, delayed by ``self.output_delay`` samples (the
    window lookahead becomes latency, as in StreamingFir).
    """

    def __init__(self, fun, factor: float, delay: float = 0.0,
                 conv_len: int = 10):
        import numpy as np
        from .ops import interp_ops

        P, Q = interp_ops.parse_rational_factor(factor, "StreamingResampler")
        L = int(conv_len)
        taps, offs = interp_ops.polyphase_taps(fun, P, Q, delay, L,
                                               jnp.float32)
        if isinstance(taps, jax.core.Tracer) or jnp.iscomplexobj(taps):
            raise ValueError("StreamingResampler needs concrete real taps")
        self.M = interp_ops._direct_band_matrix(taps, P, Q, offs, L,
                                                np.dtype(np.float32))
        self.P, self.Q, self.L = P, Q, L
        W = int(self.M.shape[0])
        # Tail length: window lookback (2L) and the shifted-reshape slice
        # reach (W - 128), rounded so (T - L) % Q == 0 keeps the output
        # grid aligned to whole polyphase cycles.
        T0 = max(2 * L, W - 128, 0)
        self.T = T0 + ((L - T0) % Q)
        #: concatenated-output delay vs the whole-buffer linear resample
        self.output_delay = (self.T - L) // Q * P

    def init_state(self, dtype=jnp.complex64) -> ResamplerState:
        return ResamplerState(tail=jnp.zeros((self.T,), dtype=dtype))

    def process(self, chunk: jnp.ndarray,
                state: ResamplerState) -> Tuple[jnp.ndarray, ResamplerState]:
        """Processes one chunk of ``S`` samples (``S % (128*Q) == 0``);
        returns (out, new_state) with ``len(out) == S*P//Q``."""
        S = chunk.shape[-1]
        span = 128 * self.Q
        if S % span != 0:
            raise ValueError(f"chunk length {S} must be divisible by "
                             f"128*Q = {span}")
        out, new_tail = _resample_step(chunk, state.tail, self.M,
                                       self.P, self.Q, S // span)
        return out, ResamplerState(tail=new_tail)
