"""Polyphase channelizer and FM demodulation — the 1024-channel wideband
config (BASELINE.md config #5).

The building blocks are the reference's own primitives, reassembled as
array programs:

* ``split_into``/``merge`` round-robin polyphase decomposition
  (data_reorganization.rs:170-214) becomes a reshape;
* the per-phase FIR becomes one batched matmul-friendly convolution over the
  phase axis;
* the channel mixing is a batched FFT across the phase axis (the classic
  critically-sampled polyphase filterbank identity).

Channel axis shards naturally over the mesh; with a sharded channel axis the
final per-channel demod runs fully parallel with zero communication.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P


def _merged_tap_rows(prototype: jnp.ndarray, C: int) -> jnp.ndarray:
    """(t+1, C) tap matrix TS for the pure-row-stencil filterbank core.

    Column c carries the taps of phase (C - c) mod C (so the channelizer
    runs in the natural (samples, phases) row layout with no minor-axis
    flip), and the filterbank's one-row delay line — column 0 reads the
    *current* row while columns 1.. read the *previous* row — is folded
    into one extra tap row instead of a shifted copy of the signal:

        TS[p, 0]    = tc[p, 0]      (p < t;  TS[t, 0] = 0)
        TS[p, c>=1] = tc[p - 1, c]  (p >= 1; TS[0, c>=1] = 0)

    where tc[r, c] = prototype[(C - c) % C + r*C].  Then
    ``u[s] = sum_p TS[p] * ext[t - p + s]`` — every term a whole-row
    offset slice of one array, which XLA fuses into a single aligned
    stencil pass with no minor-axis shift."""
    from contextlib import nullcontext
    t = prototype.shape[-1] // C
    # Constant prototypes fold at compile time (jax 0.9 stages jnp ops on
    # constants into the program otherwise — see conv_ops._toeplitz_body).
    fold = (not isinstance(prototype, jax.core.Tracer)
            and not jnp.iscomplexobj(prototype))  # see conv_ops._toeplitz_body
    with jax.ensure_compile_time_eval() if fold else nullcontext():
        h_rc = prototype.reshape(t, C)                # h_rc[r, p] = h[p+r*C]
        # Column permutation (C - c) % C == [0, reversed(1..C-1)]: a
        # slice + flip (XLA Rev), not a gather — traced prototypes hit
        # this on-device per call.
        tc = jnp.concatenate([h_rc[:, :1], jnp.flip(h_rc[:, 1:], axis=1)],
                             axis=1)
        top = jnp.concatenate([tc[:1, :1],
                               jnp.zeros((1, C - 1), tc.dtype)], axis=1)
        rest = jnp.concatenate([tc[1:, :1], tc[:-1, 1:]], axis=1)
        bottom = jnp.concatenate([jnp.zeros((1, 1), tc.dtype),
                                  tc[-1:, 1:]], axis=1)
        return jnp.concatenate([top, rest, bottom], axis=0)


def _polyphase_fir_planes(ext: jnp.ndarray, taps_merged: jnp.ndarray,
                          s_out: int):
    """Shared filterbank FIR front-end: depthwise VALID conv over the row
    axis, one group per phase column, both complex planes in the batch
    dim.  Returns (re, im) planes of shape (s_out, C)."""
    return _polyphase_fir_planar(jnp.real(ext), jnp.imag(ext),
                                 taps_merged, s_out)


def _polyphase_fir_planar(ext_r, ext_i, taps_merged, s_out: int):
    tp1, C = taps_merged.shape
    rhs = jnp.flip(taps_merged, axis=0).reshape(tp1, 1, C)
    lhs = jnp.stack([ext_r, ext_i], axis=0)
    out = jax.lax.conv_general_dilated(
        lhs, rhs.astype(lhs.dtype),
        window_strides=(1,), padding="VALID",
        dimension_numbers=("NHC", "HIO", "NHC"),
        feature_group_count=C, precision="highest")
    return out[0, :s_out], out[1, :s_out]


def _channelize_rows(ext: jnp.ndarray, taps_merged: jnp.ndarray,
                     s_out: int) -> jnp.ndarray:
    """Filterbank core in (rows, C) layout.

    ``ext``: (t + s_out, C) rows of consecutive samples, already padded
    at the top with t zero-or-halo rows (ext[i, q] = x[(i - t)*C + q] for
    in-range indices, t = taps_merged.shape[0] - 1).  Output: (s_out, C)
    channel rows y[s, k].

    The filterbank identity needs v_p[s] = x[s*C - p]; the phase
    reversal is absorbed into the phase->channel DFT (y_k = C*ifft(u~)[k]
    with u~[c] = u_{(C-c)%C}) and the one-row delay line into the merged
    tap matrix (see :func:`_merged_tap_rows`), leaving a pure row-offset
    stencil — no gathers, no minor-axis shifts.  Verified exact against
    the direct per-phase formulation.

    Reference anchors: split_into round-robin semantics
    (data_reorganization.rs:170-214); per-phase FIR = convolve_signal
    applied branchwise (convolution.rs:477-542).
    """
    tp1, C = taps_merged.shape
    t = tp1 - 1
    # Depthwise VALID conv over the row axis, one group per phase column,
    # both complex planes in the batch dim: u[s, c] = sum_p TS[p, c] *
    # ext[s + t - p, c].  XLA's conv emitter reuses each input block
    # across taps.
    u0, u1 = _polyphase_fir_planes(ext, taps_merged, s_out)
    u = jax.lax.complex(u0, u1)
    # Channel mixing: batched inverse FFT over the minor (channel) axis.
    return C * jnp.fft.ifft(u, axis=1)


def polyphase_channelizer(x: jnp.ndarray, prototype: jnp.ndarray,
                          n_channels: int) -> jnp.ndarray:
    """Critically-sampled polyphase filterbank channelizer.

    Args:
      x: complex input signal, length divisible by ``n_channels``.
      prototype: real lowpass prototype filter, length divisible by
        ``n_channels`` (taps_per_phase = len // n_channels).
      n_channels: number of output channels.

    Returns:
      (n_channels, len(x)//n_channels) complex array of baseband channels.
    """
    n = x.shape[-1]
    assert n % n_channels == 0
    C = n_channels
    y = _channelize_rows_padded(x, prototype, C)
    return y.T


def _channelize_rows_padded(x: jnp.ndarray, prototype: jnp.ndarray,
                            C: int) -> jnp.ndarray:
    """(S, C) channel rows for a whole signal (zero causal padding)."""
    taps_merged = _merged_tap_rows(prototype, C)
    t = taps_merged.shape[0] - 1
    X = x.reshape(-1, C)                              # X[s, q] = x[s*C + q]
    S = X.shape[0]
    ext = jnp.concatenate([jnp.zeros((t, C), X.dtype), X], axis=0)
    return _channelize_rows(ext, taps_merged, S)


def fm_demodulate(baseband: jnp.ndarray) -> jnp.ndarray:
    """Per-channel FM demodulation: instantaneous frequency via the phase of
    the one-sample autocorrelation (the modulation.rs chain's demod side).

    Works on (channels, n) or (n,) complex arrays.
    """
    prev = jnp.concatenate([baseband[..., :1], baseband[..., :-1]], axis=-1)
    return jnp.angle(baseband * jnp.conj(prev))


def channelize_and_demod(x: jnp.ndarray, prototype: jnp.ndarray,
                         n_channels: int) -> jnp.ndarray:
    """The flagship wideband pipeline: channelize + per-channel FM demod.

    Runs entirely in (samples, channels) row layout — the FM demod's
    one-sample lookback is a row shift there — so the only transpose in
    the pipeline lands on the f32 angles (half the bytes of transposing
    the complex baseband).  The channel IDFT is XLA's batched inverse
    FFT (cuFFT on a GPU)."""
    y = _channelize_rows_padded(x, prototype, n_channels)   # (S, C)
    prev = jnp.concatenate([y[:1], y[:-1]], axis=0)
    return jnp.angle(y * jnp.conj(prev)).T


def channelize_and_demod_planar(xr: jnp.ndarray, xi: jnp.ndarray,
                                prototype: jnp.ndarray,
                                n_channels: int) -> jnp.ndarray:
    """Planar-boundary variant of :func:`channelize_and_demod` — the
    planar-mode program boundary (complex travels as (re, im) planes,
    ``_planar.py``)."""
    return channelize_and_demod(jax.lax.complex(xr, xi), prototype,
                                n_channels)


def sharded_channelize_and_demod(x: jnp.ndarray, prototype: jnp.ndarray,
                                 n_channels: int, mesh: Mesh,
                                 axis_name=None) -> jnp.ndarray:
    """Mesh-parallel channelizer + FM demod, sharded over the *sample* axis.

    Layout choice: each device holds a contiguous block of input samples,
    i.e. rows of the (samples, phases) polyphase matrix.  Then

    * the per-phase causal FIR runs along the local row axis — only a
      ``(taps_per_phase + 1)`` row halo crosses between devices (one
      ppermute);
    * the phase→channel DFT is along the *local* phase axis — zero
      communication (vs channel-axis sharding, which would put the DFT
      across devices);
    * the FM demod consumes one preceding row, already covered by the halo.

    Output: (n_channels, n // n_channels), sample axis sharded over the
    mesh.  Exact match with :func:`channelize_and_demod` (the ppermute edge
    convention — devices with no source get zeros — reproduces the causal
    zero-padding at the global start).
    """
    from . import collectives
    axis_name = collectives.resolve_axes(mesh, axis_name)
    C = n_channels
    n = x.shape[-1]
    d = collectives.mesh_size(mesh, axis_name)
    if n % C != 0:
        raise ValueError(f"signal length {n} not divisible by {C} channels; the polyphase "
            f"split needs n % channels == 0 — zero-pad the signal first "
            f"(docs/API.md, divisibility contract)")
    S = n // C
    if S % d != 0:
        raise ValueError(f"rows {S} not divisible by mesh size {d}; need (n/channels) % "
            f"n_devices == 0 — pad the signal or use a submesh "
            f"(docs/API.md, divisibility contract)")
    t = prototype.shape[-1] // C
    if S // d < t + 1:
        raise ValueError("shard shorter than FIR+demod halo; "
                         "use fewer devices")
    fn = _sharded_channelizer_fn(mesh, axis_name, C, t, d)
    return fn(x, prototype)


@functools.lru_cache(maxsize=32)
def _sharded_channelizer_fn(mesh: Mesh, axis_name, C: int, t: int,
                            d: int):
    from . import collectives

    def body(xb, proto):
        # xb: (n/d,) contiguous local samples; halo = last (t+1) rows of the
        # left neighbor (FIR depth t rows + 1 row of demod lookback; the
        # one-sample polyphase delay rides inside the row structure).
        # No wrap: the global first device gets zeros (causal padding).
        taps_merged = _merged_tap_rows(proto, C)
        halo_n = (t + 1) * C
        halo = collectives.shift_from_left(xb[-halo_n:], axis_name,
                                           wrap=False)
        ext = jnp.concatenate([halo, xb]).reshape(-1, C)
        s_out = xb.shape[-1] // C + 1        # +1 row for the demod lookback
        y = _channelize_rows(ext, taps_merged, s_out)
        dem = jnp.angle(y[1:] * jnp.conj(y[:-1]))
        return dem.T                          # (C, S_local)

    return jax.jit(jax.shard_map(
        body, mesh=mesh,
        in_specs=(P(axis_name), P()),
        out_specs=P(None, axis_name),
    ))
