"""Interpolation / resampling family.

Parity targets: reference time_freq/interpolation.rs and
real_interpolation.rs.  The reference's scalar loops become gather + FMA
expressions; for integer factors ``interpolatef`` additionally factors into a
polyphase matmul (a (n, 2L+1) window matrix times a (2L+1, factor) tap
matrix).
"""
from __future__ import annotations

import contextlib
from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np

from . import conv_ops, fft_ops, reorg_ops
from .. import config


def parse_rational_factor(factor: float, who: str, max_den: int = 64):
    """``(P, Q)`` for an exactly-rational resampling factor, or raise.

    Shared by the rational fast paths (this module), the sequence-parallel
    resampler (parallel.sharded) and StreamingResampler so the factor
    grammar cannot drift between them."""
    frac = Fraction(float(factor)).limit_denominator(max_den)
    if float(frac) != float(factor) or frac <= 0:
        raise ValueError(f"{who} needs an exact rational factor P/Q "
                         f"(denominator <= {max_den}); got {factor}")
    return frac.numerator, frac.denominator


def polyphase_taps(fun, P: int, Q: int, delay: float, L: int, real_dtype):
    """Per-phase tap vectors for the P/Q polyphase resampler.

    With output index ``i = k*P + p``: ``floor(i*Q/P) = k*Q + offs[p]``
    and ``frac = (p*Q mod P)/P``, so phase ``p`` correlates x against
    ``fun(s - frac[p] + delay)``, ``s = -L..L`` (the scalar path's tap
    alignment, interpolation.rs:92-131).  Returns ``(taps (P, 2L+1),
    offs)``.  Integer factors are the ``Q = 1`` case (offs all zero).

    Taps depend only on static resampler parameters, so for real-valued
    conv functions they are folded at COMPILE time under an enclosing jit
    (jax 0.9 stages jnp ops on constants otherwise, which puts the tap
    build into every call of the program).  Complex-valued functions stay
    STAGED.  Host-callback functions (``_no_jit``) sample at host-built
    f64 numpy points."""
    xp = np if getattr(fun, "_no_jit", False) else jnp
    rdtype = np.float64 if xp is np else real_dtype
    p = np.arange(P)
    fracs = ((p * Q) % P) / P
    offs = tuple(int(o) for o in (p * Q) // P)
    fold = getattr(fun, "_complex_valued", None) is False
    ctx = (jax.ensure_compile_time_eval() if fold
           else contextlib.nullcontext())
    with ctx:
        s = xp.arange(-L, L + 1, dtype=rdtype)
        taps = jnp.asarray(
            fun.calc(s[None, :] - xp.asarray(fracs, dtype=rdtype)[:, None]
                     + delay))
    return taps, offs


def interpolatef(x: jnp.ndarray, fun, interpolation_factor: float,
                 delay: float, conv_len: int, delta: float) -> jnp.ndarray:
    """Time-domain fractional resampling against an analytic impulse
    response (reference interpolatef, interpolation.rs:387-482; scalar
    semantics interpolation.rs:92-131)::

        delay /= delta
        L = min(conv_len, points//2)
        new_len = round(points * factor)   (evened in interleaved elements)
        center  = i / factor ; r = floor(center)
        out[i]  = sum_{t=0..2L} x[(r - L + t) mod n]
                     * fun(t - L - (center - r) + delay)

    The window index matrix and the tap matrix evaluate as one vectorized
    gather/FMA; the tap matrix only depends on ``i mod factor`` for integer
    factors (polyphase), which XLA exploits via the small inner dimension.
    """
    n = x.shape[-1]
    delay = delay / delta
    L = min(conv_len, n // 2)
    is_complex = jnp.iscomplexobj(x)
    # Reference evens new_len in float-element units: complex vectors are
    # already even; real vectors round up to even length.
    new_len = int(round(n * (2 if is_complex else 1) * interpolation_factor))
    new_len += new_len % 2
    if is_complex:
        new_points = new_len // 2
    else:
        new_points = new_len
    return _interpolatef_core(x, fun, float(interpolation_factor),
                              float(delay), L, new_points)


def _interpolatef_core(x, fun, factor, delay, L, new_points):
    from fractions import Fraction
    int_factor = round(factor)
    n = x.shape[-1]
    # The per-phase correlation fast paths require the tap window to fit in
    # one revolution (2L+1 <= n); tiny vectors wrap multiple times and take
    # the exact gather path.
    fits = 2 * L + 1 <= n
    if (fits and abs(factor - int_factor) < 1e-6 and int_factor >= 1
            and new_points == int_factor * n):
        return _interpolatef_integer_spectral(x, fun, int_factor, delay, L)
    frac = Fraction(factor).limit_denominator(512)
    if (fits and abs(float(frac) - factor) < 1e-9 and frac >= 1
            and frac.denominator <= 64
            and n % frac.denominator == 0
            and new_points == n * frac.numerator // frac.denominator):
        return _interpolatef_rational_spectral(
            x, fun, frac.numerator, frac.denominator, delay, L)
    if fits and abs(float(frac) - factor) < 1e-9 and frac >= 1:
        # General exact-rational path (denominator <= 512, NO divisibility
        # requirement on n): the per-output decomposition i = k*P + p ->
        # base k*Q + offs[p] holds for any length, so the banded matmul
        # just truncates the last partial block.  A small outputs-per-
        # phase factor keeps the band matrix dense-but-tiny — this is how
        # 44.1 <-> 48 kHz (P/Q = 160/147) runs as matmuls instead of the
        # per-sample gather path (semantics anchor interpolation.rs:92-131,
        # 387-482).
        P_, Q_ = frac.numerator, frac.denominator
        rdtype = jnp.zeros((), x.dtype).real.dtype
        taps, offs = polyphase_taps(fun, P_, Q_, delay, L, rdtype)
        c = _choose_c(P_, Q_)
        if _direct_eligible(taps, P_, Q_, L, c):
            out = _interpolatef_direct(x, taps, P_, Q_, offs, L,
                                       new_points, c)
            if not jnp.iscomplexobj(x):
                return jnp.real(out).astype(x.dtype)
            return out
    if n >= _GATHER_WARN_MIN_LEN:
        _warn_gather_path(n, factor)
    return _interpolatef_gather(x, fun, factor, delay, L, new_points)


# Irrational / non-rational factors have no banded-matmul formulation and
# gather a (new_points, 2L+1) window matrix; we keep the exact reference
# semantics but warn once so a 4M-sample call with factor=pi does not
# crawl silently.
_GATHER_WARN_MIN_LEN = 65536
_gather_warned = [False]


def _warn_gather_path(n: int, factor: float) -> None:
    msg = (
        f"interpolatef factor {factor!r} is not an integer or small rational "
        f"(denominator <= 64 dividing the length), so the {n}-sample call "
        "takes the exact per-sample gather path, which is slow at this size. "
        "Prefer a rational factor P/Q with Q | len (banded-matmul fast "
        "path), or resample via interpolate()/interpft (FFT path).")
    from .. import config as _config
    if _config.default_config().fail_on_slow_path:
        from ..errors import PerformanceError
        raise PerformanceError(msg)
    if _gather_warned[0]:
        return
    _gather_warned[0] = True
    import warnings
    warnings.warn(msg, RuntimeWarning, stacklevel=3)


def _interpolatef_gather(x, fun, factor, delay, L, new_points):
    """General fractional-factor path: windows gathered per output sample.
    Exact realization of the reference's scalar loop."""
    n = x.shape[-1]
    # Host callbacks (_no_jit) sample at host-built numpy points; jnp
    # builders would hand them tracers (see conv_ops.convolve_function).
    xp = np if getattr(fun, "_no_jit", False) else jnp
    rdtype = np.float64 if xp is np else jnp.zeros((), x.dtype).real.dtype
    i = xp.arange(new_points, dtype=rdtype)
    center = i / factor
    rounded = xp.floor(center)
    frac = center - rounded
    t = xp.arange(2 * L + 1, dtype=rdtype)
    # Tap argument: t - L - frac + delay  (shape: new_points x (2L+1))
    args = t[None, :] - L - frac[:, None] + delay
    w = jnp.asarray(fun.calc(args))
    idx = (rounded.astype(xp.int32)[:, None]
           + (xp.arange(2 * L + 1, dtype=xp.int32) - L)[None, :]) % n
    windows = x[..., idx]
    w = w.astype(windows.dtype)
    return jnp.sum(windows * w, axis=-1)


def _choose_c(P: int, Q: int) -> int:
    """Outputs-per-phase block factor for the banded matmul: the smallest
    ``c`` with ``c*P % 128 == 0`` (128-aligned output blocks) and
    ``c*Q >= 128`` (the window-slice geometry in :func:`_direct_apply`).
    Small P/Q resolve to c=128 (ROADMAP Speed 5c); large-denominator
    rationals (e.g. the 44.1->48 kHz 160/147) get a small c so the dense
    band matrix stays tiny (c=4: 640x640 instead of 20480x18944), which
    keeps standard audio rates off the gather path."""
    import math
    c0 = 128 // math.gcd(P, 128)
    return c0 * max(1, -(-128 // (c0 * Q)))


def _band_W(P: int, Q: int, L: int, c: int) -> int:
    """Rows of the band matrix: window span per output block, padded to a
    multiple of 128.  Covers max offset (c-1)*Q + (Q-1) + 2L."""
    return 128 * (-(-(c * Q + 2 * L) // 128))


_ROWBLOCK_MIN_Q = 64


def _rowblock_geometry(P: int, Q: int, L: int):
    """Row-block formulation geometry for large-Q rational resampling.

    Output block j (the P outputs ``i = j*P + p``) reads x indices
    ``j*Q + offs[p] + t - L`` — a contiguous window of
    ``maxoff + 2L + 1`` samples at stride Q.  With the circularly
    extended signal reshaped to rows of Q (free in HBM), the window is a
    fixed per-row split across ``V[j+r]`` views.  Returns (W0, off, s0,
    splits) or None when the 128-padded window cannot cover the band;
    splits = ((row_shift, lane_lo, lane_hi), ...).
    """
    maxoff = max(int((p * Q) // P) for p in range(P))
    width = maxoff + 2 * L + 1
    W0 = 128 * (-(-width // 128))
    off = 128 * (-(-L // 128))
    s0 = max(0, off + maxoff + L + 1 - W0)
    if s0 > off - L:
        return None
    splits = []
    pos, end = s0, s0 + W0
    while pos < end:
        r = pos // Q
        lo = pos - r * Q
        hi = min(Q, end - r * Q)
        splits.append((r, lo, hi))
        pos = (r + 1) * Q
    return W0, off, s0, tuple(splits)


def _rowblock_matrices(taps, P, Q, offs, L, dtype):
    """Per-view band matrices M_r (Q, P): the window dot distributed over
    the row-shifted views (``win @ M0 == sum_r V[j+r] @ M_r``)."""
    W0, off, s0, splits = _rowblock_geometry(P, Q, L)
    taps_np = np.asarray(jax.device_get(taps), dtype=dtype)
    p = np.arange(P)
    t = np.arange(taps_np.shape[-1])
    pp, tt = np.meshgrid(p, t, indexing="ij")
    ww = np.asarray(offs)[pp] + tt + (off - s0 - L)
    M0 = np.zeros((W0, P), dtype=dtype)
    M0[ww.ravel(), pp.ravel()] = taps_np.ravel()
    mats, cum = [], 0
    for (_, lo, hi) in splits:
        M_r = np.zeros((Q, P), dtype)
        M_r[lo:hi] = M0[cum:cum + (hi - lo)]
        mats.append(M_r)
        cum += hi - lo
    return mats, splits


def _interpolatef_rowblock(x, taps, P, Q, offs, L, out_len):
    """Large-Q direct resample as row-shifted const-weight matmuls (see
    the dispatch comment in :func:`_interpolatef_direct`).  Exact same
    output as the generic banded path."""
    n = x.shape[-1]
    W0, off, s0, splits = _rowblock_geometry(P, Q, L)
    mats, _ = _rowblock_matrices(taps, P, Q, offs, L, np.dtype(x.dtype))
    nrows = -(-out_len // P)
    max_shift = max(r for (r, _, _) in splits)
    need = (nrows + max_shift + 1) * Q
    pieces = [x[n - off:]] if off else []
    remaining = need - off
    while remaining > 0:
        take = min(remaining, n)
        pieces.append(x[:take])
        remaining -= take
    ext = jnp.concatenate(pieces, axis=-1)
    V = ext[: (nrows + max_shift + 1) * Q].reshape(nrows + max_shift + 1,
                                                   Q)
    precision = config.matmul_precision()
    out = None
    for (r, _, _), M_r in zip(splits, mats):
        term = jnp.matmul(V[r:r + nrows], jnp.asarray(M_r),
                          precision=precision)
        out = term if out is None else out + term
    return out.reshape(-1)[:out_len]


def _interpolatef_direct(x, taps, P, Q, offs, L, out_len, c: int = 128):
    """Single-matmul polyphase resampler: the per-phase Toeplitz
    correlations AND the phase interleave / stride-``Q`` decimation of the
    two-stage path (:func:`_phase_correlations` + ``reorg_ops.phase_mux``)
    composed into ONE static banded matrix::

        out[i] = sum_t x[((i//P)*Q + offs[i%P] + t - L) mod n]
                       * taps[i%P, t]

    For an output block of ``B = 128*P`` consecutive samples the input
    window spans ``W = 128*(Q + ceil(2L/128))`` contiguous (circularly
    extended) samples, so the whole resampler is ``windows (nb, W) @
    M (W, B)`` — no (P, n) intermediate, and less traffic and matmul
    work than correlate-then-mux (mirrors the reference's per-phase SIMD
    loop interpolation.rs:191-290 collapsed into its selector).

    Complex signals with real taps run as two independent real planes.
    """
    n = x.shape[-1]
    if jnp.iscomplexobj(x):
        re = _interpolatef_direct(jnp.real(x), taps, P, Q, offs, L,
                                  out_len, c)
        im = _interpolatef_direct(jnp.imag(x), taps, P, Q, offs, L,
                                  out_len, c)
        return jax.lax.complex(re, im)
    # Large-Q factors (44.1<->48 kHz: Q = 147) have no 128-aligned span
    # below c = 128.  The row-block formulation needs no windows matrix:
    # V = ext.reshape(rows, Q) is a free view, and out = sum_r V[j+r] @
    # M_r (the window dot distributed over the row-shifted views) runs as
    # const-weight matmuls whose operand reads XLA fuses.
    _rbg = (_rowblock_geometry(P, Q, L)
            if x.ndim == 1 and Q >= _ROWBLOCK_MIN_Q else None)
    if _rbg is not None and _rbg[1] <= n:  # ext offset must fit the signal
        return _interpolatef_rowblock(x, taps, P, Q, offs, L, out_len)
    B = c * P
    span = c * Q
    W = _band_W(P, Q, L, c)
    nb = -(-out_len // B)
    # Circular extension ext[i] = x[(i - L) mod n], long enough for the
    # last window (plus one spare span so every 128-row slice below is in
    # range), built from slices (no roll/tile; cf. conv_ops._toeplitz_body).
    need = nb * span + W
    k = L % n
    pieces = [x[..., n - k:]] if k else []
    remaining = need - k
    while remaining > 0:
        take = min(remaining, n)
        pieces.append(x[..., :take])
        remaining -= take
    ext = jnp.concatenate(pieces, axis=-1)
    M = _direct_band_matrix(taps, P, Q, offs, L, np.dtype(x.dtype), c)
    out = _direct_apply(ext, M, P, Q, nb, c)
    return out[..., :out_len]


def _direct_band_matrix(taps, P, Q, offs, L, dtype, c: int = 128):
    """Static band matrix M[w, j] = taps[j % P, t] at w = (j//P)*Q +
    offs[j%P] + t, shape (W, c*P).  Built ON THE HOST in numpy: taps are
    always concrete (they depend only on static resampler parameters,
    never on traced data — fun.calc runs eagerly even under an enclosing
    user jit), and a device-side ``.at[].set`` scatter can end up INSIDE
    the compiled program and run on every call."""
    B = c * P
    W = _band_W(P, Q, L, c)
    taps_np = np.asarray(jax.device_get(taps))
    j = np.arange(B)
    t = np.arange(taps_np.shape[-1])
    jj, tt = np.meshgrid(j, t, indexing="ij")
    pp = jj % P
    ww = (jj // P) * Q + np.asarray(offs)[pp] + tt
    M_np = np.zeros((W, B), dtype=taps_np.dtype)
    M_np[ww.ravel(), jj.ravel()] = taps_np[pp.ravel(), tt.ravel()]
    return jnp.asarray(M_np.astype(dtype))


def _direct_apply(ext, M, P, Q, nb, c: int = 128):
    """Band matmul over a pre-built extension: ``out[..., b*B + j] =
    sum_w ext[..., b*span + w] * M[w, j]`` — the resampler core shared by
    the single-device circular path (:func:`_interpolatef_direct`) and
    the halo-extended sharded path (parallel.sharded_interpolatef).
    ``ext`` must be at least ``nb*span + W - 128`` long; returns the flat
    (..., nb*128P) output.

    Column group g of window_b = ext[b*span : b*span + W] is
    ext[128g + b*span : ...+128] — the leading 128 columns of span-block
    b of ext shifted by 128g.  Two equivalent spellings, chosen by shape
    (which one wins on a GPU is ROADMAP Speed 5c):
     - Q == 1 (integer factors; span == 128, groups fully contiguous):
       shift-accumulate `sum_g part_g @ M_g` behind an optimization
       barrier (without it XLA fuses the window concat INTO the matmul).
     - Q > 1: one materialized (nb, W) windows matmul.
    """
    B = c * P
    span = c * Q
    W = M.shape[0]
    lead = ext.shape[:-1]
    precision = config.matmul_precision()
    if Q == 1 and c == 128:
        ext = jax.lax.optimization_barrier(ext)
        out = None
        for g in range(W // 128):
            part = (ext[..., 128 * g: 128 * g + nb * span]
                    .reshape(lead + (nb, span))[..., :128])
            term = jnp.matmul(part, M[128 * g: 128 * (g + 1)],
                              precision=precision)
            out = term if out is None else out + term
    else:
        parts = [
            ext[..., 128 * g: 128 * g + nb * span]
            .reshape(lead + (nb, span))[..., :128]
            for g in range(W // 128)
        ]
        windows = jnp.concatenate(parts, axis=-1)
        out = jnp.matmul(windows, M, precision=precision)
    return out.reshape(lead + (nb * B,))


def _direct_eligible(taps, P, Q, L, c: int = 128):
    """Gate for :func:`_interpolatef_direct`: concrete (host-fetchable)
    real taps and a composed matrix small enough to stay cheap (W*B
    elements; 16 MB f32 cap)."""
    W = _band_W(P, Q, L, c)
    return (not isinstance(taps, jax.core.Tracer)
            and not jnp.iscomplexobj(taps)
            and W * c * P <= (1 << 22))


def _phase_correlations(x, taps):
    """Per-phase circular correlations ``out_p[q] = sum_s x[(q+s) mod n] *
    taps_p[s+L]`` as ONE batched Toeplitz matmul contraction with the
    reversed tap vectors (correlation == convolution with reversed kernel;
    see conv_ops.toeplitz_conv_multi).  taps: (P, 2L+1); returns
    (..., P, n)."""
    return conv_ops.toeplitz_conv_multi(x, taps[:, ::-1])


def _interpolatef_integer_spectral(x, fun, factor, delay, L):
    """Integer-factor polyphase fast path (the analog of the reference's
    SIMD path, interpolation.rs:191-290, built from per-phase kernels like
    function_to_vectors, interpolation.rs:133-181 — but with the *scalar*
    path's tap alignment so both paths agree exactly).

    Evaluates the same quantity as the gather path::

        out[q*F + p] = sum_{s=-L..L} x[(q+s) mod n] * fun(s - p/F + delay)

    as F per-phase matmul correlations; the phase interleave is a
    reshape — no gathers.
    """
    n = x.shape[-1]
    taps, offs = polyphase_taps(fun, factor, 1, delay, L,
                                jnp.zeros((), x.dtype).real.dtype)
    if _direct_eligible(taps, factor, 1, L):
        out = _interpolatef_direct(x, taps, factor, 1, offs, L,
                                   factor * n)
        if not jnp.iscomplexobj(x):
            return jnp.real(out).astype(x.dtype)
        return out
    corr = _phase_correlations(x, taps)        # (..., F, n)
    # Phase interleave via the matmul mux (Q=1, no decimation; see
    # reorg_ops.phase_mux).
    out = reorg_ops.phase_mux(corr, 1, offs, factor * n)
    if not jnp.iscomplexobj(x):
        return jnp.real(out).astype(x.dtype)
    return out


def _interpolatef_rational_spectral(x, fun, P, Q, delay, L):
    """Rational-factor P/Q polyphase fast path (gather-free).

    With output index ``i = k*P + p``::

        floor(i*Q/P) = k*Q + floor(p*Q/P),  frac = (p*Q mod P)/P

    so the output decomposes into P phases, each a circular correlation of
    x with a fixed tap vector (a Toeplitz matmul) followed by a
    stride-Q decimation at offset ``floor(p*Q/P)``.  Exactly equal to the
    scalar formula.  Requires Q | n.
    """
    n = x.shape[-1]
    taps, offs = polyphase_taps(fun, P, Q, delay, L,
                                jnp.zeros((), x.dtype).real.dtype)
    if _direct_eligible(taps, P, Q, L):
        out = _interpolatef_direct(x, taps, P, Q, offs, L, n * P // Q)
        if not jnp.iscomplexobj(x):
            return jnp.real(out).astype(x.dtype)
        return out
    corr = _phase_correlations(x, taps)        # (..., P, n)
    k_count = n // Q
    # out[k*P + p] = corr_p[k*Q + offs[p]]: fused interleave + stride-Q
    # decimation as one matmul (see reorg_ops.phase_mux).
    out = reorg_ops.phase_mux(corr, Q, offs, k_count * P)
    if not jnp.iscomplexobj(x):
        return jnp.real(out).astype(x.dtype)
    return out


def interpolatei(x: jnp.ndarray, fun, factor: int,
                 is_complex: bool) -> jnp.ndarray:
    """Integer upsampling in frequency domain (reference interpolatei,
    interpolation.rs:484-532): zero-interleave, FFT, multiply by the
    fft-shift-mapped frequency response scaled by ``factor``, IFFT, scale by
    ``1/new_points``.  Real vectors round-trip through complex space."""
    if factor <= 1:
        return x
    work = x
    if not is_complex:
        work = x.astype(jnp.result_type(x.dtype, jnp.complex64))
    up = reorg_ops.zero_interleave(work, factor)
    freq = fft_ops.plain_fft(up)
    freq = conv_ops.multiply_function(freq, fun.calc_freq, float(factor),
                                      is_fft_shifted=True,
                                      is_symmetric=fun.is_symmetric)
    time = fft_ops.plain_ifft(freq) / up.shape[-1]
    if not is_complex:
        return jnp.real(time).astype(x.dtype)
    return time


def interpolate(x: jnp.ndarray, fun, dest_points: int, delay: float,
                delta: float, is_complex: bool) -> jnp.ndarray:
    """Arbitrary-length FFT resampling (reference interpolate,
    interpolation.rs:542-605): FFT, optional linear phase for the delay,
    center zero-pad (upsample) or spectrum center-cut (downsample), IFFT.

    ``fun`` of None preserves the spectrum (interpft).
    """
    n = x.shape[-1]
    factor = dest_points / n
    work = x if is_complex else x.astype(
        jnp.result_type(x.dtype, jnp.complex64))
    freq = fft_ops.plain_fft(work)
    if delay != 0.0:
        freq = conv_ops.apply_linear_phase(freq, delay / delta)
    if dest_points > n:
        freq = reorg_ops.zero_pad(freq, dest_points, "center")
        if fun is None:
            freq = freq * factor
        else:
            freq = conv_ops.multiply_function(freq, fun.calc_freq, factor,
                                              is_fft_shifted=True,
                                              is_symmetric=fun.is_symmetric)
    elif dest_points < n:
        # Center-cut: keep pos_points leading and neg_points trailing bins,
        # rescale by dest/orig (interpolation.rs:364-376).
        neg = dest_points // 2
        pos = dest_points - neg
        freq = jnp.concatenate([freq[..., :pos], freq[..., n - neg:]],
                               axis=-1) * (dest_points / n)
    time = fft_ops.plain_ifft(freq) / dest_points
    if not is_complex:
        return jnp.real(time).astype(x.dtype)
    return time


def interpft(x: jnp.ndarray, dest_points: int, is_complex: bool):
    """reference interpft == interpolate(None, dest, 0.0)."""
    return interpolate(x, None, dest_points, 0.0, 1.0, is_complex)


def decimatei(x: jnp.ndarray, decimation_factor: int,
              delay: int) -> jnp.ndarray:
    """Strided pick (reference decimatei, interpolation.rs:607-633).

    Stays a strided slice: a one-hot phase-mux matmul is not bit-exact
    wherever the matmul rounds its operands, and an exact pick is the
    op's contract."""
    return x[..., delay::decimation_factor]


def _lin_gather_at(x, n, factor, delay, i):
    """Reference linear-interp formula at output indices ``i`` (gather;
    used for the full output on small vectors and for the tiny clipped
    boundary regions of the rational fast path)."""
    pos = i / factor + delay
    before_f = jnp.floor(pos)
    before = jnp.clip(before_f.astype(jnp.int32), 0, n - 2)
    y0 = x[..., before]
    y1 = x[..., before + 1]
    return y0 + (y1 - y0) * (pos - before_f).astype(x.dtype)


def _rational_factor(factor):
    """factor as an exact small fraction P/Q, or None."""
    from fractions import Fraction
    frac = Fraction(factor).limit_denominator(64)
    if float(frac) != float(factor) or frac <= 0:
        return None
    return frac.numerator, frac.denominator


def _real_interp_direct(x, taps_np, P, Q, L, lo, hi, out_len):
    """Shared rational fast-path plumbing for the real interpolators:
    interior outputs (clip-free stencils, i.e. phase-k indices in
    [k_head, k_tail]) via :func:`_interpolatef_direct`'s banded matmul,
    boundary outputs patched with the exact gather formula.

    ``lo``/``hi``: the stencil's lowest/highest x-offset per output
    (interior requires ``0 <= kQ + lo`` and ``kQ + hi <= n - 1``).
    Returns (head_n, tail_start, body) or None when ineligible.

    Accuracy note: output phases whose fractional position is exactly 0
    are plain copies in the reference formula; through the banded matmul
    they are exact only where the matmul keeps f32 operands (f32-exact
    grade otherwise).  The all-phases-exact case (P == 1 with
    integer delay — pure decimation) is rejected by the callers so true
    data movement stays bit-exact on the gather path.
    """
    n = x.shape[-1]
    if (jnp.iscomplexobj(x) or out_len < 2048
            or not _direct_eligible(taps_np, P, Q, L)):
        return None
    k_head = max(0, -(-(0 - lo) // Q))
    k_tail = (n - 1 - hi) // Q
    head_n = min(out_len, k_head * P)
    tail_start = max(head_n, min(out_len, (k_tail + 1) * P))
    if tail_start - head_n < out_len // 2:
        return None  # boundary-dominated; not worth the matmul
    # taps stay NUMPY end-to-end: jnp.asarray under an enclosing trace is
    # STAGED into the program in jax 0.9 (a tracer), which would defeat
    # the host-side band-matrix build in _interpolatef_direct.
    body = _interpolatef_direct(x, taps_np, P, Q, (0,) * P, L, out_len)
    return head_n, tail_start, body


def interpolate_lin(x: jnp.ndarray, factor: float,
                    delay: float) -> jnp.ndarray:
    """Linear interpolation between samples (reference
    real_interpolation.rs:33-71).  Real vectors only; the last output point
    is pinned to the last input point.

    For rational factors P/Q the body runs gather-free: output phase p has
    a CONSTANT fractional position ``t_p = frac(pQ/P + delay)``, so the
    whole op is a 2-tap instance of :func:`_interpolatef_direct`'s banded
    matmul; only the clipped boundary samples use the reference's gather
    formula."""
    n = x.shape[-1]
    dest_len = int(round((n - 1) * factor)) + 1
    rdtype = jnp.zeros((), x.dtype).real.dtype
    body_len = dest_len - 1
    rational = _rational_factor(factor)
    if (rational and not jnp.iscomplexobj(x)
            and not (rational[0] == 1 and delay == int(delay))):
        P, Q = rational
        v = np.arange(P) * Q / float(P) + delay
        b = np.floor(v).astype(np.int64)
        t = v - b
        L = int(max(1, -b.min(), b.max() + 1))
        taps = np.zeros((P, 2 * L + 1))
        taps[np.arange(P), b + L] = 1.0 - t
        taps[np.arange(P), b + L + 1] = t
        fast = _real_interp_direct(x, taps, P, Q, L, int(b.min()),
                                   int(b.max()) + 1, body_len)
        if fast is not None:
            head_n, tail_start, body = fast
            pieces = []
            if head_n:
                pieces.append(_lin_gather_at(
                    x, n, factor, delay, jnp.arange(head_n, dtype=rdtype)))
            pieces.append(body[..., head_n:tail_start])
            if tail_start < body_len:
                pieces.append(_lin_gather_at(
                    x, n, factor, delay,
                    jnp.arange(tail_start, body_len, dtype=rdtype)))
            return jnp.concatenate(pieces + [x[..., -1:]], axis=-1)
    body = _lin_gather_at(x, n, factor, delay,
                          jnp.arange(body_len, dtype=rdtype))
    return jnp.concatenate([body, x[..., -1:]], axis=-1)


def _hermite_gather_at(x, n, factor, delay, i):
    """Reference hermite formula at output indices ``i`` (gather with
    boundary extrapolation; real_interpolation.rs:115, 156-165)."""
    pos = i / factor + delay
    before_f = jnp.floor(pos)
    before = before_f.astype(jnp.int32)
    t = (pos - before_f).astype(x.dtype)

    def grab(idx):
        return x[..., jnp.clip(idx, 0, n - 1)]

    y1 = grab(before)
    y2_in = grab(before + 1)
    y0_in = grab(before - 1)
    y3_in = grab(before + 2)
    y0 = jnp.where(before <= 0, y1 - (y2_in - y1), y0_in)
    y2 = jnp.where(before >= n - 1, y1 + (y1 - y0), y2_in)
    y3 = jnp.where(before >= n - 2, y2 + (y2 - y1), y3_in)
    t2 = t * t
    a0 = -0.5 * y0 + 1.5 * y1 - 1.5 * y2 + 0.5 * y3
    a1 = y0 - 2.5 * y1 + 2.0 * y2 - 0.5 * y3
    a2 = -0.5 * y0 + 0.5 * y2
    a3 = y1
    return a0 * t * t2 + a1 * t2 + a2 * t + a3


def interpolate_hermite(x: jnp.ndarray, factor: float,
                        delay: float) -> jnp.ndarray:
    """Catmull-Rom-style cubic hermite interpolation with boundary
    extrapolation (reference real_interpolation.rs:73-179; cites
    paulbourke.net/miscellaneous/interpolation).

    Rational factors run the interior as a 4-tap banded matmul with
    per-phase Catmull-Rom weights (see :func:`interpolate_lin`); the
    extrapolated boundary samples keep the reference gather formula."""
    n = x.shape[-1]
    dest_len = int(round((n - 1) * factor)) + 1
    rdtype = jnp.zeros((), x.dtype).real.dtype
    rational = _rational_factor(factor)
    if (rational and not jnp.iscomplexobj(x)
            and not (rational[0] == 1 and delay == int(delay))):
        P, Q = rational
        v = np.arange(P) * Q / float(P) + delay
        b = np.floor(v).astype(np.int64)
        t = v - b
        t2, t3 = t * t, t * t * t
        w0 = -0.5 * t3 + t2 - 0.5 * t
        w1 = 1.5 * t3 - 2.5 * t2 + 1.0
        w2 = -1.5 * t3 + 2.0 * t2 + 0.5 * t
        w3 = 0.5 * t3 - 0.5 * t2
        L = int(max(1, -(b.min() - 1), b.max() + 2))
        taps = np.zeros((P, 2 * L + 1))
        idx = np.arange(P)
        taps[idx, b - 1 + L] = w0
        taps[idx, b + L] += w1
        taps[idx, b + 1 + L] += w2
        taps[idx, b + 2 + L] += w3
        fast = _real_interp_direct(x, taps, P, Q, L, int(b.min()) - 1,
                                   int(b.max()) + 2, dest_len)
        if fast is not None:
            head_n, tail_start, body = fast
            pieces = []
            if head_n:
                pieces.append(_hermite_gather_at(
                    x, n, factor, delay, jnp.arange(head_n, dtype=rdtype)))
            pieces.append(body[..., head_n:tail_start])
            if tail_start < dest_len:
                pieces.append(_hermite_gather_at(
                    x, n, factor, delay,
                    jnp.arange(tail_start, dest_len, dtype=rdtype)))
            return jnp.concatenate(pieces, axis=-1)
    return _hermite_gather_at(x, n, factor, delay,
                              jnp.arange(dest_len, dtype=rdtype))
