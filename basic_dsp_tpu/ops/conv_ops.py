"""Convolution family: circular centered convolution, analytic-function
convolution, frequency-response multiplication, blocked overlap-save.

Semantics (pinned by the reference's identity tests):

``convolve_signal`` computes a *circular* convolution with the kernel
centered (time_freq/mod.rs:275-361).  With ``m = len(h)``, ``n = len(x)``::

    c = m - m//2                      # == ceil(m/2)
    out[i] = sum_k x[(i + c - 1 - k) mod n] * h[k]          (m <= n)

pinned by ``shift_left_by_1_as_conv`` (convolution.rs:819-842: kernel
[0,0,1] shifts right by... produces [9,0,1,...,8]) and
``convolve_complex_vectors32``.  When the kernel is *longer* than the signal
the reference clips it around its center (mod.rs:284-295)::

    h_eff = h[m//2 - n//2 : m//2 + n//2];  c = n//2

The whole-signal realization is spectral: we lay the kernel out on the
circle as

    g = roll(pad_end(h_eff, n), -(c-1))

so that ``out = ifft(fft(x) * fft(g))`` — one fused XLA FFT pipeline instead
of the reference's four dispatch paths (SIMD/GPU/overlap-save/scalar,
convolution.rs:477-542).  For long signals :func:`overlap_save` evaluates the
same quantity as a *batched* small-FFT pipeline (better HBM locality, and the
unit that shards across chips with halo exchange).
"""
from __future__ import annotations

import functools
from contextlib import nullcontext as _nullcontext

import jax
import jax.numpy as jnp
import numpy as np

from .. import config

def next_power_of_two(value: int) -> int:
    """Reference convolution.rs:270-282."""
    if value <= 1:
        return value if value == 1 else 1
    return 1 << (value - 1).bit_length()


def _clip_kernel(n: int, m: int):
    """Returns (slice_start, slice_len, c) for the effective kernel."""
    if m <= n:
        return 0, m, m - m // 2
    center = m // 2
    cl = n // 2
    return center - cl, 2 * cl, cl


def kernel_layout(h: jnp.ndarray, n: int) -> jnp.ndarray:
    """Lays the centered kernel out on a length-``n`` circle so that plain
    circular convolution with it reproduces the reference alignment."""
    m = h.shape[-1]
    start, length, c = _clip_kernel(n, m)
    h_eff = h[..., start:start + length]
    pad = [(0, 0)] * (h.ndim - 1) + [(0, n - length)]
    g = jnp.pad(h_eff, pad)
    return jnp.roll(g, -(c - 1), axis=-1)


@functools.partial(jax.jit, static_argnames=("is_complex",))
def convolve_signal_fft(x: jnp.ndarray, h: jnp.ndarray, is_complex: bool):
    """Whole-signal spectral path for the centered circular convolution."""
    n = x.shape[-1]
    g = kernel_layout(h, n)
    cdtype = jnp.result_type(x.dtype, jnp.complex64)
    out = jnp.fft.ifft(jnp.fft.fft(x.astype(cdtype), axis=-1)
                       * jnp.fft.fft(g.astype(cdtype), axis=-1), axis=-1)
    return out if is_complex else jnp.real(out).astype(x.dtype)


def blocked_linear_conv(x: jnp.ndarray, h_eff: jnp.ndarray,
                        fft_len: int) -> jnp.ndarray:
    """Full linear convolution ``len(x) + m_eff - 1`` via a blocked
    overlap-add pipeline of batched small FFTs.

    Uses only reshape / pad / slice / add — no gathers: the blocks are a
    reshape of the padded signal, and each block's tail is added into the
    next one (overlap-add).  Requires ``fft_len >= 2 * m_eff - 1`` so
    each block's tail only spills into the following block.
    """
    n = x.shape[-1]
    m_eff = h_eff.shape[-1]
    cdtype = jnp.result_type(x.dtype, h_eff.dtype, jnp.complex64)
    L = fft_len - (m_eff - 1)
    assert L >= m_eff - 1, "fft_len too small for single-block overlap"
    nb = -(-n // L)
    lead = x.ndim - 1
    xpad = jnp.pad(x, [(0, 0)] * lead + [(0, nb * L - n)])
    blocks = xpad.reshape(x.shape[:-1] + (nb, L))
    blocks = jnp.pad(blocks, [(0, 0)] * (lead + 1) + [(0, m_eff - 1)])
    h_pad = jnp.pad(h_eff, [(0, 0)] * (h_eff.ndim - 1)
                    + [(0, fft_len - m_eff)])
    spectrum = jnp.fft.fft(h_pad.astype(cdtype), axis=-1)
    y = jnp.fft.ifft(jnp.fft.fft(blocks.astype(cdtype), axis=-1) * spectrum,
                     axis=-1)
    main = y[..., :L].reshape(x.shape[:-1] + (nb * L,))
    tails = y[..., L:]                      # (..., nb, m_eff-1)
    tpad = jnp.pad(tails, [(0, 0)] * (lead + 1) + [(0, L - (m_eff - 1))])
    tflat = tpad.reshape(x.shape[:-1] + (nb * L,))
    total = nb * L + m_eff - 1
    main_full = jnp.pad(main, [(0, 0)] * lead + [(0, m_eff - 1)])
    tail_full = jnp.pad(tflat, [(0, 0)] * lead + [(L, 0)])[..., :total]
    return (main_full + tail_full)[..., : n + m_eff - 1]


@functools.partial(jax.jit, static_argnames=("is_complex", "fft_len"))
def overlap_save(x: jnp.ndarray, h: jnp.ndarray, is_complex: bool,
                 fft_len: int):
    """Blocked evaluation of the circular centered convolution — the
    batched counterpart of the reference's overlap-discard path
    (convolution.rs:304-462).

    The sequential block loop with its overlap-restore buffer becomes one
    *batched* FFT -> multiply -> IFFT pipeline over all blocks (overlap-add
    formulation, see :func:`blocked_linear_conv`); the reference's scalar
    head/tail patch-up (convolution.rs:374-398) becomes a circular fold of
    the linear-convolution tail plus a roll for the center alignment.
    """
    n = x.shape[-1]
    m = h.shape[-1]
    start, length, c = _clip_kernel(n, m)
    m_eff = length
    lin = blocked_linear_conv(x, h[..., start:start + length], fft_len)
    # Circular fold: wrap the tail [n, n+m_eff-1) onto [0, m_eff-1).
    head = lin[..., :m_eff - 1] + lin[..., n:]
    folded = jnp.concatenate([head, lin[..., m_eff - 1:n]], axis=-1)
    out = jnp.roll(folded, -(c - 1), axis=-1)
    return out if is_complex else jnp.real(out).astype(x.dtype)


def toeplitz_conv(x: jnp.ndarray, h: jnp.ndarray, is_complex: bool):
    """Direct (matmul) evaluation of the circular centered convolution for
    short kernels.

    The matmul-precision dial is resolved HERE, outside the jitted impl,
    and passed as a static argument: an inner ``@jax.jit`` that read the
    dial ambiently would serve its stale cached jaxpr after
    ``set_matmul_precision`` (jax's trace cache knows nothing about our
    config epoch).

    The reference's SIMD path precomputes register-shifted kernel copies and
    runs a vector MAC loop (time_freq/mod.rs:81-165, 498-610).  Here the
    shifted-kernel trick becomes a matmul: with the signal reshaped to
    (rows, 128) columns, a shift by ``e = 128a + b`` factors into a row
    shift (a) and a column shift (b), and the sum over column shifts
    weighted by taps is exactly a matmul against a 128x128 banded Toeplitz
    matrix.  The whole convolution becomes
    ``sum_a rowshift_a(Z) @ T_a`` — a handful of (n/128, 128) x (128, 128)
    matmuls, no gathers, no FFT.
    """
    return _toeplitz_conv_impl(x, h, is_complex, config.matmul_precision())


@functools.partial(jax.jit, static_argnames=("is_complex", "precision"))
def _toeplitz_conv_impl(x, h, is_complex: bool, precision: str):
    # Real taps stay REAL: _toeplitz_body's planar complex branch runs
    # the two signal planes through SEPARATE per-plane matmuls against
    # the (compile-time-folded) real tap matrix — 2 dots, no complex
    # storage.
    # h passes through UNCAST: any jnp op on a concrete array (even a
    # same-dtype astype) returns a tracer inside the enclosing trace and
    # would defeat _toeplitz_body's compile-time tap-matrix fold; the
    # body harmonizes dtypes at the per-shift Ta.astype (tiny, post-fold).
    out = _toeplitz_body(x, h, precision)
    return out if is_complex else jnp.real(out).astype(x.dtype)


def _toeplitz_planes(extr, exti, q, fold, m_eff, R, n_shifts, lead,
                     rdtype, precision):
    """Shared planar Toeplitz MAC loop over pre-built (re, im) circular
    extensions.  ``q`` may be real (planes
    convolve independently, 2 dots, compile-time tap-matrix fold kept)
    or complex (3-dot Karatsuba)."""
    j = np.arange(128)[:, None]
    col = np.arange(128)[None, :]
    h_cplx = jnp.iscomplexobj(q)
    if h_cplx:
        qr = jnp.real(q)
        qi = jnp.imag(q)
    outr = jnp.zeros(lead + (R * 128,), dtype=rdtype)
    outi = jnp.zeros(lead + (R * 128,), dtype=rdtype)
    for a in range(n_shifts):
        e = 128 * a + j - col
        mask = (e >= 0) & (e < m_eff)
        idx = np.where(mask, e, 0)
        mj = jnp.asarray(mask)
        br = extr[..., 128 * a: 128 * a + R * 128].reshape(
            lead + (R, 128))
        bi = exti[..., 128 * a: 128 * a + R * 128].reshape(
            lead + (R, 128))
        if not h_cplx:
            # REAL taps, complex signal (the flagship/facade FIR
            # case): the planes convolve independently — 2 dots, and
            # a CONCRETE kernel keeps the compile-time tap-matrix
            # fold (round-3 review: routing this case through the
            # Karatsuba branch had staged the gather builds into the
            # program and run 3 dots on a zero plane).
            def _mk_ta():
                return jnp.where(mj, q[..., idx], 0)

            if fold:
                with jax.ensure_compile_time_eval():
                    Ta = _mk_ta()
            else:
                Ta = _mk_ta()
            Ta = Ta.astype(rdtype)
            outr = outr + jnp.matmul(br, Ta,
                                     precision=precision
                                     ).reshape(outr.shape)
            outi = outi + jnp.matmul(bi, Ta,
                                     precision=precision
                                     ).reshape(outi.shape)
            continue
        Tar = jnp.where(mj, qr[..., idx], 0).astype(rdtype)
        Tai = jnp.where(mj, qi[..., idx], 0).astype(rdtype)
        Tam = Tai - Tar
        Tap = Tai + Tar
        k1 = jnp.matmul(br + bi, Tar, precision=precision)
        k2 = jnp.matmul(br, Tam, precision=precision)
        k3 = jnp.matmul(bi, Tap, precision=precision)
        outr = outr + (k1 - k3).reshape(outr.shape)
        outi = outi + (k1 + k2).reshape(outi.shape)
    return outr, outi


def toeplitz_conv_planar(xr: jnp.ndarray, xi: jnp.ndarray,
                         h: jnp.ndarray):
    """Planar-boundary Toeplitz convolution: complex signal as (re, im)
    planes in and out — skips the interleaved complex pack/unpack that
    :func:`toeplitz_conv` pays at its boundary.  ``h`` real or complex.
    Returns (out_re, out_im)."""
    return _toeplitz_planar_impl(xr, xi, h, config.matmul_precision())


@functools.partial(jax.jit, static_argnames=("precision",))
def _toeplitz_planar_impl(xr, xi, h, precision: str):
    n = xr.shape[-1]
    m = h.shape[-1]
    start, length, c = _clip_kernel(n, m)
    fold = not isinstance(h, jax.core.Tracer) and not jnp.iscomplexobj(h)
    with jax.ensure_compile_time_eval() if fold else _nullcontext():
        h_eff = h[..., start:start + length]
        q = h_eff[..., ::-1]
    m_eff = length
    rdtype = jnp.result_type(xr.dtype,
                             jnp.zeros((), q.dtype).real.dtype)
    R = -(-n // 128)
    n_shifts = -(-(m_eff + 127) // 128)
    need = R * 128 + 128 * n_shifts
    k = (m_eff - c) % n if n else 0

    def ext_of(p):
        pieces = [p[..., n - k:]] if k else []
        remaining = need - k
        while remaining > 0:
            take = min(remaining, n)
            pieces.append(p[..., :take])
            remaining -= take
        return jnp.concatenate(pieces, axis=-1).astype(rdtype)

    outr, outi = _toeplitz_planes(ext_of(xr), ext_of(xi), q, fold, m_eff,
                                  R, n_shifts, xr.shape[:-1], rdtype,
                                  precision)
    return outr[..., :n], outi[..., :n]


def convolve_signal_planar(xr: jnp.ndarray, xi: jnp.ndarray,
                           h: jnp.ndarray, cfg=None):
    """Planar-boundary :func:`convolve_signal` for complex signals held
    as (re, im) planes (the library's program-boundary convention,
    ``_planar.py``).  The Toeplitz-eligible case runs fully planar; the
    FFT paths construct the complex view inside the trace (their FFTs
    need complex anyway).  Returns (out_re, out_im)."""
    from .. import config as _config
    cfg = cfg or _config.default_config()
    n = xr.shape[-1]
    m = h.shape[-1]
    if n > cfg.direct_conv_min_len and m <= cfg.direct_conv_max_imp_len:
        return toeplitz_conv_planar(xr, xi, h)
    out = convolve_signal(jax.lax.complex(xr, xi),
                          h, True, cfg)
    return jnp.real(out), jnp.imag(out)


def _toeplitz_body(x, h, precision: str):
    n = x.shape[-1]
    m = h.shape[-1]
    start, length, c = _clip_kernel(n, m)
    # fold must be decided on h BEFORE any jnp op touches it: jax 0.9
    # stages ops on constants, so even h[..., slice] of a concrete h
    # returns a tracer inside an enclosing trace.  Complex kernels stay
    # staged (their planes are split inside the trace below).
    fold = not isinstance(h, jax.core.Tracer) and not jnp.iscomplexobj(h)
    with jax.ensure_compile_time_eval() if fold else _nullcontext():
        h_eff = h[..., start:start + length]
        q = h_eff[..., ::-1]  # taps over forward offsets e = 0..m_eff-1
    m_eff = length
    dtype = jnp.result_type(x.dtype, q.dtype)
    R = -(-n // 128)
    n_shifts = -(-(m_eff + 127) // 128)  # row shifts needed: e up to m_eff-1
    # Need ext[i] = z[i mod n] with z[i] = x[(i - (m_eff - c)) mod n]: build
    # the wrapped extension directly from slices of x (no roll, no tile —
    # one concat materialization instead of two full copies).
    need = R * 128 + 128 * n_shifts
    k = (m_eff - c) % n if n else 0
    pieces = [x[..., n - k:]] if k else []
    remaining = need - k
    while remaining > 0:
        take = min(remaining, n)
        pieces.append(x[..., :take])
        remaining -= take
    ext = jnp.concatenate(pieces, axis=-1).astype(dtype)
    # Tap matrices: T_a[j, col] = q[128*a + j - col] where defined.  When
    # the kernel is CONCRETE (closure-constant taps, e.g. the flagship
    # chain / StreamingFir), fold the build at compile time — jax 0.9
    # stages jnp ops on constants into the program otherwise, and inside
    # a fori_loop the per-shift gather+select is re-executed every
    # iteration (XLA does not hoist it).
    j = np.arange(128)[:, None]
    col = np.arange(128)[None, :]
    if jnp.issubdtype(dtype, jnp.complexfloating):
        # PLANAR 3-dot Karatsuba complex path (see _toeplitz_planes):
        # a real-valued side lowers its imag plane to broadcast(0), which
        # XLA's algebraic simplifier removes from the dots.  Callers
        # already holding planes should use toeplitz_conv_planar.
        rdtype = jnp.zeros((), dtype).real.dtype
        extr = jnp.real(ext).astype(rdtype)
        exti = jnp.imag(ext).astype(rdtype)
        outr, outi = _toeplitz_planes(extr, exti, q, fold, m_eff, R,
                                      n_shifts, x.shape[:-1], rdtype,
                                      precision)
        return jax.lax.complex(outr, outi).astype(dtype)[..., :n]
    out = jnp.zeros(x.shape[:-1] + (R * 128,), dtype=dtype)
    for a in range(n_shifts):
        e = 128 * a + j - col
        mask = (e >= 0) & (e < m_eff)
        idx = np.where(mask, e, 0)

        def _mk_ta():
            return jnp.where(jnp.asarray(mask), q[..., idx], 0)

        if fold:
            with jax.ensure_compile_time_eval():
                Ta = _mk_ta()
        else:
            Ta = _mk_ta()
        Ta = Ta.astype(dtype)
        block = ext[..., 128 * a: 128 * a + R * 128].reshape(
            x.shape[:-1] + (R, 128))
        out = out + jnp.matmul(block, Ta,
                               precision=precision).reshape(out.shape)
    return out[..., :n]


def toeplitz_conv_multi(x: jnp.ndarray, taps: jnp.ndarray) -> jnp.ndarray:
    """Batched :func:`toeplitz_conv`: P kernels (``taps``: (P, m)) against
    ONE signal, returning the (..., P, n) stack of circular centered
    convolutions.

    All kernels share the signal geometry, so the wrapped extension is
    built once and the per-shift matmul becomes a single batched
    contraction against (P, 128, 128) tap matrices — this is the polyphase
    resampler's inner loop (P per-phase correlations, interp_ops), where P
    separate toeplitz_conv calls would rebuild the extension P times.
    """
    P, m = taps.shape
    n = x.shape[-1]
    start, length, c = _clip_kernel(n, m)
    fold = (not isinstance(taps, jax.core.Tracer)
            and not jnp.iscomplexobj(taps))  # see _toeplitz_body
    with jax.ensure_compile_time_eval() if fold else _nullcontext():
        q = taps[:, start:start + length][:, ::-1]
    m_eff = length
    dtype = jnp.result_type(x.dtype, q.dtype)
    R = -(-n // 128)
    n_shifts = -(-(m_eff + 127) // 128)
    need = R * 128 + 128 * n_shifts
    k = (m_eff - c) % n if n else 0
    pieces = [x[..., n - k:]] if k else []
    remaining = need - k
    while remaining > 0:
        take = min(remaining, n)
        pieces.append(x[..., :take])
        remaining -= take
    ext = jnp.concatenate(pieces, axis=-1).astype(dtype)
    j = np.arange(128)[:, None]
    col = np.arange(128)[None, :]
    out = jnp.zeros(x.shape[:-1] + (P, R * 128), dtype=dtype)
    for a in range(n_shifts):
        e = 128 * a + j - col
        mask = (e >= 0) & (e < m_eff)
        idx = np.where(mask, e, 0)

        def _mk_ta():
            return jnp.where(jnp.asarray(mask)[None], q[:, idx], 0)

        if fold:
            with jax.ensure_compile_time_eval():
                Ta = _mk_ta()
        else:
            Ta = _mk_ta()
        Ta = Ta.astype(dtype)  # staged cast — see _toeplitz_body
        block = ext[..., 128 * a: 128 * a + R * 128].reshape(
            x.shape[:-1] + (R, 128))
        out = out + jnp.einsum("...rk,pkl->...prl", block, Ta,
                               precision=config.matmul_precision()
                               ).reshape(out.shape)
    return out[..., :n]


def pick_fft_len(imp_len: int, requested: int = 0) -> int:
    """Block length for the blocked conv pipeline.

    The reference uses ``next_pow2(imp_len)`` raised to at least
    ``next_pow2(4*(imp_len-1))`` (convolution.rs:325-331/536) — sized for
    CPU caches.  The batched FFT pipeline prefers larger blocks (~32x the
    kernel, capped at 4096), where batched-FFT efficiency and the
    block-overlap overhead balance; ``autotune.calibrate`` times the
    candidates on the device in use.
    """
    min_len = next_power_of_two(4 * max(imp_len - 1, 1))
    if requested:
        return max(requested, min_len)
    preferred = min(next_power_of_two(32 * max(imp_len, 1)), 4096)
    return max(preferred, min_len)


def convolve_signal(x: jnp.ndarray, h: jnp.ndarray, is_complex: bool,
                    cfg=None) -> jnp.ndarray:
    """Dispatch mirroring the reference thresholds (convolution.rs:477-542):
    the reference's SIMD gate (len>1000, imp<=202) routes to the Toeplitz
    matmul path, the overlap-discard gate to the blocked-FFT pipeline,
    everything else to a whole-signal FFT."""
    from .. import config as _config
    cfg = cfg or _config.default_config()
    n = x.shape[-1]
    m = h.shape[-1]
    if n > cfg.direct_conv_min_len and m <= cfg.direct_conv_max_imp_len:
        return toeplitz_conv(x, h, is_complex)
    if (n > cfg.overlap_save_min_len and m > cfg.overlap_save_min_imp_len
            and n > cfg.overlap_save_len_ratio * m):
        fl = pick_fft_len(min(m, n), cfg.fft_block_len)
        return overlap_save(x, h, is_complex, fl)
    return convolve_signal_fft(x, h, is_complex)


def convolve_function(x: jnp.ndarray, fun, ratio: float, conv_len: int,
                      is_complex: bool) -> jnp.ndarray:
    """Convolution against an analytic impulse response
    (reference convolve_function_priv, time_freq/mod.rs:174-213)::

        L = min(conv_len, points)
        out[i] = sum_{s=-L..L} x[(i-s) mod n] * fun(s * ratio)

    The taps are sampled once as a vector and the result reduces to
    ``convolve_signal`` with a ``2L+1``-tap kernel scattered onto the circle
    (duplicate positions accumulate, reproducing the reference's multiple
    wrap-around of its WrappingIterator when ``2L+1 > n``).
    """
    n = x.shape[-1]
    L = min(conv_len, n)
    if getattr(fun, "_no_jit", False):
        # Host callback: sample at host-built (numpy) points — jnp builders
        # would hand it tracers.  The sampled taps enter the trace as
        # constants; _planar.call salts the jit cache per call so the
        # callback is re-evaluated like the reference's FFI path.
        s = np.arange(-L, L + 1, dtype=np.float64)
        taps = jnp.asarray(fun.calc(s * ratio))
    else:
        s = jnp.arange(-L, L + 1,
                       dtype=jnp.result_type(x.real.dtype, jnp.float32))
        taps = fun.calc(s * ratio)
    if is_complex:
        taps = taps.astype(jnp.result_type(taps.dtype, jnp.complex64))
    if 2 * L + 1 <= n:
        # The sampled kernel is a centered 2L+1-tap impulse response —
        # exactly convolve_signal's contract (h[s+L] = fun(s*ratio)), so it
        # rides the same dispatch (Toeplitz matmul for short kernels).
        return convolve_signal(x, taps, is_complex or
                               bool(jnp.iscomplexobj(taps)))
    # Tiny vectors where the window wraps multiple times: fold the taps
    # onto the circle with accumulation (the WrappingIterator semantics).
    g = jnp.zeros((n,), dtype=taps.dtype)
    g = g.at[jnp.arange(-L, L + 1) % n].add(taps)
    cdtype = jnp.result_type(x.dtype, g.dtype, jnp.complex64)
    out = jnp.fft.ifft(jnp.fft.fft(x.astype(cdtype), axis=-1)
                       * jnp.fft.fft(g.astype(cdtype), axis=-1), axis=-1)
    if is_complex or jnp.iscomplexobj(taps):
        return out
    return jnp.real(out).astype(x.dtype)


def fft_swap_x(is_fft_shifted: bool, x, x_max):
    """Maps an x-axis value the way fft_shift transforms the axis
    (reference time_freq/mod.rs:65-77)."""
    if not is_fft_shifted:
        return x / x_max
    return jnp.where(x <= 0, 1.0 + x / x_max, -((x_max - x + 1.0) / x_max))


def multiply_function(data: jnp.ndarray, fun_calc, ratio: float,
                      is_fft_shifted: bool,
                      is_symmetric: bool = True) -> jnp.ndarray:
    """Frequency-response multiplication
    (reference multiply_function_priv, time_freq/mod.rs:612-723)::

        data[index] *= ratio * fun(fft_swap_x(shifted, j, max) * ratio)

    For asymmetric responses ``j = index - (points - points%2)/2``
    (mod.rs:627-650).  For symmetric responses the reference walks the two
    halves as mirror pairs (mod.rs:651-722, via execute_sym_pairs) which
    amounts to ``j = -|index - points//2|`` — under the fft-shifted axis
    mapping this produces a *different, mirror-symmetric* response than the
    asymmetric walk (pinned by interpolatei goldens,
    interpolation.rs:653-678).
    """
    p = data.shape[-1]
    no_jit = getattr(getattr(fun_calc, "__self__", None), "_no_jit", False)
    offset = p % 2
    half = (p - offset) / 2.0
    if no_jit:
        # Host callback: sample points built on host (see convolve_function).
        i = np.arange(p, dtype=np.float64)
        j = -np.abs(i - p // 2) if is_symmetric else i - half
        if is_fft_shifted:
            xs = np.where(j <= 0, 1.0 + j / half, -((half - j + 1.0) / half))
        else:
            xs = j / half
        resp = jnp.asarray(fun_calc(xs * ratio))
    else:
        rdtype = jnp.zeros((), data.dtype).real.dtype
        i = jnp.arange(p, dtype=rdtype)
        if is_symmetric:
            j = -jnp.abs(i - p // 2)
        else:
            j = i - half
        x = fft_swap_x(is_fft_shifted, j,
                       jnp.asarray(half, dtype=rdtype)) * ratio
        resp = fun_calc(x)
    return data * (ratio * resp).astype(data.dtype)


def multiply_complex_exponential(data: jnp.ndarray, a: float, b: float,
                                 delta: float) -> jnp.ndarray:
    """x[i] *= exp(j*(a*delta*i + b*delta)) — the chirp/mixer primitive
    (reference complex_ops.rs:81-105; note the code scales *both* a and b by
    delta)."""
    n = data.shape[-1]
    i = jnp.arange(n, dtype=jnp.zeros((), data.dtype).real.dtype)
    phase = (a * delta) * i + (b * delta)
    return data * jnp.exp(1j * phase).astype(data.dtype)


def apply_linear_phase(freq: jnp.ndarray, delay: float) -> jnp.ndarray:
    """Linear phase on an *unshifted* spectrum == time delay (reference
    interpolation.rs:317-339): positive bins get phase ``inc*k`` for
    ``k=0..pos-1``; the trailing ``neg = points - points//2`` bins get
    ``inc*(k - neg)``."""
    p = freq.shape[-1]
    pos = p // 2
    neg = p - pos
    inc = 2.0 * jnp.pi * delay / p
    rdtype = jnp.zeros((), freq.dtype).real.dtype
    k = jnp.concatenate([jnp.arange(pos), jnp.arange(-neg, 0)]).astype(rdtype)
    return freq * jnp.exp(1j * inc * k).astype(freq.dtype)


def correlate(x: jnp.ndarray, prepared: jnp.ndarray) -> jnp.ndarray:
    """Cross-correlation against a prepared (FFT'd + conjugated) argument
    (reference correlation.rs:131-163): zero-pad Surround to the argument's
    length, multiply spectra, inverse transform, fftshift."""
    from . import reorg_ops
    p = prepared.shape[-1]
    padded = reorg_ops.zero_pad(x, p, "surround")
    out = jnp.fft.ifft(jnp.fft.fft(padded, axis=-1) * prepared, axis=-1)
    return jnp.fft.fftshift(out, axes=-1)


def prepare_argument(x: jnp.ndarray, padded: bool) -> jnp.ndarray:
    """Reference correlation.rs:96-118."""
    from . import reorg_ops
    if padded:
        n = x.shape[-1]
        x = reorg_ops.zero_pad(x, 2 * n - 1, "surround")
    return jnp.conj(jnp.fft.fft(x, axis=-1))
