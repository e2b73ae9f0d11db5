"""Plain numpy float64 realizations of the benchmark chains' semantics.

Each function restates the reference crate's definition directly, with no
code shared with the device paths, so tests and ``chip_smoke.py`` can
compare the library against it.  Inputs may be any numpy dtype; the
arithmetic runs in float64/complex128.
"""
from __future__ import annotations

import numpy as np


def sinc(x):
    """sin(pi x)/(pi x), 1 at 0 (conv_types.rs:462-518)."""
    return np.sinc(np.asarray(x, np.float64))


def raised_cosine(rolloff: float):
    """The raised-cosine impulse response (conv_types.rs:390-460) as a
    numpy function of float64 arguments."""
    r = float(rolloff)

    def calc(x):
        x = np.asarray(x, np.float64)
        arg = 2.0 * r * x
        at_pole = np.abs(np.abs(arg) - 1.0) < 1e-12
        denom = np.where(at_pole, 1.0, 1.0 - arg * arg)
        pole = np.sin(np.pi / 2.0 / r) / (np.pi / 2.0 / r) * np.pi / 4.0
        return np.where(at_pole, pole, np.sinc(x) * np.cos(np.pi * r * x)
                        / denom)

    return calc


def convolve_circular_centered(x, h):
    """The centered circular convolution of ``convolve_signal``
    (time_freq/mod.rs:275-361) for ``len(h) <= len(x)``::

        out[i] = sum_k x[(i + c - 1 - k) mod n] * h[k],  c = ceil(m/2)

    evaluated as a product of float64 spectra."""
    x = np.asarray(x)
    h = np.asarray(h)
    n, m = x.shape[-1], h.shape[-1]
    c = m - m // 2
    g = np.zeros(n, np.result_type(h.dtype, np.float64))
    g[:m] = h
    g = np.roll(g, -(c - 1))
    out = np.fft.ifft(np.fft.fft(x.astype(np.complex128))
                      * np.fft.fft(g.astype(np.complex128)))
    if np.iscomplexobj(x) or np.iscomplexobj(h):
        return out
    return out.real


def shifted_spectrum_mag(x):
    """|fftshift(FFT(x))| (time_to_freq.rs:158-165 + magnitude)."""
    return np.abs(np.fft.fftshift(np.fft.fft(
        np.asarray(x).astype(np.complex128))))


def interpolatef(x, fun, factor: float, delay: float, conv_len: int,
                 delta: float = 1.0):
    """The reference's scalar interpolatef loop (interpolation.rs:92-131,
    387-482), vectorized over outputs::

        center = i / factor; r = floor(center)
        out[i] = sum_{t=0..2L} x[(r - L + t) mod n]
                     * fun(t - L - (center - r) + delay)
    """
    x = np.asarray(x)
    n = len(x)
    delay = delay / delta
    L = min(conv_len, n // 2)
    is_c = np.iscomplexobj(x)
    new_len = int(round(n * (2 if is_c else 1) * factor))
    new_len += new_len % 2
    pts = new_len // 2 if is_c else new_len
    xs = x.astype(np.complex128 if is_c else np.float64)
    center = np.arange(pts, dtype=np.float64) / factor
    r = np.floor(center)
    frac = center - r
    base = r.astype(np.int64) - L
    out = np.zeros(pts, xs.dtype)
    for t in range(2 * L + 1):
        out += xs[(base + t) % n] * fun(t - L - frac + delay)
    return out


def polyphase_filterbank(x, prototype, n_channels: int):
    """Critically sampled analysis filterbank from its definition: channel
    k at row s is the prototype-filtered signal, modulated by
    exp(-2 pi i m k / C) per tap m, decimated by C::

        y[s, k] = sum_m h[m] x[s*C - m] exp(-2 pi i m k / C)   (x[<0] = 0)

    Returns y, shape (len(x) // C, C)."""
    x = np.asarray(x).astype(np.complex128)
    h = np.asarray(prototype, np.float64)
    C = n_channels
    S = len(x) // C
    s = np.arange(S)[:, None]
    p = np.arange(C)[None, :]
    # Taps m = p + r*C share the modulation exp(-2 pi i p k / C):
    # A[s, p] = sum_r h[p + r*C] * x[(s - r)*C - p], then a DFT over p.
    A = np.zeros((S, C), np.complex128)
    for r in range(-(-len(h) // C)):
        m = p + r * C
        idx = (s - r) * C - p
        hm = np.where(m < len(h), h[np.minimum(m, len(h) - 1)], 0.0)
        A += hm * np.where(idx >= 0, x[np.maximum(idx, 0)], 0)
    return np.fft.fft(A, axis=1)


def channelize_and_demod(x, prototype, n_channels: int):
    """:func:`polyphase_filterbank` followed by per-channel FM demod::

        z[s, k] = y[s, k] * conj(y[s - 1, k])      (y[-1] := y[0])

    Returns (angle(z).T, |z|.T), each (C, len(x) // C)."""
    y = polyphase_filterbank(x, prototype, n_channels)
    prev = np.concatenate([y[:1], y[:-1]], axis=0)
    z = y * np.conj(prev)
    return np.angle(z).T, np.abs(z).T


def wrapped_angle_error(got, want_angle, want_amp):
    """Error of an angle output scaled by the magnitude it is the angle of:
    max |wrap(got - want)| * |z| / max |z|.  Angles of near-zero products
    carry no phase to disagree about, so they are weighted down."""
    d = np.abs(np.angle(np.exp(1j * (np.asarray(got, np.float64)
                                     - want_angle))))
    return float((d * want_amp).max() / want_amp.max())


def max_rel_err(got, want) -> float:
    """max |got - want| / max |want|."""
    got = np.asarray(got)
    want = np.asarray(want)
    if got.shape != want.shape:
        raise ValueError(f"shape {got.shape} != {want.shape}")
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-300))
