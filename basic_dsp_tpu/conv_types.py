"""Analytic convolution kernels and lookup tables.

Behavioral parity with reference conv_types.rs (RaisedCosineFunction
conv_types.rs:390-460, SincFunction conv_types.rs:462-518, linear-interpolated
lookup tables conv_types.rs:66-388).  All ``calc`` functions here are
*vectorized*: they take a jnp array of x positions and return an array, so a
whole tap set evaluates as one fused XLA expression — the reference instead
calls ``calc`` per tap inside its MAC loops.

Convention: objects expose ``calc(x)`` for the time-domain (impulse response)
role and ``calc_freq(x)`` for the frequency-domain (frequency response) role,
matching the reference's pair of trait impls on the same struct.  Lookup-table
types implement only the role they represent.
"""
from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np


class _ValueIdentity:
    """Value-based identity for analytic kernels: jit caches key traced
    programs on the kernel object (vector._jit_static), so equal-valued
    instances must hash equal or every ``bd.SincFunction()`` construction
    recompiles its consumers."""

    def _key(self):
        return (type(self),)

    def __eq__(self, other):
        return isinstance(other, _ValueIdentity) and self._key() == other._key()

    def __hash__(self):
        return hash(self._key())


class RealImpulseResponse(_ValueIdentity):
    """Time-domain, real-valued convolution function (conv_types.rs:15-25)."""

    is_symmetric: bool = True
    #: Real-valued ``calc`` output: taps are folded eagerly at trace time
    #: (``jax.ensure_compile_time_eval``) only for real-valued functions.
    #: ``None`` on unknown/user classes means "assume unsafe, stay
    #: staged".
    _complex_valued: bool = False

    def calc(self, x):
        raise NotImplementedError


class RealFrequencyResponse(_ValueIdentity):
    """Frequency-domain, real-valued response (conv_types.rs:28-38)."""

    is_symmetric: bool = True
    _complex_valued: bool = False

    def calc_freq(self, x):
        raise NotImplementedError


class RaisedCosineFunction(RealImpulseResponse, RealFrequencyResponse):
    """Raised cosine pulse (reference conv_types.rs:390-460).

    ``calc``: time-domain impulse response with singularity handling at
    ``x == 0`` and ``|x| == 1/(2*rolloff)``.
    ``calc_freq``: piecewise frequency response assuming ``x_delta == 1``.
    """

    def __init__(self, rolloff: float):
        self.rolloff = float(rolloff)

    def _key(self):
        return (type(self), self.rolloff)

    def calc(self, x):
        x = jnp.asarray(x)
        r = jnp.asarray(self.rolloff, dtype=x.dtype)
        pi = jnp.pi
        pi_x = pi * x
        arg = 2.0 * r * x
        # Where denominators vanish substitute a safe value, then patch with
        # the analytic limits (same special cases as the reference).
        denom = pi_x * (1.0 - arg * arg)
        at_zero = x == 0
        at_pole = jnp.abs(jnp.abs(arg) - 1.0) < 1e-12
        safe_denom = jnp.where(at_zero | at_pole, 1.0, denom)
        general = jnp.sin(pi_x) * jnp.cos(pi_x * r) / safe_denom
        pole_arg = pi / 2.0 / r
        pole_value = jnp.sin(pole_arg) / pole_arg * pi / 4.0
        return jnp.where(at_zero, 1.0, jnp.where(at_pole, pole_value, general))

    def calc_freq(self, x):
        x = jnp.asarray(x)
        r = jnp.asarray(self.rolloff, dtype=x.dtype)
        ax = jnp.abs(x)
        pi = jnp.pi
        transition = 0.5 * (1.0 + jnp.cos(pi / r * (ax - (1.0 - r)) / 2.0))
        return jnp.where(
            ax <= (1.0 - r),
            jnp.ones_like(ax),
            jnp.where(ax <= (1.0 + r), transition, jnp.zeros_like(ax)),
        )


class SincFunction(RealImpulseResponse, RealFrequencyResponse):
    """sinc pulse (reference conv_types.rs:462-518).

    ``calc``: ``sin(pi x)/(pi x)`` with ``calc(0) == 1``.
    ``calc_freq``: ideal lowpass — 1 for ``|x| <= 1`` else 0.
    """

    def calc(self, x):
        x = jnp.asarray(x)
        return jnp.sinc(x)

    def calc_freq(self, x):
        x = jnp.asarray(x)
        return jnp.where(jnp.abs(x) <= 1.0, 1.0, 0.0).astype(
            jnp.result_type(x, jnp.float32))


class ComplexImpulseResponse(_ValueIdentity):
    """Time-domain complex convolution function (conv_types.rs:41-51)."""

    is_symmetric: bool = False
    _complex_valued: bool = True

    def calc(self, x):
        raise NotImplementedError


class ComplexFrequencyResponse(_ValueIdentity):
    """Frequency-domain complex response (conv_types.rs:54-64)."""

    is_symmetric: bool = False
    _complex_valued: bool = True

    def calc_freq(self, x):
        raise NotImplementedError


def _lut_lookup(table, delta: float, x):
    """Linear interpolation between table bins.

    Parity with reference conv_types.rs:127-181: position is mapped via
    ``x/delta + center``; out-of-range (``round >= len`` or the *unclamped*
    neighbor falling outside) returns 0 / the edge bin exactly as the scalar
    logic does.
    """
    # Tables arrive as HOST numpy (see _LinearTableLookup); the conversion
    # stages the (possibly complex) constant inside an enclosing trace.
    table = jnp.asarray(table)
    x = jnp.asarray(x)
    length = table.shape[0]
    center = length // 2
    pos = x / jnp.asarray(delta, dtype=x.dtype) + center
    rounded = jnp.round(pos)
    ridx = rounded.astype(jnp.int32)
    out_of_range = (ridx >= length) | (ridx < 0)
    safe_ridx = jnp.clip(ridx, 0, length - 1)
    y0 = table[safe_ridx]
    # Neighbor toward the fractional side.
    frac = pos - rounded
    step = jnp.where(frac > 0, 1, -1).astype(jnp.int32)
    nidx = safe_ridx + step
    neighbor_valid = (nidx >= 0) & (nidx < length)
    safe_nidx = jnp.clip(nidx, 0, length - 1)
    y1 = table[safe_nidx]
    interp = y0 + (y1 - y0) * jnp.abs(frac).astype(table.dtype)
    exactly_at_bin = jnp.abs(frac) < 1e-6
    value = jnp.where(exactly_at_bin | ~neighbor_valid, y0, interp)
    return jnp.where(out_of_range, jnp.zeros_like(value), value)


class _LinearTableLookup:
    """Shared base for the four lookup-table flavors (conv_types.rs:66-124)."""

    def __init__(self, table, delta: float, is_symmetric: bool):
        # The table lives on the HOST as numpy: numpy tables stage cleanly
        # as constants inside traces (_lut_lookup) and convert lazily
        # elsewhere, and the construction-time transforms
        # (to_complex/fft/ifft) run in numpy so building complex kernels
        # never touches the device.
        self._table = np.asarray(jax.device_get(table))
        self._delta = float(delta)
        self.is_symmetric = bool(is_symmetric)
        self._value_hash = hash((type(self), self._delta, self.is_symmetric,
                                 self._table.tobytes()))

    def _key(self):
        return (type(self), self._value_hash)

    @property
    def table(self):
        return self._table

    @property
    def delta(self) -> float:
        return self._delta

    def _calc(self, x):
        return _lut_lookup(self._table, self._delta, x)

    @classmethod
    def _from_function(cls, fun, delta: float, length: int, freq: bool,
                       to_complex: bool):
        """``from_conv_function`` (reference conv_types.rs:198-211):
        samples ``2*len+1`` points at ``i*delta`` for ``i in -len..len``."""
        i = np.arange(-length, length + 1)
        x = jnp.asarray(i * float(delta))
        values = np.asarray(jax.device_get(
            fun.calc_freq(x) if freq else fun.calc(x)))
        if to_complex:
            values = values.astype(np.result_type(values.dtype,
                                                  np.complex64))
        return cls(values, delta, fun.is_symmetric)


class RealTimeLinearTableLookup(_LinearTableLookup, RealImpulseResponse):
    def calc(self, x):
        return self._calc(x)

    @classmethod
    def from_conv_function(cls, fun: RealImpulseResponse, delta: float,
                           length: int) -> "RealTimeLinearTableLookup":
        return cls._from_function(fun, delta, length, freq=False,
                                  to_complex=False)

    @classmethod
    def from_raw_parts(cls, table, delta, is_symmetric):
        return cls(table, delta, is_symmetric)

    def to_complex(self) -> "ComplexTimeLinearTableLookup":
        """conv_types.rs:223-253 — re-tag the real table as complex."""
        return ComplexTimeLinearTableLookup(
            self._table.astype(np.result_type(self._table.dtype,
                                              np.complex64)),
            self._delta, self.is_symmetric)

    def fft(self) -> "RealFrequencyLinearTableLookup":
        """conv_types.rs:323-354 — magnitude spectrum of the table.
        Host numpy (== fft_ops.fft_shifted semantics): construction-time
        transforms never touch the device — see _LinearTableLookup."""
        n = self._table.shape[0]
        freq = np.fft.fftshift(np.fft.fft(self._table))
        new_delta = self._delta * n
        return RealFrequencyLinearTableLookup(
            np.abs(freq).astype(self._table.dtype), new_delta,
            self.is_symmetric)


class RealFrequencyLinearTableLookup(_LinearTableLookup, RealFrequencyResponse):
    def calc_freq(self, x):
        return self._calc(x)

    @classmethod
    def from_conv_function(cls, fun: RealFrequencyResponse, delta: float,
                           length: int) -> "RealFrequencyLinearTableLookup":
        return cls._from_function(fun, delta, length, freq=True,
                                  to_complex=False)

    @classmethod
    def from_raw_parts(cls, table, delta, is_symmetric):
        return cls(table, delta, is_symmetric)

    def to_complex(self) -> "ComplexFrequencyLinearTableLookup":
        return ComplexFrequencyLinearTableLookup(
            self._table.astype(np.result_type(self._table.dtype,
                                              np.complex64)),
            self._delta, self.is_symmetric)


class ComplexTimeLinearTableLookup(_LinearTableLookup, ComplexImpulseResponse):
    def calc(self, x):
        return self._calc(x)

    @classmethod
    def from_conv_function(cls, fun: ComplexImpulseResponse, delta: float,
                           length: int) -> "ComplexTimeLinearTableLookup":
        return cls._from_function(fun, delta, length, freq=False,
                                  to_complex=True)

    @classmethod
    def from_raw_parts(cls, table, delta, is_symmetric):
        return cls(table, delta, is_symmetric)

    def to_real(self) -> RealTimeLinearTableLookup:
        """conv_types.rs:255-287 — drop imaginary parts."""
        return RealTimeLinearTableLookup(self._table.real, self._delta,
                                         self.is_symmetric)

    def fft(self) -> "ComplexFrequencyLinearTableLookup":
        """conv_types.rs:289-321 — FFT (with fft shift) of the table, in
        host numpy (== fft_ops.fft_shifted semantics)."""
        n = self._table.shape[0]
        freq = np.fft.fftshift(np.fft.fft(self._table)).astype(
            self._table.dtype)
        return ComplexFrequencyLinearTableLookup(freq, self._delta * n,
                                                 self.is_symmetric)


class ComplexFrequencyLinearTableLookup(_LinearTableLookup,
                                        ComplexFrequencyResponse):
    def calc_freq(self, x):
        return self._calc(x)

    @classmethod
    def from_conv_function(cls, fun: ComplexFrequencyResponse, delta: float,
                           length: int) -> "ComplexFrequencyLinearTableLookup":
        return cls._from_function(fun, delta, length, freq=True,
                                  to_complex=True)

    @classmethod
    def from_raw_parts(cls, table, delta, is_symmetric):
        return cls(table, delta, is_symmetric)

    def to_real(self) -> RealFrequencyLinearTableLookup:
        return RealFrequencyLinearTableLookup(self._table.real,
                                              self._delta, self.is_symmetric)

    def ifft(self) -> ComplexTimeLinearTableLookup:
        """conv_types.rs:356-388 — inverse FFT of the table, in host
        numpy (== fft_ops.ifft_shifted semantics: 1/N-scaled inverse of
        the pre-shifted spectrum)."""
        n = self._table.shape[0]
        time = np.fft.ifft(np.fft.ifftshift(self._table)).astype(
            self._table.dtype)
        return ComplexTimeLinearTableLookup(time, self._delta * n,
                                            self.is_symmetric)
