"""The typed DSP vector layer.

This is the JAX re-design of the reference's ``DspVec<S, T, N, D>``
type-state machine (vector_types/mod.rs:125-140): one internal representation
— a jnp array (complex dtype for complex vectors — the reference's
interleaved-float layout disappears) plus metadata ``(domain, number_space,
delta)`` — wrapped by five flavors:

* :class:`RealTimeVector`, :class:`RealFreqVector`,
  :class:`ComplexTimeVector`, :class:`ComplexFreqVector`: operations invalid
  for the flavor raise :class:`~basic_dsp_tpu.errors.DspError` (the Python
  analog of the reference's compile-time checks).
* :class:`GenDspVector`: runtime-tracked flavor; invalid operations follow
  the reference's erroneous-vector protocol (``valid_len == 0``,
  ``delta == NaN``, vector_types/mod.rs:226-229) instead of raising.

Vectors are **immutable**: every operation returns a new vector (the
reference's ``&mut self``/consuming-self API maps onto rebinding).  Vectors
are registered as jax pytrees, so whole chains can be wrapped in ``jax.jit``
and fuse into single XLA programs — this subsumes the reference's removed
``combined_ops`` layer (Changelog.md:77) for free.
"""
from __future__ import annotations

import math
from typing import Callable, List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from . import config as _config
from . import _planar
from ._planar import PlanarComplex
from .errors import DspError, ErrorReason
from .meta import DataDomain, NumberSpace
from .ops import approx_ops, conv_ops, fft_ops, interp_ops, reorg_ops, \
    stats_ops
from .windows import WindowFunction

__all__ = [
    "DspVector", "RealTimeVector", "RealFreqVector", "ComplexTimeVector",
    "ComplexFreqVector", "GenDspVector",
    "to_real_time_vec", "to_real_freq_vec", "to_complex_time_vec",
    "to_complex_freq_vec", "to_gen_dsp_vec",
    "interleave_to_complex_time_vec", "interleave_to_complex_freq_vec",
]


def _real_dtype_of(arr) -> jnp.dtype:
    return _planar.real_dtype_of(arr)


# ----------------------------------------------------------------------
# Module-level op functions + jit caches.  Ops run under jit even from the
# "eager" vector API: jit fuses and caches per shape.
# Functions must be module-level so the lru_cache keys stay stable.
# ----------------------------------------------------------------------
import functools as _functools
import operator as _operator


# All device computation funnels through _planar.call: a cached jit with
# planar complex pack/unpack at the program boundary (see _planar.py).
def _jit_unary(fn):
    return lambda x: _planar.call(fn, x)


def _jit_unary_arg(fn):
    return lambda x, arg: _planar.call(fn, x, arg)


def _jit_binary(fn):
    return lambda a, b: _planar.call(fn, a, b)


def _jit_unary_static(fn):
    return lambda x, st: _planar.call(fn, x, static=(st,))


def _jit_static(fn, *static):
    """``fn(*arrays, *static)`` under the planar-aware cached jit."""
    return lambda *arrays: _planar.call(fn, *arrays, static=static)


def _square(x):
    return x * x


def _root(x, degree):
    return x ** (1.0 / degree)


def _powf(x, exponent):
    return x ** exponent


def _logbase(x, base):
    return jnp.log(x) / jnp.log(base)


def _expf(x, base):
    return base ** x


def _fmod(x, divisor):
    return jnp.fmod(x, divisor)


def _unwrap(x, divisor):
    d = jnp.diff(x)
    jumps = jnp.round(d / divisor)
    corr = jnp.cumsum(-jumps * divisor)
    return jnp.concatenate([x[..., :1], x[..., 1:] + corr], axis=-1)


def _mag_sq(x):
    return jnp.real(x) ** 2 + jnp.imag(x) ** 2


def _scale(x, factor):
    return x * factor


def _offset(x, off):
    return x + off


def _diff_with_start(x):
    return jnp.concatenate([x[..., :1], jnp.diff(x, axis=-1)], axis=-1)


def _diff(x):
    return jnp.diff(x, axis=-1)


def _cumsum(x):
    return jnp.cumsum(x, axis=-1)


def _combine_real_imag(re, im):
    cdtype = jnp.result_type(re.dtype, jnp.complex64)
    return re.astype(cdtype) + 1j * im.astype(cdtype)


def _tiled_binary(a, b, op, reps):
    return op(a, jnp.tile(b, reps))


def _setitem_impl(x, value, key):
    return x.at[key if len(key) > 1 else key[0]].set(value)


def _setitem_dynamic(x, value, idx):
    """Shared jit program for integer-index writes: the index travels as a
    device argument, so per-sample mutation loops (the reference
    ``FloatIndexMut`` idiom, vec_impl_and_indexers.rs:16-64) compile ONCE
    instead of once per distinct index (``static=(key,)`` would trace a
    new program per index and could evict the shared program cache)."""
    v = jnp.asarray(value).astype(x.dtype).reshape((1,) * x.ndim)
    return jax.lax.dynamic_update_slice(
        x, v, tuple(idx[d] for d in range(x.ndim)))


def _complex_to_interleaved(x):
    inter = jnp.stack([jnp.real(x), jnp.imag(x)], axis=-1)
    return inter.reshape(x.shape[:-1] + (2 * x.shape[-1],))


def _interleaved_to_complex(x):
    n = x.shape[-1] - x.shape[-1] % 2
    pairs = x[..., :n].reshape(x.shape[:-1] + (n // 2, 2))
    cdtype = jnp.result_type(x.dtype, jnp.complex64)
    return pairs[..., 0].astype(cdtype) + 1j * pairs[..., 1].astype(cdtype)


def _combine_mag_phase(mag, phase):
    cdtype = jnp.result_type(mag.dtype, jnp.complex64)
    return mag.astype(cdtype) * jnp.exp(1j * phase.astype(cdtype))


def _window_mul(x, w):
    return x * w.astype(x.dtype)


def _astype(x, dtype_name):
    return x.astype(dtype_name)


def _window_div(x, w):
    return x / w.astype(x.dtype)


def _dc_parts(x):
    return jnp.stack([jnp.imag(x[..., 0]), jnp.real(x[..., 0])])


def _sifft_core(x):
    mirrored = fft_ops.mirror(x)
    return jnp.real(fft_ops.plain_ifft(mirrored))


def _map_with_idx(x, fn, argument):
    return fn(x, jnp.arange(x.shape[-1]), argument)


def _merge_stack(*arrs):
    from .ops import reorg_ops as _reorg
    return _reorg.merge(jnp.stack(arrs))


def _resize(x, points):
    n = x.shape[-1]
    if points <= n:
        return x[..., :points]
    widths = [(0, 0)] * (x.ndim - 1) + [(0, points - n)]
    return jnp.pad(x, widths)


class DspVector:
    """Base class holding data + metadata.  See module docstring."""

    # Class-level flavor constraints; None == tracked at runtime (Gen).
    _SPACE: Optional[NumberSpace] = None
    _DOMAIN: Optional[DataDomain] = None
    _NDIM = 1  # matrices (channel stacks) override with 2

    def __init__(self, data, delta: float = 1.0,
                 domain: Optional[DataDomain] = None,
                 space: Optional[NumberSpace] = None):
        if not isinstance(data, PlanarComplex):
            if isinstance(data, (np.ndarray, list, tuple)) \
                    and np.iscomplexobj(np.asarray(data)):
                host = np.asarray(data)
                data = _planar.from_host_complex(
                    np.ascontiguousarray(host.real),
                    np.ascontiguousarray(host.imag))
            else:
                host = np.asarray(data) if isinstance(
                    data, (np.ndarray, list, tuple)) else data
                data = jnp.asarray(host)
        if data.ndim != self._NDIM:
            raise ValueError(
                f"{type(self).__name__} expects {self._NDIM}-D data; "
                "use the matrix types for channel stacks")
        space = space or self._SPACE
        domain = domain or self._DOMAIN
        if space is None or domain is None:
            raise ValueError("GenDspVector requires explicit domain and space")
        if space == NumberSpace.COMPLEX and not _planar.is_complex_repr(data):
            cdtype = jnp.result_type(data.dtype, jnp.complex64)
            data = _jit_unary_static(_astype)(data, jnp.dtype(cdtype).name)
        if space == NumberSpace.REAL and _planar.is_complex_repr(data):
            raise ValueError("real vector constructed from complex data")
        self._data = data
        self._delta = float(delta)
        self._domain = domain
        self._space = space

    # ------------------------------------------------------------------
    # Construction helpers
    # ------------------------------------------------------------------
    @classmethod
    def _flavor_class(cls, space: NumberSpace, domain: DataDomain):
        return _FLAVORS[(space, domain)]

    @classmethod
    def _gen_class(cls):
        return GenDspVector

    def _is_gen(self) -> bool:
        return type(self)._SPACE is None

    def _make(self, data, delta: Optional[float] = None,
              domain: Optional[DataDomain] = None,
              space: Optional[NumberSpace] = None) -> "DspVector":
        """Builds a result vector, keeping gen-ness of self."""
        domain = domain or self._domain
        space = space or self._space
        delta = self._delta if delta is None else delta
        if self._is_gen():
            return self._gen_class()(data, delta, domain, space)
        return self._flavor_class(space, domain)(data, delta)

    def _invalid(self, reason: ErrorReason,
                 domain: Optional[DataDomain] = None,
                 space: Optional[NumberSpace] = None) -> "DspVector":
        """Erroneous-vector protocol (reference vector_types/mod.rs:226-229)
        for Gen vectors; typed flavors raise instead."""
        if self._is_gen():
            space = space or self._space
            rdtype = _real_dtype_of(self._data)
            shape = (0,) if self._NDIM == 1 else (self._data.shape[0], 0)
            if space == NumberSpace.COMPLEX and _planar.planar_mode():
                data = PlanarComplex(jnp.zeros(shape, dtype=rdtype),
                                     jnp.zeros(shape, dtype=rdtype))
            elif space == NumberSpace.COMPLEX:
                data = jnp.zeros(shape,
                                 dtype=jnp.result_type(rdtype, jnp.complex64))
            else:
                data = jnp.zeros(shape, dtype=rdtype)
            return self._gen_class()(data, float("nan"),
                                     domain or self._domain, space)
        raise DspError(reason)

    # ------------------------------------------------------------------
    # Vector trait (reference vec_impl_and_indexers.rs:100-147)
    # ------------------------------------------------------------------
    @property
    def array(self) -> jnp.ndarray:
        """The underlying device array (complex dtype for complex vectors).

        In planar-complex mode this materializes the complex view eagerly —
        prefer :meth:`to_numpy` on runtimes without complex support."""
        return _planar.unwrap(self._data)

    def delta(self) -> float:
        """Sample spacing (x-axis step; becomes rbw after an FFT)."""
        return self._delta

    def with_delta(self, delta: float) -> "DspVector":
        return self._make(self._data, delta=delta)

    def domain(self) -> DataDomain:
        return self._domain

    def is_complex(self) -> bool:
        return self._space == NumberSpace.COMPLEX

    def points(self) -> int:
        """Number of (real or complex) data points
        (reference vec_impl_and_indexers.rs:275-277)."""
        return int(self._data.shape[-1])

    def __len__(self) -> int:
        """Length in float elements, like the reference's ``len()``
        (2x points for complex vectors)."""
        return self.points() * (2 if self.is_complex() else 1)

    def __bool__(self) -> bool:
        """Vectors are always truthy.  Without this, an *erroneous* Gen
        vector (len 0) is falsy and guard chains like
        ``self._check(...) or self._check(...)`` silently drop the invalid
        result, letting wrong-flavor ops execute."""
        return True

    def is_erroneous(self) -> bool:
        """Reference vector_types/mod.rs:209-216."""
        return self.points() == 0 and math.isnan(self._delta)

    def to_numpy(self) -> np.ndarray:
        """Device -> host copy.  Complex data transfers as two real
        planes."""
        return _planar.to_host(self._data)

    def __getitem__(self, idx):
        return self.to_numpy()[idx]

    def __setitem__(self, idx, value):
        """Sample mutation (reference ``FloatIndexMut``/``ComplexIndexMut``,
        vec_impl_and_indexers.rs:16-64): ``vec[i] = value`` rebinds the
        underlying array to a functionally-updated copy (``.at[].set`` —
        arrays are immutable in jax; XLA turns the single-element update
        into an in-place donation when it can).  ``idx`` may be an int, a
        slice, or a tuple of those (matrix layer)."""
        if not isinstance(idx, (int, np.integer, slice, tuple)):
            raise TypeError("index must be an int, slice or tuple thereof")
        if isinstance(idx, tuple) and not all(
                isinstance(i, (int, np.integer, slice)) for i in idx):
            raise TypeError("tuple index entries must be ints or slices")
        if isinstance(value, np.ndarray):
            if np.iscomplexobj(value):
                value = _planar.from_host_complex(
                    np.ascontiguousarray(value.real),
                    np.ascontiguousarray(value.imag))
            else:
                value = jnp.asarray(value)
        elif isinstance(value, (int, float)) and self.is_complex():
            value = complex(value)
        key = idx if isinstance(idx, tuple) else (idx,)
        if (len(key) == self._data.ndim
                and all(isinstance(i, (int, np.integer)) for i in key)
                and not isinstance(value, (np.ndarray, jax.Array,
                                           _planar.PlanarComplex))):
            # Pure integer index + scalar value: one shared program, the
            # index rides as a device argument (see _setitem_dynamic).
            norm = []
            for i, n in zip(key, self._data.shape):
                j = int(i) + (n if int(i) < 0 else 0)
                if not 0 <= j < n:
                    raise IndexError(
                        f"index {i} out of range for axis of size {n}")
                norm.append(j)
            self._data = _planar.call(
                _setitem_dynamic, self._data, value,
                jnp.asarray(np.asarray(norm, np.int32)))
            return
        self._data = _planar.call(_setitem_impl, self._data, value,
                                  static=(key,))

    def interleaved(self) -> np.ndarray:
        """Interleaved float view ([re0, im0, re1, im1, …] for complex) —
        the reference's raw ``data(..)`` layout, for test parity."""
        arr = self.to_numpy()
        if self.is_complex():
            out = np.empty(2 * arr.shape[0], dtype=arr.real.dtype)
            out[0::2] = arr.real
            out[1::2] = arr.imag
            return out
        return arr

    def __repr__(self):
        return (f"{type(self).__name__}(points={self.points()}, "
                f"domain={self._domain.value}, "
                f"complex={self.is_complex()}, delta={self._delta})")

    # ------------------------------------------------------------------
    # Flavor checks
    # ------------------------------------------------------------------
    def _check(self, *, complex_: Optional[bool] = None,
               domain: Optional[DataDomain] = None,
               reason: Optional[ErrorReason] = None):
        """Returns None if ok, else an invalid vector / raises."""
        if complex_ is not None and self.is_complex() != complex_:
            r = (ErrorReason.INPUT_MUST_BE_COMPLEX if complex_
                 else ErrorReason.INPUT_MUST_BE_REAL)
            return self._invalid(reason or r)
        if domain is not None and self._domain != domain:
            r = (ErrorReason.INPUT_MUST_BE_IN_TIME_DOMAIN
                 if domain == DataDomain.TIME
                 else ErrorReason.INPUT_MUST_BE_IN_FREQUENCY_DOMAIN)
            return self._invalid(reason or r)
        return None

    def _check_delta(self, other: "DspVector"):
        """Sample spacings must agree within 10% for convolution
        (reference assert_meta_data!, convolution.rs:257-268)."""
        ratio = self._delta / other._delta if other._delta else float("inf")
        if ratio > 1.1 or ratio < 0.9:
            return self._invalid(ErrorReason.INPUT_META_DATA_MUST_AGREE)
        return None

    def _binary_check(self, other: "DspVector", same_size=True):
        if (self.is_complex() != other.is_complex()
                or self._domain != other._domain):
            return self._invalid(ErrorReason.INPUT_META_DATA_MUST_AGREE)
        if same_size and self.points() != other.points():
            return self._invalid(ErrorReason.INPUT_MUST_HAVE_THE_SAME_SIZE)
        return None

    # ------------------------------------------------------------------
    # Elementary ops (reference general/elementary.rs)
    # ------------------------------------------------------------------
    def add(self, other: "DspVector") -> "DspVector":
        return self._binary_check(other) or self._make(
            _jit_binary(_operator.add)(self._data, other._data))

    def sub(self, other: "DspVector") -> "DspVector":
        return self._binary_check(other) or self._make(
            _jit_binary(_operator.sub)(self._data, other._data))

    def mul(self, other: "DspVector") -> "DspVector":
        return self._binary_check(other) or self._make(
            _jit_binary(_operator.mul)(self._data, other._data))

    def div(self, other: "DspVector") -> "DspVector":
        return self._binary_check(other) or self._make(
            _jit_binary(_operator.truediv)(self._data, other._data))

    def _smaller_op(self, other: "DspVector", op) -> "DspVector":
        bad = self._binary_check(other, same_size=False)
        if bad is not None:
            return bad
        if other.points() == 0 or self.points() % other.points() != 0:
            return self._invalid(ErrorReason.INVALID_ARGUMENT_LENGTH)
        reps = self.points() // other.points()
        # Through the planar funnel (module-level fn + static op/reps keep
        # the jit cache stable): eager jnp.tile on PlanarComplex raises.
        return self._make(_jit_static(_tiled_binary, op, reps)(
            self._data, other._data))

    def add_smaller(self, other: "DspVector") -> "DspVector":
        """Wrap-around add: the argument tiles cyclically
        (reference elementary.rs:165-272)."""
        return self._smaller_op(other, _operator.add)

    def sub_smaller(self, other: "DspVector") -> "DspVector":
        return self._smaller_op(other, _operator.sub)

    def mul_smaller(self, other: "DspVector") -> "DspVector":
        return self._smaller_op(other, _operator.mul)

    def div_smaller(self, other: "DspVector") -> "DspVector":
        return self._smaller_op(other, _operator.truediv)

    def scale(self, factor) -> "DspVector":
        if isinstance(factor, complex) and not self.is_complex():
            return self._invalid(ErrorReason.INPUT_MUST_BE_COMPLEX)
        return self._map_arg(_scale, factor)

    def offset(self, offset) -> "DspVector":
        if isinstance(offset, complex) and not self.is_complex():
            return self._invalid(ErrorReason.INPUT_MUST_BE_COMPLEX)
        return self._map_arg(_offset, offset)

    # ------------------------------------------------------------------
    # Trigonometry & powers (reference general/trigonometry_and_powers.rs)
    # ------------------------------------------------------------------
    def _map(self, fn) -> "DspVector":
        """Applies a *registered* (stably-identified) function under jit.

        Ops go through jit even in "eager" API usage, so every op is one
        cached compiled program.  ``fn`` must be a module-level function so the jit cache hits.
        """
        return self._make(_jit_unary(fn)(self._data))

    def _map_arg(self, fn, arg) -> "DspVector":
        return self._make(_jit_unary_arg(fn)(self._data, arg))

    def sin(self): return self._map(jnp.sin)
    def cos(self): return self._map(jnp.cos)
    def tan(self): return self._map(jnp.tan)
    def asin(self): return self._map(jnp.arcsin)
    def acos(self): return self._map(jnp.arccos)
    def atan(self): return self._map(jnp.arctan)
    def sinh(self): return self._map(jnp.sinh)
    def cosh(self): return self._map(jnp.cosh)
    def tanh(self): return self._map(jnp.tanh)
    def asinh(self): return self._map(jnp.arcsinh)
    def acosh(self): return self._map(jnp.arccosh)
    def atanh(self): return self._map(jnp.arctanh)
    def sqrt(self): return self._map(jnp.sqrt)
    def square(self): return self._map(_square)
    def ln(self): return self._map(jnp.log)
    def exp(self): return self._map(jnp.exp)

    def root(self, degree):
        return self._map_arg(_root, degree)

    def powf(self, exponent):
        return self._map_arg(_powf, exponent)

    def log(self, base):
        return self._map_arg(_logbase, base)

    def expf(self, base):
        return self._map_arg(_expf, base)

    # Approximated ops (reference real/real_ops.rs:86-224).  XLA already
    # emits fast vectorized transcendentals; the reduced-precision contract
    # is honored by evaluating through f32 (the reference's SIMD polynomials
    # are likewise f32-accuracy-bounded).
    def _approx(self, fn, *args) -> "DspVector":
        """Fast-math family: genuine Cephes-style polynomial evaluators
        (ops/approx_ops.py), the reference's SIMD approximations
        (simd_extensions/approximations.rs) — faster, less accurate
        (~1e-6 relative), f32 polynomial math for every flavor."""
        bad = self._check(complex_=False)
        if bad is not None:
            return bad
        return self._make(_jit_static(fn, *args)(self._data))

    def ln_approx(self): return self._approx(approx_ops.ln_approx)
    def exp_approx(self): return self._approx(approx_ops.exp_approx)
    def sin_approx(self): return self._approx(approx_ops.sin_approx)
    def cos_approx(self): return self._approx(approx_ops.cos_approx)

    def log_approx(self, base):
        return self._approx(approx_ops.log_approx, float(base))

    def expf_approx(self, base):
        return self._approx(approx_ops.expf_approx, float(base))

    def powf_approx(self, exponent):
        return self._approx(approx_ops.powf_approx, float(exponent))

    # ------------------------------------------------------------------
    # Real ops (reference real/real_ops.rs)
    # ------------------------------------------------------------------
    def abs(self) -> "DspVector":
        bad = self._check(complex_=False)
        if bad is not None:
            return bad
        return self._map(jnp.abs)

    def wrap(self, divisor: float) -> "DspVector":
        """Modulo / phase wrap (reference real_ops.rs:37-53)."""
        bad = self._check(complex_=False)
        if bad is not None:
            return bad
        return self._map_arg(_fmod, divisor)

    def unwrap(self, divisor: float) -> "DspVector":
        """Inverse of wrap: corrects jumps larger than half the divisor
        (reference real_ops.rs:55-67)."""
        bad = self._check(complex_=False)
        if bad is not None:
            return bad
        return self._map_arg(_unwrap, divisor)

    # ------------------------------------------------------------------
    # Complex ops (reference complex/complex_ops.rs, complex_to_real.rs,
    # real_to_complex.rs)
    # ------------------------------------------------------------------
    def conj(self) -> "DspVector":
        bad = self._check(complex_=True)
        if bad is not None:
            return bad
        return self._map(jnp.conj)

    def multiply_complex_exponential(self, a: float, b: float) -> "DspVector":
        """x[i] *= exp(j*(a*delta*i + b*delta)) — frequency shift / chirp
        (reference complex_ops.rs:81-105)."""
        bad = self._check(complex_=True)
        if bad is not None:
            return bad
        return self._make(_jit_static(conv_ops.multiply_complex_exponential,
                                      float(a), float(b),
                                      self._delta)(self._data))

    def _to_real_flavor(self, fn) -> "DspVector":
        bad = self._check(complex_=True)
        if bad is not None:
            return bad._retag(NumberSpace.REAL) \
                if bad._is_gen() else bad
        return self._make(_jit_unary(fn)(self._data), space=NumberSpace.REAL)

    def magnitude(self) -> "DspVector":
        return self._to_real_flavor(jnp.abs)

    def magnitude_squared(self) -> "DspVector":
        return self._to_real_flavor(_mag_sq)

    def to_real(self) -> "DspVector":
        return self._to_real_flavor(jnp.real)

    def to_imag(self) -> "DspVector":
        return self._to_real_flavor(jnp.imag)

    def phase(self) -> "DspVector":
        return self._to_real_flavor(jnp.angle)

    # Getter variants (reference complex_to_real.rs:237-331) — same results,
    # non-consuming naming preserved for API parity.
    def get_real(self): return self.to_real()
    def get_imag(self): return self.to_imag()
    def get_magnitude(self): return self.magnitude()
    def get_magnitude_squared(self): return self.magnitude_squared()
    def get_phase(self): return self.phase()

    def get_real_imag(self) -> Tuple["DspVector", "DspVector"]:
        return self.to_real(), self.to_imag()

    def get_mag_phase(self) -> Tuple["DspVector", "DspVector"]:
        return self.magnitude(), self.phase()

    def set_real_imag(self, real: "DspVector", imag: "DspVector") -> "DspVector":
        """Rebuild complex data from two real vectors
        (reference complex_to_real.rs:346)."""
        bad = self._check(complex_=True)
        if bad is not None:
            return bad
        if real.points() != imag.points():
            return self._invalid(ErrorReason.INPUT_MUST_HAVE_THE_SAME_SIZE)
        return self._make(
            _jit_binary(_combine_real_imag)(real._data, imag._data))

    def set_mag_phase(self, mag: "DspVector", phase: "DspVector") -> "DspVector":
        bad = self._check(complex_=True)
        if bad is not None:
            return bad
        if mag.points() != phase.points():
            return self._invalid(ErrorReason.INPUT_MUST_HAVE_THE_SAME_SIZE)
        # Through the funnel: planar mode must wrap the complex result.
        return self._make(
            _jit_binary(_combine_mag_phase)(mag._data, phase._data))

    def to_complex(self) -> "DspVector":
        """Real -> complex with zero imaginary part
        (reference real_to_complex.rs:12-112)."""
        bad = self._check(complex_=False)
        if bad is not None:
            return bad._retag(NumberSpace.COMPLEX) \
                if bad._is_gen() else bad
        cdtype = jnp.result_type(self._data.dtype, jnp.complex64)
        return self._make(
            _jit_unary_static(_astype)(self._data, jnp.dtype(cdtype).name),
            space=NumberSpace.COMPLEX)

    # ------------------------------------------------------------------
    # Data reorganization (reference general/data_reorganization.rs)
    # ------------------------------------------------------------------
    def reverse(self) -> "DspVector":
        return self._map(reorg_ops.reverse)

    def swap_halves(self) -> "DspVector":
        return self._map(reorg_ops.swap_halves)

    def zero_pad(self, points: int, option: str = "end") -> "DspVector":
        if points * (2 if self.is_complex() else 1) <= len(self):
            return self._invalid(ErrorReason.INVALID_ARGUMENT_LENGTH)
        return self._make(_jit_static(reorg_ops.zero_pad, points, option)(self._data))

    def zero_interleave(self, factor: int) -> "DspVector":
        return self._make(_jit_static(reorg_ops.zero_interleave, factor)(self._data))

    def split_into(self, n: int) -> List["DspVector"]:
        if n == 0 or self.points() % n != 0:
            raise DspError(ErrorReason.INVALID_ARGUMENT_LENGTH)
        parts = _jit_static(reorg_ops.split_into, n)(self._data)
        return [self._make(parts[i]) for i in range(n)]

    def merge(self, sources: Sequence["DspVector"]) -> "DspVector":
        if not sources:
            raise DspError(ErrorReason.INVALID_ARGUMENT_LENGTH)
        n0 = sources[0].points()
        if any(s.points() != n0 for s in sources):
            raise DspError(ErrorReason.INVALID_ARGUMENT_LENGTH)
        return self._make(_planar.call(_merge_stack,
                                       *[s._data for s in sources]))

    def resize(self, points: int) -> "DspVector":
        """Shrink (truncate) or grow (zero-extend) to ``points``
        (reference vec_impl_and_indexers.rs ResizeOps)."""
        return self._make(_jit_static(_resize, points)(self._data))

    # ------------------------------------------------------------------
    # Diff / cumsum (reference general/diff_sum.rs)
    # ------------------------------------------------------------------
    def diff(self) -> "DspVector":
        return self._map(_diff)

    def diff_with_start(self) -> "DspVector":
        return self._map(_diff_with_start)

    def cum_sum(self) -> "DspVector":
        return self._map(_cumsum)

    # ------------------------------------------------------------------
    # Statistics & reductions (reference general/statistics.rs,
    # precise_stats.rs, dot_products.rs)
    # ------------------------------------------------------------------
    def statistics(self) -> stats_ops.Statistics:
        return stats_ops.statistics(self._data, self.is_complex())

    def statistics_split(self, length: int):
        if length > stats_ops.STATS_VEC_CAPACITY:
            raise DspError(ErrorReason.INVALID_ARGUMENT_LENGTH)
        return stats_ops.statistics_split(self._data, length,
                                          self.is_complex())

    def statistics_prec(self) -> stats_ops.Statistics:
        return stats_ops.statistics_prec(self._data, self.is_complex())

    def statistics_split_prec(self, length: int):
        if length > stats_ops.STATS_VEC_CAPACITY:
            raise DspError(ErrorReason.INVALID_ARGUMENT_LENGTH)
        return stats_ops.statistics_split_prec(self._data, length,
                                               self.is_complex())

    def sum(self):
        return stats_ops.sum_(self._data)

    def sum_sq(self):
        return stats_ops.sum_sq(self._data)

    def sum_prec(self):
        return stats_ops.sum_prec(self._data)

    def sum_sq_prec(self):
        return stats_ops.sum_sq_prec(self._data)

    def dot_product(self, other: "DspVector"):
        bad = self._binary_check(other)
        if bad is not None:
            raise DspError(ErrorReason.INPUT_META_DATA_MUST_AGREE)
        return stats_ops.dot_product(self._data, other._data)

    def dot_product_prec(self, other: "DspVector"):
        bad = self._binary_check(other)
        if bad is not None:
            raise DspError(ErrorReason.INPUT_META_DATA_MUST_AGREE)
        return stats_ops.dot_product_prec(self._data, other._data)

    # ------------------------------------------------------------------
    # Mapping (reference general/mapping.rs) — the user function receives
    # the whole value array and an index array (vectorized contract).
    # ------------------------------------------------------------------
    def map_inplace(self, fn: Callable, argument=None) -> "DspVector":
        return self._make(_planar.call(_map_with_idx, self._data,
                                       static=(fn, argument)))

    def map_aggregate(self, map_fn: Callable, aggregate_fn: Callable,
                      argument=None):
        mapped = _planar.call(_map_with_idx, self._data,
                              static=(map_fn, argument))
        return aggregate_fn(_planar.unwrap(mapped))

    # ------------------------------------------------------------------
    # Rededicate (reference rededicate_and_relations.rs:16-91): re-tag the
    # vector as another flavor, keeping the raw memory interpretation.
    # ------------------------------------------------------------------
    def _retag(self, space: NumberSpace,
               domain: Optional[DataDomain] = None) -> "DspVector":
        domain = domain or self._domain
        data = self._data
        # Both interleave conversions run inside the planar funnel: the
        # stored data may be a PlanarComplex (planar mode) and the complex
        # result must then cross program boundaries as planes.
        if space == NumberSpace.COMPLEX and not self.is_complex():
            # Pair up interleaved reals (odd tail dropped -> len 0 per the
            # reference's odd-complex rule, to_from_vec_conversions.rs).
            data = _jit_unary(_interleaved_to_complex)(data)
        elif space == NumberSpace.REAL and self.is_complex():
            data = _jit_unary(_complex_to_interleaved)(data)
        if self._is_gen():
            return self._gen_class()(data, self._delta, domain, space)
        return self._flavor_class(space, domain)(data, self._delta)

    def rededicate_to(self, space: NumberSpace,
                      domain: DataDomain) -> "DspVector":
        return self._retag(space, domain)

    def rededicate(self, space: NumberSpace,
                   domain: DataDomain) -> "DspVector":
        """Alias for :meth:`rededicate_to` (reference naming)."""
        return self._retag(space, domain)

    # ------------------------------------------------------------------
    # Reference-parity aliases.  The reference's `_b` suffixed operations
    # take an external scratch buffer (buffer.rs:8-29); XLA owns buffers
    # here, so they alias the plain operations.
    # ------------------------------------------------------------------
    def set_delta(self, delta: float) -> "DspVector":
        return self.with_delta(delta)

    def get_meta_data(self):
        """(delta, domain, number_space) — reference GetMetaData."""
        return self._delta, self._domain, self._space

    def magnitude_b(self): return self.magnitude()
    def magnitude_squared_b(self): return self.magnitude_squared()
    def to_real_b(self): return self.to_real()
    def to_imag_b(self): return self.to_imag()
    def phase_b(self): return self.phase()
    def to_complex_b(self): return self.to_complex()

    def zero_pad_b(self, points, option="end"):
        return self.zero_pad(points, option)

    def zero_interleave_b(self, factor):
        return self.zero_interleave(factor)

    def resize_b(self, points):
        return self.resize(points)

    def swap_halves_b(self):
        return self.swap_halves()

    def apply_linear_phase(self, delay: float) -> "DspVector":
        """Linear phase on an unshifted spectrum == time-domain delay of
        ``delay`` samples (reference interpolation.rs:317-339; the caller
        normalizes by the time-domain delta there)."""
        bad = (self._check(domain=DataDomain.FREQUENCY)
               or self._check(complex_=True))
        if bad is not None:
            return bad
        return self._make(_jit_unary_arg(conv_ops.apply_linear_phase)(
            self._data, delay))

    # ------------------------------------------------------------------
    # Time <-> frequency (reference time_freq/)
    # ------------------------------------------------------------------
    def _fft_delta(self) -> float:
        """delta -> rbw on any DFT (reference time_freq/mod.rs:54-55)."""
        return self._delta * self.points()

    def plain_fft(self) -> "DspVector":
        """Unscaled, unshifted FFT (reference time_to_freq.rs:136-156);
        real input is promoted to complex first."""
        bad = self._check(domain=DataDomain.TIME)
        if bad is not None:
            return bad._retag(NumberSpace.COMPLEX, DataDomain.FREQUENCY) \
                if bad._is_gen() else bad
        work = self if self.is_complex() else self.to_complex()
        return self._make(_jit_unary(fft_ops.plain_fft)(work._data),
                          delta=work._fft_delta(),
                          domain=DataDomain.FREQUENCY,
                          space=NumberSpace.COMPLEX)

    def fft(self) -> "DspVector":
        """plain_fft + fft_shift (reference time_to_freq.rs:158-165)."""
        result = self.plain_fft()
        if result.is_erroneous():
            return result
        return result.fft_shift()

    def windowed_fft(self, window: WindowFunction) -> "DspVector":
        return self.apply_window(window).fft()

    def plain_sfft(self) -> "DspVector":
        """Symmetric FFT of real odd-length input -> half spectrum
        (reference time_to_freq.rs:198-228)."""
        bad = (self._check(domain=DataDomain.TIME)
               or self._check(complex_=False))
        if bad is not None:
            return bad._retag(NumberSpace.COMPLEX, DataDomain.FREQUENCY) \
                if bad._is_gen() else bad
        if self.points() % 2 == 0:
            return self._invalid(ErrorReason.INPUT_MUST_HAVE_AN_ODD_LENGTH,
                                 domain=DataDomain.FREQUENCY,
                                 space=NumberSpace.COMPLEX)
        points = self.points()
        full = self.plain_fft()
        return full._make(_planar.call(fft_ops.unmirror, full._data,
                                       static=(points,)),
                          delta=full._delta, domain=DataDomain.FREQUENCY,
                          space=NumberSpace.COMPLEX)

    def sfft(self) -> "DspVector":
        """Reference time_to_freq.rs:230-260 (fft + unmirror)."""
        bad = (self._check(domain=DataDomain.TIME)
               or self._check(complex_=False))
        if bad is not None:
            return bad._retag(NumberSpace.COMPLEX, DataDomain.FREQUENCY) \
                if bad._is_gen() else bad
        if self.points() % 2 == 0:
            return self._invalid(ErrorReason.INPUT_MUST_HAVE_AN_ODD_LENGTH,
                                 domain=DataDomain.FREQUENCY,
                                 space=NumberSpace.COMPLEX)
        points = self.points()
        full = self.fft()
        return full._make(_planar.call(fft_ops.unmirror, full._data,
                                       static=(points,)),
                          delta=full._delta, domain=DataDomain.FREQUENCY,
                          space=NumberSpace.COMPLEX)

    def windowed_sfft(self, window: WindowFunction) -> "DspVector":
        bad = (self._check(domain=DataDomain.TIME)
               or self._check(complex_=False))
        if bad is not None:
            return bad._retag(NumberSpace.COMPLEX, DataDomain.FREQUENCY) \
                if bad._is_gen() else bad
        if self.points() % 2 == 0:
            return self._invalid(ErrorReason.INPUT_MUST_HAVE_AN_ODD_LENGTH,
                                 domain=DataDomain.FREQUENCY,
                                 space=NumberSpace.COMPLEX)
        points = self.points()
        full = self.to_complex().apply_window(window).fft()
        return full._make(_planar.call(fft_ops.unmirror, full._data,
                                       static=(points,)),
                          delta=full._delta, domain=DataDomain.FREQUENCY,
                          space=NumberSpace.COMPLEX)

    def plain_ifft(self) -> "DspVector":
        """Unscaled inverse FFT (reference freq_to_time.rs:138-158)."""
        bad = self._check(domain=DataDomain.FREQUENCY)
        if bad is not None:
            return bad._retag(NumberSpace.COMPLEX, DataDomain.TIME) \
                if bad._is_gen() else bad
        work = self if self.is_complex() else self.to_complex()
        return self._make(_jit_unary(fft_ops.plain_ifft)(work._data),
                          delta=work._fft_delta(),
                          domain=DataDomain.TIME, space=NumberSpace.COMPLEX)

    def ifft(self) -> "DspVector":
        """scale(1/N) + ifft_shift + plain_ifft
        (reference freq_to_time.rs:160-168)."""
        bad = self._check(domain=DataDomain.FREQUENCY)
        if bad is not None:
            return bad._retag(NumberSpace.COMPLEX, DataDomain.TIME) \
                if bad._is_gen() else bad
        n = self.points()
        return self.scale(1.0 / n).ifft_shift().plain_ifft()

    def windowed_ifft(self, window: WindowFunction) -> "DspVector":
        return self.ifft().unapply_window(window)

    def _dc_imag_too_large(self) -> bool:
        """Conj-symmetry gate for plain_sifft (freq_to_time.rs:205-213).

        The reference's absolute 1e-10 threshold is kept for the f64
        flavors, but it is below f32 resolution whenever the DC bin is
        computed by a non-exact FFT (e.g. Bluestein at non-smooth lengths
        such as 4097 = 17*241), so the f32 flavors use an eps-grade
        threshold relative to the DC magnitude instead.
        """
        parts = np.asarray(_planar.call(_dc_parts, self._data))
        imag, real = abs(float(parts[0])), abs(float(parts[1]))
        if np.dtype(_planar.real_dtype_of(self._data)) == np.float64:
            return imag > 1e-10
        return imag > 1e-5 * (1.0 + real)

    def plain_sifft(self) -> "DspVector":
        """Symmetric inverse FFT: half spectrum -> real time signal
        (reference freq_to_time.rs:190-221)."""
        bad = (self._check(domain=DataDomain.FREQUENCY)
               or self._check(complex_=True))
        if bad is not None:
            return bad._retag(NumberSpace.REAL, DataDomain.TIME) \
                if bad._is_gen() else bad
        if self.points() > 0 and self._dc_imag_too_large():
            return self._invalid(ErrorReason.INPUT_MUST_BE_CONJ_SYMMETRIC,
                                 domain=DataDomain.TIME,
                                 space=NumberSpace.REAL)
        out = _planar.call(_sifft_core, self._data)
        return self._make(out, domain=DataDomain.TIME,
                          space=NumberSpace.REAL,
                          delta=self._delta * (2 * self.points() - 1))

    def sifft(self) -> "DspVector":
        """Reference freq_to_time.rs:223-234: scale by 1/half_points,
        ifft_shift the half spectrum, then plain_sifft."""
        bad = (self._check(domain=DataDomain.FREQUENCY)
               or self._check(complex_=True))
        if bad is not None:
            return bad._retag(NumberSpace.REAL, DataDomain.TIME) \
                if bad._is_gen() else bad
        n = self.points()
        return self.scale(1.0 / n).ifft_shift().plain_sifft()

    def windowed_sifft(self, window: WindowFunction) -> "DspVector":
        result = self.sifft()
        if result.is_erroneous():
            return result
        return result.unapply_window(window)

    def mirror(self) -> "DspVector":
        """Half spectrum -> full spectrum (reference freq.rs:52-83)."""
        bad = (self._check(domain=DataDomain.FREQUENCY)
               or self._check(complex_=True))
        if bad is not None:
            return bad
        return self._map(fft_ops.mirror)

    def fft_shift(self) -> "DspVector":
        """Swap halves after an FFT.  Like every FrequencyDomainOperations
        member this requires a complex frequency vector (freq.rs:7-15:
        trait bound N: ComplexNumberSpace, D: FrequencyDomain; Gen misuse
        sets len 0).  ``swap_halves`` is the unconstrained variant."""
        bad = (self._check(domain=DataDomain.FREQUENCY)
               or self._check(complex_=True))
        if bad is not None:
            return bad
        return self._map(fft_ops.fft_shift)

    def ifft_shift(self) -> "DspVector":
        bad = (self._check(domain=DataDomain.FREQUENCY)
               or self._check(complex_=True))
        if bad is not None:
            return bad
        return self._map(fft_ops.ifft_shift)

    def apply_window(self, window: WindowFunction) -> "DspVector":
        w = window.sample(self.points(), dtype=_real_dtype_of(self._data))
        return self._make(_jit_binary(_window_mul)(self._data, w))

    def unapply_window(self, window: WindowFunction) -> "DspVector":
        w = window.sample(self.points(), dtype=_real_dtype_of(self._data))
        return self._make(_jit_binary(_window_div)(self._data, w))

    # ------------------------------------------------------------------
    # Convolution / correlation (reference time_freq/convolution.rs,
    # correlation.rs)
    # ------------------------------------------------------------------
    def convolve_signal(self, impulse_response: "DspVector",
                        cfg: Optional[_config.DspConfig] = None) -> "DspVector":
        """Circular centered convolution (see ops.conv_ops)."""
        bad = (self._binary_check(impulse_response, same_size=False)
               or self._check(domain=DataDomain.TIME)
               or self._check_delta(impulse_response))
        if bad is not None:
            return bad
        if self.points() < impulse_response.points():
            return self._invalid(ErrorReason.INVALID_ARGUMENT_LENGTH)
        if cfg is None and (self.points()
                            > _config.default_config().overlap_save_min_len):
            # Lazy one-time calibration on the first large convolution
            # (reference threading.rs:190-193); loads the per-device cache
            # or measures + persists.
            from . import autotune
            autotune.ensure_calibrated()
        out = _planar.call(conv_ops.convolve_signal, self._data,
                           impulse_response._data,
                           static=(self.is_complex(),
                                   cfg or _config.default_config()))
        return self._make(out)

    def overlap_discard(self, impulse_response: "DspVector",
                        fft_len: int = 0) -> "DspVector":
        """Blocked-FFT evaluation of ``convolve_signal`` with an explicit
        block length (reference overlap_discard, convolution.rs:304-462).
        ``fft_len`` of 0 picks the tuned default."""
        bad = (self._binary_check(impulse_response, same_size=False)
               or self._check(domain=DataDomain.TIME)
               or self._check(complex_=True))
        if bad is not None:
            return bad
        m = impulse_response.points()
        out = _planar.call(conv_ops.overlap_save, self._data,
                           impulse_response._data,
                           static=(True, conv_ops.pick_fft_len(m, fft_len)))
        return self._make(out)

    def convolve(self, function, ratio: float, length: int) -> "DspVector":
        """Convolve against an analytic impulse response
        (reference convolution.rs:126-254)."""
        bad = self._check(domain=DataDomain.TIME)
        if bad is not None:
            return bad
        from .conv_types import ComplexImpulseResponse
        if isinstance(function, ComplexImpulseResponse) and not self.is_complex():
            return self._invalid(ErrorReason.INPUT_MUST_BE_COMPLEX)
        # Host-callback (_no_jit) functions also go through the funnel:
        # their sample points are arange-derived, hence concrete during
        # tracing; _planar.call salts the cache so they re-sample per call.
        out = _jit_static(conv_ops.convolve_function, function,
                          float(ratio), int(length),
                          self.is_complex())(self._data)
        if jnp.iscomplexobj(out) and not self.is_complex():
            out = jnp.real(out).astype(self._data.dtype)
        return self._make(out)

    def multiply_frequency_response(self, frequency_response,
                                    ratio: float) -> "DspVector":
        """Reference convolution.rs:545-610.  Complex responses require a
        complex vector."""
        bad = self._check(domain=DataDomain.FREQUENCY)
        if bad is not None:
            return bad
        from .conv_types import ComplexFrequencyResponse
        if (isinstance(frequency_response, ComplexFrequencyResponse)
                and not self.is_complex()):
            return self._invalid(ErrorReason.INPUT_MUST_BE_COMPLEX)
        calc = frequency_response.calc_freq
        out = _jit_static(conv_ops.multiply_function, calc, float(ratio),
                          False,
                          frequency_response.is_symmetric)(self._data)
        return self._make(out)

    def prepare_argument(self, padded: bool = False) -> "DspVector":
        """FFT + conj for correlation (reference correlation.rs:96-118)."""
        bad = (self._check(domain=DataDomain.TIME)
               or self._check(complex_=True))
        if bad is not None:
            return bad
        out = _jit_static(conv_ops.prepare_argument, bool(padded))(self._data)
        return self._make(out, delta=self._fft_delta(),
                          domain=DataDomain.FREQUENCY)

    def prepare_argument_padded(self) -> "DspVector":
        return self.prepare_argument(padded=True)

    def correlate(self, prepared: "DspVector") -> "DspVector":
        """Cross-correlation (reference correlation.rs:131-163); matches
        Octave/MATLAB xcorr when the argument was prepared padded."""
        bad = self._check(domain=DataDomain.TIME) or self._check(complex_=True)
        if bad is not None:
            return bad
        if (prepared._domain != DataDomain.FREQUENCY
                or not prepared.is_complex()):
            return self._invalid(ErrorReason.INPUT_MUST_BE_IN_TIME_DOMAIN)
        out = _jit_binary(conv_ops.correlate)(self._data, prepared._data)
        return self._make(out)

    # ------------------------------------------------------------------
    # Interpolation (reference time_freq/interpolation.rs,
    # real_interpolation.rs)
    # ------------------------------------------------------------------
    def interpolatef(self, function, interpolation_factor: float,
                     delay: float, conv_len: int) -> "DspVector":
        out = _jit_static(interp_ops.interpolatef, function,
                          float(interpolation_factor), float(delay),
                          int(conv_len), self._delta)(self._data)
        return self._make(out)

    def interpolatei(self, function, interpolation_factor: int) -> "DspVector":
        if not function.is_symmetric and not self.is_complex():
            return self._invalid(
                ErrorReason.ARGUMENT_FUNCTION_MUST_BE_SYMMETRIC)
        out = _jit_static(interp_ops.interpolatei, function,
                          int(interpolation_factor),
                          self.is_complex())(self._data)
        return self._make(out)

    def interpolate(self, function, target_points: int,
                    delay: float) -> "DspVector":
        if (function is not None and not function.is_symmetric
                and not self.is_complex()):
            return self._invalid(
                ErrorReason.ARGUMENT_FUNCTION_MUST_BE_SYMMETRIC)
        factor = target_points / self.points()
        out = _jit_static(interp_ops.interpolate, function,
                          int(target_points), float(delay), self._delta,
                          self.is_complex())(self._data)
        return self._make(out, delta=self._delta / factor)

    def interpft(self, target_points: int) -> "DspVector":
        return self.interpolate(None, target_points, 0.0)

    def decimatei(self, decimation_factor: int, delay: int) -> "DspVector":
        return self._make(_jit_static(interp_ops.decimatei,
                                      int(decimation_factor),
                                      int(delay))(self._data))

    def interpolate_lin(self, interpolation_factor: float,
                        delay: float) -> "DspVector":
        bad = self._check(complex_=False)
        if bad is not None:
            return bad
        return self._make(_jit_static(interp_ops.interpolate_lin,
                                      float(interpolation_factor),
                                      float(delay))(self._data))

    def interpolate_hermite(self, interpolation_factor: float,
                            delay: float) -> "DspVector":
        bad = self._check(complex_=False)
        if bad is not None:
            return bad
        return self._make(_jit_static(interp_ops.interpolate_hermite,
                                      float(interpolation_factor),
                                      float(delay))(self._data))


class RealTimeVector(DspVector):
    _SPACE = NumberSpace.REAL
    _DOMAIN = DataDomain.TIME


class RealFreqVector(DspVector):
    _SPACE = NumberSpace.REAL
    _DOMAIN = DataDomain.FREQUENCY


class ComplexTimeVector(DspVector):
    _SPACE = NumberSpace.COMPLEX
    _DOMAIN = DataDomain.TIME


class ComplexFreqVector(DspVector):
    _SPACE = NumberSpace.COMPLEX
    _DOMAIN = DataDomain.FREQUENCY


class GenDspVector(DspVector):
    """Runtime-typed flavor (reference GenDspVec): invalid operations mark
    the vector erroneous instead of raising."""

    def __init__(self, data, delta: float = 1.0,
                 domain: DataDomain = DataDomain.TIME,
                 space: NumberSpace = NumberSpace.REAL):
        super().__init__(data, delta, domain, space)


_FLAVORS = {
    (NumberSpace.REAL, DataDomain.TIME): RealTimeVector,
    (NumberSpace.REAL, DataDomain.FREQUENCY): RealFreqVector,
    (NumberSpace.COMPLEX, DataDomain.TIME): ComplexTimeVector,
    (NumberSpace.COMPLEX, DataDomain.FREQUENCY): ComplexFreqVector,
}


# ----------------------------------------------------------------------
# Constructors (reference to_from_vec_conversions.rs:16-127)
# ----------------------------------------------------------------------
def _from_interleaved_complex(data) -> jnp.ndarray:
    # Complex data enters the device as two real planes combined under
    # jit.
    if isinstance(data, (np.ndarray, list, tuple)) and             np.iscomplexobj(np.asarray(data)):
        host = np.asarray(data)
        return _jit_binary(_combine_real_imag)(
            jnp.asarray(np.ascontiguousarray(host.real)),
            jnp.asarray(np.ascontiguousarray(host.imag)))
    data = jnp.asarray(data)
    if jnp.iscomplexobj(data):
        return data
    # Interleaved floats -> complex points; odd length -> empty (the
    # reference's odd-length-complex rule).
    n = data.shape[0]
    if n % 2 != 0:
        return jnp.zeros((0,),
                         dtype=jnp.result_type(data.dtype, jnp.complex64))
    pairs = data.reshape(-1, 2)
    return _jit_binary(_combine_real_imag)(pairs[:, 0], pairs[:, 1])


def to_real_time_vec(data, delta: float = 1.0) -> RealTimeVector:
    return RealTimeVector(jnp.asarray(data), delta)


def to_real_freq_vec(data, delta: float = 1.0) -> RealFreqVector:
    return RealFreqVector(jnp.asarray(data), delta)


def to_complex_time_vec(data, delta: float = 1.0) -> ComplexTimeVector:
    return ComplexTimeVector(_from_interleaved_complex(data), delta)


def to_complex_freq_vec(data, delta: float = 1.0) -> ComplexFreqVector:
    return ComplexFreqVector(_from_interleaved_complex(data), delta)


def to_gen_dsp_vec(data, is_complex: bool,
                   domain: DataDomain = DataDomain.TIME,
                   delta: float = 1.0) -> GenDspVector:
    if is_complex:
        return GenDspVector(_from_interleaved_complex(data), delta, domain,
                            NumberSpace.COMPLEX)
    return GenDspVector(jnp.asarray(data), delta, domain, NumberSpace.REAL)


def _shard(v: DspVector, mesh) -> DspVector:
    from jax.sharding import NamedSharding, PartitionSpec as P
    axis = mesh.axis_names[0]
    data = jax.device_put(v.array, NamedSharding(mesh, P(axis)))
    return v._make(data)


def to_real_time_vec_par(data, mesh, delta: float = 1.0) -> RealTimeVector:
    """Mesh-sharded constructor — the analog of the reference's ``*_par``
    constructors (support_std_par.rs:19-65): data lands sharded over the
    mesh's first axis so subsequent jit ops execute multi-chip."""
    return _shard(to_real_time_vec(data, delta), mesh)


def to_complex_time_vec_par(data, mesh, delta: float = 1.0) -> ComplexTimeVector:
    return _shard(to_complex_time_vec(data, delta), mesh)


def to_real_freq_vec_par(data, mesh, delta: float = 1.0) -> RealFreqVector:
    return _shard(to_real_freq_vec(data, delta), mesh)


def to_complex_freq_vec_par(data, mesh, delta: float = 1.0) -> ComplexFreqVector:
    return _shard(to_complex_freq_vec(data, delta), mesh)


def interleave_to_complex_time_vec(real, imag,
                                   delta: float = 1.0) -> ComplexTimeVector:
    real = jnp.asarray(real)
    imag = jnp.asarray(imag)
    if real.shape != imag.shape:
        raise DspError(ErrorReason.INPUT_MUST_HAVE_THE_SAME_SIZE)
    return ComplexTimeVector(_jit_binary(_combine_real_imag)(real, imag),
                             delta)


def interleave_to_complex_freq_vec(real, imag,
                                   delta: float = 1.0) -> ComplexFreqVector:
    v = interleave_to_complex_time_vec(real, imag, delta)
    # Pass the stored representation through (may be PlanarComplex);
    # v.array would eagerly materialize a complex host array.
    return ComplexFreqVector(v._data, delta)


# ----------------------------------------------------------------------
# Pytree registration: data is the traced leaf; metadata is static.
# ----------------------------------------------------------------------
def _flatten(v: DspVector):
    return (v._data,), (type(v), v._delta, v._domain, v._space)


def _unflatten(aux, children):
    klass, delta, domain, space = aux
    obj = object.__new__(klass)
    obj._data = children[0]
    obj._delta = delta
    obj._domain = domain
    obj._space = space
    return obj


for _klass in (RealTimeVector, RealFreqVector, ComplexTimeVector,
               ComplexFreqVector, GenDspVector):
    jax.tree_util.register_pytree_node(_klass, _flatten, _unflatten)
