"""The matrix (multi-channel) layer.

The reference models a matrix as a collection of row vectors and re-derives
every vector op by looping rows (matrix/src/lib.rs:32-74, general/ macro
``add_mat_impl``).  This design instead stores one ``(channels,
points)`` device array and runs every op *batched* over the leading axis —
elementwise math, FFTs and convolutions over all channels execute as single
fused XLA ops (FFTs and convolutions are fastest batched), and the channel
axis is the natural sharding axis for the multi-device path (the 1024-channel
channelizer config).

All vector operations are inherited from :class:`~.vector.DspVector`
unchanged — the functional kernels already broadcast over leading axes.
Row-wise reductions (statistics, sums, dot products) are overridden to
return per-row results like the reference
(matrix/src/general/statistics.rs:4-478).
"""
from __future__ import annotations

from typing import List, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from .errors import DspError, ErrorReason
from .meta import DataDomain, NumberSpace
from .ops import conv_ops, stats_ops
from .vector import DspVector
from . import _planar, config

__all__ = [
    "DspMatrix", "RealTimeMatrix", "RealFreqMatrix", "ComplexTimeMatrix",
    "ComplexFreqMatrix", "GenDspMatrix",
    "to_real_time_mat", "to_real_freq_mat", "to_complex_time_mat",
    "to_complex_freq_mat", "to_gen_dsp_mat", "from_rows", "to_mat",
]


class DspMatrix(DspVector):
    """A stack of equally-long DSP vectors sharing metadata.

    ``col_len`` is the number of rows (channels) and ``row_len`` the number
    of points per row, matching the reference Matrix trait
    (matrix/src/mat_impl.rs:8-38).
    """

    _NDIM = 2

    # -- Matrix trait ---------------------------------------------------
    def row_len(self) -> int:
        return int(self._data.shape[-1])

    def row_points(self) -> int:
        return int(self._data.shape[-1])

    def col_len(self) -> int:
        return int(self._data.shape[0])

    def rows(self) -> List[DspVector]:
        from .vector import GenDspVector
        out = []
        for i in range(self.col_len()):
            if self._is_gen():
                out.append(GenDspVector(self._data[i], self._delta,
                                        self._domain, self._space))
            else:
                out.append(DspVector._flavor_class(self._space, self._domain)(
                    self._data[i], self._delta))
        return out

    def row(self, i: int) -> DspVector:
        return self.rows()[i]

    def to_numpy(self) -> np.ndarray:
        return _planar.to_host(self._data)

    @classmethod
    def _flavor_class(cls, space: NumberSpace, domain: DataDomain):
        return _MAT_FLAVORS[(space, domain)]

    @classmethod
    def _gen_class(cls):
        return GenDspMatrix

    def interleaved(self) -> np.ndarray:
        arr = self.to_numpy()
        if self.is_complex():
            out = np.empty(arr.shape[:-1] + (2 * arr.shape[-1],),
                           dtype=arr.real.dtype)
            out[..., 0::2] = arr.real
            out[..., 1::2] = arr.imag
            return out
        return arr

    # -- Row-wise reductions (reference matrix/src/general/statistics.rs) --
    # All batched: ONE device program per reduction over the whole (C, n)
    # array, per-row results built from a single host fetch instead of
    # one dispatch per row.
    def statistics(self):
        return stats_ops.statistics_batched(self._data, self.is_complex())

    def statistics_prec(self):
        return stats_ops.statistics_prec_batched(self._data,
                                                 self.is_complex())

    def statistics_split(self, length: int):
        return stats_ops.statistics_split_batched(self._data, length,
                                                  self.is_complex())

    def statistics_split_prec(self, length: int):
        return stats_ops.statistics_split_prec_batched(self._data, length,
                                                       self.is_complex())

    def sum(self):
        s = _planar.to_host(_planar.call(stats_ops._sum, self._data))
        return list(s)

    def sum_sq(self):
        s = _planar.to_host(_planar.call(stats_ops._sum_sq, self._data))
        return list(s)

    def sum_prec(self):
        return stats_ops.sum_prec_batched(self._data)

    def sum_sq_prec(self):
        return stats_ops.sum_sq_prec_batched(self._data)

    def dot_product(self, other):
        bad = self._binary_check(other)
        if bad is not None:
            raise DspError(ErrorReason.INPUT_META_DATA_MUST_AGREE)
        s = _planar.to_host(_planar.call(stats_ops._dot, self._data,
                                         other._data))
        return list(s)

    def dot_product_prec(self, other):
        bad = self._binary_check(other)
        if bad is not None:
            raise DspError(ErrorReason.INPUT_META_DATA_MUST_AGREE)
        return stats_ops.dot_product_prec_batched(self._data, other._data)

    # Round-robin split/merge apply per-row; disable the vector semantics to
    # avoid silent misuse (the reference matrix layer does not expose them).
    def split_into(self, n):
        raise DspError(ErrorReason.INVALID_ARGUMENT_LENGTH,
                       "split_into is a vector operation")

    def merge(self, sources):
        raise DspError(ErrorReason.INVALID_ARGUMENT_LENGTH,
                       "merge is a vector operation")

    # -- MIMO convolution (reference matrix/src/time_freq.rs:439-520) -----
    def convolve_mat(self, impulse_response: "DspMatrixKernel") -> "DspMatrix":
        """MIMO convolution: ``out[c] = sum_r rows[r] (*) imp[c][r]`` where
        ``imp`` is a (col_len x col_len) grid of kernels
        (vector side: time_freq/mod.rs:365-453).

        Realization: one batched FFT over rows + an einsum over the
        (out_channel, in_channel) kernel grid in frequency domain — the
        channel-mixing contraction is one batched matmul.
        """
        bad = self._check(domain=DataDomain.TIME)
        if bad is not None:
            return bad
        imp = np.asarray(impulse_response)
        if imp.ndim != 3 or imp.shape[0] != self.col_len() \
                or imp.shape[1] != self.col_len():
            raise DspError(ErrorReason.INVALID_ARGUMENT_LENGTH,
                           "impulse_response must be (rows, rows, taps)")
        if np.iscomplexobj(imp):
            imp_dev = _planar.from_host_complex(
                np.ascontiguousarray(imp.real),
                np.ascontiguousarray(imp.imag))
        else:
            imp_dev = jnp.asarray(imp)
        out = _planar.call(_convolve_mat, self._data, imp_dev,
                           static=(self.is_complex(),))
        return self._make(out)


def _convolve_mat(x, imp, is_complex):
    n = x.shape[-1]
    cdtype = jnp.result_type(x.dtype, jnp.complex64)
    g = conv_ops.kernel_layout(imp.astype(cdtype), n)  # (C, C, n)
    G = jnp.fft.fft(g, axis=-1)
    X = jnp.fft.fft(x.astype(cdtype), axis=-1)  # (C, n)
    Y = jnp.einsum("crn,rn->cn", G, X,
                   precision=config.matmul_precision())
    out = jnp.fft.ifft(Y, axis=-1)
    if not is_complex:
        out = jnp.real(out).astype(x.dtype)
    return out


class RealTimeMatrix(DspMatrix):
    _SPACE = NumberSpace.REAL
    _DOMAIN = DataDomain.TIME


class RealFreqMatrix(DspMatrix):
    _SPACE = NumberSpace.REAL
    _DOMAIN = DataDomain.FREQUENCY


class ComplexTimeMatrix(DspMatrix):
    _SPACE = NumberSpace.COMPLEX
    _DOMAIN = DataDomain.TIME


class ComplexFreqMatrix(DspMatrix):
    _SPACE = NumberSpace.COMPLEX
    _DOMAIN = DataDomain.FREQUENCY


class GenDspMatrix(DspMatrix):
    def __init__(self, data, delta: float = 1.0,
                 domain: DataDomain = DataDomain.TIME,
                 space: NumberSpace = NumberSpace.REAL):
        super().__init__(data, delta, domain, space)


_MAT_FLAVORS = {
    (NumberSpace.REAL, DataDomain.TIME): RealTimeMatrix,
    (NumberSpace.REAL, DataDomain.FREQUENCY): RealFreqMatrix,
    (NumberSpace.COMPLEX, DataDomain.TIME): ComplexTimeMatrix,
    (NumberSpace.COMPLEX, DataDomain.FREQUENCY): ComplexFreqMatrix,
}


def to_real_time_mat(data, delta: float = 1.0) -> RealTimeMatrix:
    return RealTimeMatrix(jnp.asarray(data), delta)


def to_real_freq_mat(data, delta: float = 1.0) -> RealFreqMatrix:
    return RealFreqMatrix(jnp.asarray(data), delta)


def to_complex_time_mat(data, delta: float = 1.0) -> ComplexTimeMatrix:
    return ComplexTimeMatrix(data, delta)


def to_complex_freq_mat(data, delta: float = 1.0) -> ComplexFreqMatrix:
    return ComplexFreqMatrix(data, delta)


def to_gen_dsp_mat(data, is_complex: bool,
                   domain: DataDomain = DataDomain.TIME,
                   delta: float = 1.0) -> GenDspMatrix:
    space = NumberSpace.COMPLEX if is_complex else NumberSpace.REAL
    return GenDspMatrix(data, delta, domain, space)


def to_mat(rows: Sequence[DspVector]) -> DspMatrix:
    """Alias matching the reference's ``[v1, v2].to_mat()`` conversion."""
    return from_rows(rows)


def from_rows(rows: Sequence[DspVector]) -> DspMatrix:
    """Stack equally-long vectors into a matrix
    (reference ToMatrix, matrix/src/to_from_mat_conversions.rs:6-110)."""
    if not rows:
        raise DspError(ErrorReason.INVALID_ARGUMENT_LENGTH)
    first = rows[0]
    if any(r.points() != first.points() or r.is_complex() != first.is_complex()
           or r.domain() != first.domain() for r in rows):
        raise DspError(ErrorReason.INPUT_META_DATA_MUST_AGREE)
    if any(_planar.is_planar(r._data) for r in rows):
        data = _planar.PlanarComplex(
            jnp.stack([_planar.unwrap_planes(r._data)[0] for r in rows]),
            jnp.stack([_planar.unwrap_planes(r._data)[1] for r in rows]))
    else:
        data = jnp.stack([r._data for r in rows])
    space = (NumberSpace.COMPLEX if first.is_complex() else NumberSpace.REAL)
    return _MAT_FLAVORS[(space, first.domain())](data, first.delta())


for _klass in (RealTimeMatrix, RealFreqMatrix, ComplexTimeMatrix,
               ComplexFreqMatrix, GenDspMatrix):
    jax.tree_util.register_pytree_node(
        _klass,
        lambda v: ((v._data,), (type(v), v._delta, v._domain, v._space)),
        lambda aux, children: _mat_unflatten(aux, children))


def _mat_unflatten(aux, children):
    klass, delta, domain, space = aux
    obj = object.__new__(klass)
    obj._data = children[0]
    obj._delta = delta
    obj._domain = domain
    obj._space = space
    return obj
