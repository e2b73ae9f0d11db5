"""Planar complex representation at program boundaries.

In planar mode every complex array that would cross a jit program
boundary (as an input, an output or a host transfer) travels as a
:class:`PlanarComplex` pytree of two real planes; the complex view exists
only *inside* traced computations.  The mode is off unless
:func:`set_planar_complex` or ``BDSP_PLANAR_COMPLEX`` turns it on: whether
it pays on a GPU is an open measurement (ROADMAP Speed 5d).

The whole vector API funnels device computation through :func:`call`
(see vector.py), so enabling the mode is transparent to users.
"""
from __future__ import annotations

import functools
import os
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

_mode: Optional[bool] = None


def set_planar_complex(enabled: bool) -> None:
    """Force planar-complex mode on/off (default: off)."""
    global _mode
    _mode = bool(enabled)


def planar_mode() -> bool:
    global _mode
    if _mode is None:
        env = os.environ.get("BDSP_PLANAR_COMPLEX")
        if env is not None:
            _mode = env not in ("", "0", "false")
        else:
            _mode = False
    return _mode


class PlanarComplex:
    """A complex array stored as two real planes (a jax pytree)."""

    __slots__ = ("re", "im")

    def __init__(self, re, im):
        self.re = re
        self.im = im

    # --- array-like surface used by the vector layer -------------------
    @property
    def shape(self):
        return self.re.shape

    @property
    def ndim(self):
        return self.re.ndim

    @property
    def dtype(self):
        return jnp.result_type(self.re.dtype, jnp.complex64)

    def __getitem__(self, idx):
        return PlanarComplex(self.re[idx], self.im[idx])

    def __repr__(self):
        return f"PlanarComplex(shape={self.shape}, dtype={self.dtype})"


jax.tree_util.register_pytree_node(
    PlanarComplex,
    lambda p: ((p.re, p.im), None),
    lambda aux, children: PlanarComplex(*children))


def is_planar(x) -> bool:
    return isinstance(x, PlanarComplex)


def unwrap(x):
    """PlanarComplex -> complex array (inside a trace); passthrough else."""
    if is_planar(x):
        cdtype = jnp.result_type(x.re.dtype, jnp.complex64)
        return x.re.astype(cdtype) + 1j * x.im.astype(cdtype)
    return x


def wrap(y, mode: bool):
    """complex array -> PlanarComplex when mode is on; recursive over
    tuples/lists."""
    if isinstance(y, (tuple, list)):
        return type(y)(wrap(v, mode) for v in y)
    if mode and hasattr(y, "dtype") and jnp.iscomplexobj(y):
        return PlanarComplex(jnp.real(y), jnp.imag(y))
    return y


def unwrap_planes(x):
    """Returns (re, im) planes for either representation (device ops)."""
    if is_planar(x):
        return x.re, x.im
    return call(jnp.real, x), call(jnp.imag, x)


def is_complex_repr(x) -> bool:
    """True if x represents complex data (either dtype or planar)."""
    return is_planar(x) or (hasattr(x, "dtype") and jnp.iscomplexobj(x))


@functools.lru_cache(maxsize=1024)
def _compiled(fn, mode: bool, static, _epoch: int, _salt: int = 0):
    """_epoch folds config.precision_epoch() into the cache key so that
    set_matmul_precision() immediately invalidates traced programs.
    _salt forces a fresh trace for host-callback (``_no_jit``) statics —
    their sampled values are baked into the jaxpr as constants, so a cache
    hit would silently reuse a previous call's samples."""
    @jax.jit
    def g(*arrays):
        args = [unwrap(a) for a in arrays]
        out = fn(*args, *static)
        return wrap(out, mode)

    return g


_nojit_salt = 0


def call(fn, *arrays, static=()):
    """Runs ``fn(*arrays, *static)`` under a cached jit with planar
    pack/unpack at the program boundary.  ``static`` entries are baked into
    the trace (must be hashable); ``arrays`` may be jnp arrays, Python
    scalars, or PlanarComplex.

    Host-callback statics (marked ``_no_jit``) are legal here because every
    argument they are sampled at is arange-derived and therefore concrete
    during tracing; each call retraces (see ``_salt``) so callbacks are
    re-sampled like the reference's per-call FFI evaluation."""
    mode = planar_mode()
    if mode:
        # Complex scalars must not become complex program inputs either.
        arrays = tuple(
            PlanarComplex(jnp.asarray(a.real), jnp.asarray(a.imag))
            if isinstance(a, complex) else a
            for a in arrays)
    from . import config
    salt = 0
    # _no_jit may sit on the object itself or (for bound-method statics
    # like fun.calc_freq) on the method's instance.
    if any(getattr(s, "_no_jit", False)
           or getattr(getattr(s, "__self__", None), "_no_jit", False)
           for s in static):
        global _nojit_salt
        _nojit_salt += 1
        salt = _nojit_salt
    return _compiled(fn, mode, tuple(static),
                     config.precision_epoch(), salt)(*arrays)


def to_host(x) -> np.ndarray:
    """Device -> host, transferring complex data as real planes."""
    if is_planar(x):
        return np.asarray(x.re) + 1j * np.asarray(x.im)
    if hasattr(x, "dtype") and jnp.iscomplexobj(x):
        re = np.asarray(call(jnp.real, x))
        im = np.asarray(call(jnp.imag, x))
        return re + 1j * im
    return np.asarray(x)


def from_host_complex(re, im):
    """Host real/imag -> device complex representation."""
    dt_re = getattr(re, "dtype", None) or np.asarray(re).dtype
    dt_im = getattr(im, "dtype", None) or np.asarray(im).dtype
    cdtype = jnp.result_type(dt_re, dt_im, jnp.complex64)
    rdtype = np.zeros((), np.dtype(cdtype)).real.dtype
    re = jnp.asarray(re).astype(rdtype)
    im = jnp.asarray(im).astype(rdtype)
    if planar_mode():
        return PlanarComplex(re, im)
    return call(_combine, re, im)


def _combine(re, im):
    cdtype = jnp.result_type(re.dtype, im.dtype, jnp.complex64)
    return re.astype(cdtype) + 1j * im.astype(cdtype)


def real_dtype_of(x):
    if is_planar(x):
        return x.re.dtype
    return jnp.zeros((), x.dtype).real.dtype
