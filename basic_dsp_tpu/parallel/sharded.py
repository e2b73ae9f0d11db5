"""Time-axis sharded convolution and collective reductions.

The sequence-parallel analog for DSP (SURVEY.md §2.5): a long signal is
sharded over a 1-D mesh; the circular centered convolution runs blockwise on
every chip, with the ``m_eff - 1`` boundary taps exchanged between ring
neighbors via ``jax.lax.ppermute``.  Because the global convolution is
*circular*, the ring topology supplies exactly the right wrap-around at the
first/last shard — no special-casing (the reference patches these edges with
scalar convolution, convolution.rs:374-398; here the ring does it).

Multi-host: every entry point also accepts a hierarchical
``(host, chip)`` mesh (``config.make_mesh(shape=(H, C))``) — the signal
shards over the flattened host-major device order and the halo exchange
runs hierarchically (intra-host ppermute everywhere + a cross-host
handoff only at host boundaries; see parallel/collectives.py).
Inter-host traffic per call = halo_bytes * n_hosts, independent of
devices per host.
"""
from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from .. import config
from ..ops import conv_ops, stats_ops
from . import collectives


def shard_time_axis(x: jnp.ndarray, mesh: Mesh,
                    axis_name=None) -> jnp.ndarray:
    """Places a signal on the mesh, sharded over its last (time) axis.
    Defaults to sharding over ALL mesh axes host-major (1-D meshes keep
    their single axis)."""
    axes = collectives.resolve_axes(mesh, axis_name)
    spec = P(*([None] * (x.ndim - 1) + [axes]))
    return jax.device_put(x, NamedSharding(mesh, spec))


def _local_overlap_save(x_local, h_eff, m_eff, c, fft_len, axis_name):
    """Per-shard body: halo exchange + batched-FFT block convolution.

    ``x_local``: (ln,) shard.  Outputs the (ln,) shard of the global
    circular centered convolution.  ``axis_name`` may be a tuple
    (hierarchical mesh): the ring shift then runs intra-host first with a
    cross-host handoff only at host boundaries (collectives.shift_from_*).
    """
    halo_l = m_eff - c     # samples needed before each output
    halo_r = c - 1         # samples needed after each output
    # Ring exchange: my tail becomes my right neighbor's left halo; my head
    # becomes my left neighbor's right halo.
    left_halo = collectives.shift_from_left(x_local[..., -halo_l:],
                                            axis_name) \
        if halo_l > 0 else x_local[..., :0]
    right_halo = collectives.shift_from_right(x_local[..., :halo_r],
                                              axis_name) \
        if halo_r > 0 else x_local[..., :0]
    ext = jnp.concatenate([left_halo, x_local, right_halo], axis=-1)

    ln = x_local.shape[-1]
    # Local outputs are the linear convolution of the halo-extended shard,
    # offset by m_eff - 1.  Short kernels ride the Toeplitz matmul path
    # (zero-pad makes the circular evaluation linear); long kernels use the
    # gather-free overlap-add batched-FFT pipeline.
    if m_eff <= 202:
        pad = [(0, 0)] * (ext.ndim - 1) + [(0, m_eff)]
        ext_p = jnp.pad(ext, pad)
        circ = conv_ops.toeplitz_conv(ext_p, h_eff, True)
        return circ[..., m_eff - c: m_eff - c + ln]
    lin = conv_ops.blocked_linear_conv(ext, h_eff, fft_len)
    return lin[..., m_eff - 1: m_eff - 1 + ln]


def sharded_convolve_signal(x: jnp.ndarray, h: jnp.ndarray, mesh: Mesh,
                            axis_name=None,
                            fft_len: int = 0) -> jnp.ndarray:
    """Circular centered convolution of a time-sharded signal.

    Semantics identical to ``ops.conv_ops.convolve_signal_fft`` (and hence
    the reference's ``convolve_signal``); execution is fully sharded —
    per-shard batched FFTs plus one neighbor halo shift (hierarchical on
    2-D (host, chip) meshes: intra-host ppermute + host-boundary handoff).

    Requires ``len(x) % mesh.size == 0`` and a local shard at least as long
    as the (clipped) kernel.
    """
    axis_name = collectives.resolve_axes(mesh, axis_name)
    n = x.shape[-1]
    m = h.shape[-1]
    d = collectives.mesh_size(mesh, axis_name)
    if n % d != 0:
        raise ValueError(f"signal length {n} not divisible by mesh size {d}; sharded entry "
            f"points require n % n_devices == 0 — pad with zero_pad or pick "
            f"a submesh (docs/API.md, divisibility contract)")
    start, length, c = conv_ops._clip_kernel(n, m)
    m_eff = length
    if n // d < m_eff:
        raise ValueError("shard shorter than kernel; use fewer devices")
    fft_len = conv_ops.pick_fft_len(m_eff, fft_len)
    cdtype = jnp.result_type(x.dtype, h.dtype, jnp.complex64)
    h_eff = h[..., start:start + length].astype(cdtype)

    fn = _sharded_conv_fn(mesh, axis_name, m_eff, c, fft_len,
                           config.precision_epoch())
    out = fn(x.astype(cdtype), h_eff)
    if not jnp.iscomplexobj(x) and not jnp.iscomplexobj(h):
        out = jnp.real(out).astype(x.dtype)
    return out


@functools.lru_cache(maxsize=64)
def _sharded_conv_fn(mesh: Mesh, axis_name, m_eff: int, c: int,
                     fft_len: int, _precision_epoch: int = 0):
    """Jitted shard_map conv, cached per (mesh, kernel geometry) so repeated
    calls reuse the compiled executable.  ``_precision_epoch`` folds the
    matmul-precision dial into the key (see config.set_matmul_precision)."""
    body = functools.partial(_local_overlap_save, m_eff=m_eff, c=c,
                             fft_len=fft_len, axis_name=axis_name)
    return jax.jit(jax.shard_map(
        lambda xs, he: body(xs, he),
        mesh=mesh,
        in_specs=(P(axis_name), P()),
        out_specs=P(axis_name),
    ))


def sharded_interpolatef(x: jnp.ndarray, fun, interpolation_factor: float,
                         delay: float, conv_len: int, mesh: Mesh,
                         axis_name=None,
                         delta: float = 1.0) -> jnp.ndarray:
    """Fractional resampling of a time-sharded signal.

    Semantics identical to ``ops.interp_ops.interpolatef`` (reference
    interpolation.rs:387-482) for exact rational factors ``P/Q``;
    execution is fully sharded: each shard runs the banded-matmul direct
    resampler (interp_ops._direct_apply) on its halo-extended block, with
    the ``L``-left / ``W-L``-right boundary samples exchanged between
    ring neighbors via ``ppermute`` — the ring supplies the global
    circular wrap exactly, as in :func:`sharded_convolve_signal`.

    Requires ``len(x) % mesh.size == 0`` and a local shard divisible by
    ``128*Q`` (the output-block geometry) and longer than the halo.
    """
    from ..ops import interp_ops

    axis_name = collectives.resolve_axes(mesh, axis_name)
    n = x.shape[-1]
    d = collectives.mesh_size(mesh, axis_name)
    if n % d != 0:
        raise ValueError(f"signal length {n} not divisible by mesh size {d}; sharded entry "
            f"points require n % n_devices == 0 — pad with zero_pad or pick "
            f"a submesh (docs/API.md, divisibility contract)")
    ln = n // d
    delay = delay / delta
    L = min(conv_len, n // 2)
    P, Q = interp_ops.parse_rational_factor(interpolation_factor,
                                            "sharded_interpolatef")
    if 2 * L + 1 > ln:
        raise ValueError("shard shorter than the interpolation window; "
                         "use fewer devices")
    if ln % (128 * Q) != 0:
        raise ValueError(f"local shard length {ln} must be divisible by "
                         f"128*Q = {128 * Q}")
    rdtype = jnp.zeros((), x.dtype).real.dtype
    taps, offs = interp_ops.polyphase_taps(fun, P, Q, delay, L, rdtype)
    if isinstance(taps, jax.core.Tracer) or jnp.iscomplexobj(taps):
        raise ValueError("sharded_interpolatef needs concrete real taps")
    M = interp_ops._direct_band_matrix(taps, P, Q, offs, L,
                                       np.dtype(rdtype))
    W = int(M.shape[0])
    nb = ln // (128 * Q)
    # ext must reach nb*span + W - 128 samples (the shifted-reshape slices
    # in _direct_apply); with nb*span == ln that is a right halo of
    # W - 128 - L beyond the L-sample left halo.
    halo_l, halo_r = L, max(0, W - 128 - L)
    if halo_l > ln or halo_r > ln:
        raise ValueError("shard too short for the interpolation halo")
    fn = _sharded_interp_fn(mesh, axis_name, P, Q, nb, halo_l, halo_r,
                            jnp.iscomplexobj(x), config.precision_epoch())
    return fn(x, M)


@functools.lru_cache(maxsize=64)
def _sharded_interp_fn(mesh: Mesh, axis_name, poly_p: int, poly_q: int,
                       nb: int, halo_l: int, halo_r: int, is_complex: bool,
                       _precision_epoch: int = 0):
    """Jitted shard_map resampler, cached per (mesh, geometry); the band
    matrix rides as a replicated argument so equal-geometry calls with
    different taps reuse the executable."""
    from ..ops import interp_ops

    def body(xl, M):
        def one_plane(pl):
            left = (collectives.shift_from_left(pl[..., -halo_l:],
                                                axis_name)
                    if halo_l else pl[..., :0])
            right = (collectives.shift_from_right(pl[..., :halo_r],
                                                  axis_name)
                     if halo_r else pl[..., :0])
            ext = jnp.concatenate([left, pl, right], axis=-1)
            return interp_ops._direct_apply(ext, M, poly_p, poly_q, nb)

        if is_complex:
            return jax.lax.complex(one_plane(jnp.real(xl)),
                                   one_plane(jnp.imag(xl)))
        return one_plane(xl)

    return jax.jit(jax.shard_map(
        body, mesh=mesh,
        in_specs=(P(axis_name), P()),
        out_specs=P(axis_name),
    ))


def sharded_sum(x: jnp.ndarray, mesh: Mesh, axis_name=None):
    """psum-reduced sum over a time-sharded signal (hierarchical meshes:
    XLA reduces inside hosts first, then across hosts)."""
    axis_name = collectives.resolve_axes(mesh, axis_name)
    fn = jax.shard_map(
        lambda xs: jax.lax.psum(jnp.sum(xs, axis=-1), axis_name),
        mesh=mesh, in_specs=P(axis_name), out_specs=P())
    return fn(x)


def sharded_statistics(x: jnp.ndarray, mesh: Mesh,
                       axis_name=None,
                       is_complex: Optional[bool] = None):
    """Statistics over a time-sharded signal.

    Per-shard partials reduce with the same merge semantics the reference
    uses for its per-thread partials (statistics.rs:211-250): sums/sumsq via
    ``psum``, min/max (+ global index) via ``pmin``/``pmax`` on
    (key, global_index) pairs.
    """
    axis_name = collectives.resolve_axes(mesh, axis_name)
    if is_complex is None:
        is_complex = bool(jnp.iscomplexobj(x))
    n = x.shape[-1]
    d = collectives.mesh_size(mesh, axis_name)
    if n % d != 0:
        raise ValueError(f"signal length {n} not divisible by mesh size {d}; sharded entry "
            f"points require n % n_devices == 0 — pad with zero_pad or pick "
            f"a submesh (docs/API.md, divisibility contract)")
    ln = n // d

    def body(xs):
        i = collectives.flat_index(axis_name)
        base = i * ln
        s = jax.lax.psum(jnp.sum(xs), axis_name)
        sq = jax.lax.psum(jnp.sum(xs * xs), axis_name)
        # NaN-skipping keys (reference strict-compare update semantics —
        # see stats_ops._minmax_keys); also keeps the owner-selection
        # below well-defined: NaN keys would make every equality test
        # false and no shard would publish the extremum.
        kmin, kmax = stats_ops._minmax_keys(
            jnp.abs(xs) if is_complex else xs)
        lmin = jnp.min(kmin)
        lmax = jnp.max(kmax)
        lmin_i = base + jnp.argmin(kmin)
        lmax_i = base + jnp.argmax(kmax)
        gmin = jax.lax.pmin(lmin, axis_name)
        gmax = jax.lax.pmax(lmax, axis_name)
        # The owner of the global extremum publishes value+index; others
        # contribute zeros (psum-combine).  Ties resolve to one owner via
        # index-min.
        is_min_owner = lmin == gmin
        is_max_owner = lmax == gmax
        min_owner_rank = jax.lax.pmin(
            jnp.where(is_min_owner, i, d), axis_name)
        max_owner_rank = jax.lax.pmin(
            jnp.where(is_max_owner, i, d), axis_name)
        sel_min = (i == min_owner_rank)
        sel_max = (i == max_owner_rank)
        if is_complex:
            min_val = jax.lax.psum(
                jnp.where(sel_min, xs[jnp.argmin(kmin)], 0), axis_name)
            max_val = jax.lax.psum(
                jnp.where(sel_max, xs[jnp.argmax(kmax)], 0), axis_name)
        else:
            # Real extrema equal their keys; publishing the key (not
            # xs[argmin]) keeps the all-NaN case at +-inf like the
            # single-chip path.
            min_val = jax.lax.psum(jnp.where(sel_min, lmin, 0), axis_name)
            max_val = jax.lax.psum(jnp.where(sel_max, lmax, 0), axis_name)
        min_idx = jax.lax.psum(jnp.where(sel_min, lmin_i, 0), axis_name)
        max_idx = jax.lax.psum(jnp.where(sel_max, lmax_i, 0), axis_name)
        return s, sq, min_val, min_idx, max_val, max_idx

    fn = jax.shard_map(body, mesh=mesh, in_specs=P(axis_name),
                       out_specs=(P(), P(), P(), P(), P(), P()))
    s, sq, mn, mn_i, mx, mx_i = (v.item() for v in fn(x))
    if is_complex:
        rms = complex(sq / n) ** 0.5
    else:
        rms = (sq / n) ** 0.5
    return stats_ops.Statistics(sum=s, count=n, average=s / n, rms=rms,
                                min=mn, min_index=int(mn_i), max=mx,
                                max_index=int(mx_i))
