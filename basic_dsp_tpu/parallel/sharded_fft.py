"""Mesh-distributed FFT via the four-step (Bailey) decomposition.

A length-N DFT with N = N1*N2 factors into: columns-FFT (N1) -> twiddle ->
rows-FFT (N2) -> transpose.  The distributed form is the classic
"transpose algorithm": every FFT stage is LOCAL and the axis
redistributions are explicit ``jax.lax.all_to_all`` collectives inside a
``shard_map`` — nothing is left to XLA's sharding propagation (the round-2
``with_sharding_constraint`` formulation let XLA place the reshards, and
on an 8-device CPU mesh strong scaling went backwards).

Comm-volume model: natural-order in, natural-order out takes exactly
THREE all_to_alls — (1) time-block shards -> column shards for the
stage-1 FFTs, (2) column -> row shards between stages, (3) row ->
output-block shards for the natural-order flatten.  Each moves the full N
complex samples across the mesh once (each device sends (d-1)/d of its
N/d shard), so total traffic = 3*N*8 bytes between devices while local
compute is (N/d)*log2(N) per device: the comm fraction is fixed in d and strong
scaling is monotone.  Callers that can consume the four-step layout pass
``natural_order=False`` and skip collective (3).

The single-chip variant (``four_step_fft``) is also the building block the
blocked pipelines use for very large transforms.

Reference anchors: split/merge round-robin semantics
(vector/src/vector_types/general/data_reorganization.rs:170-214) are the
single-node analog of these axis redistributions; SURVEY.md §2.5/§5 maps
them onto all_to_all.
"""
from __future__ import annotations

import math

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

try:  # jax >= 0.4.35 moved shard_map out of experimental
    from jax import shard_map
except ImportError:  # pragma: no cover - older jax
    from jax.experimental.shard_map import shard_map


def _split_factors(n: int):
    """n = n1 * n2 with n1, n2 as close as possible (balanced powers of two
    when n is a power of two)."""
    if n & (n - 1) == 0:
        half = (n.bit_length() - 1) // 2
        n1 = 1 << half
        return n1, n // n1
    r = int(math.isqrt(n))
    while n % r != 0:
        r -= 1
    return r, n // r


def four_step_fft(x: jnp.ndarray, n1: int = 0, n2: int = 0) -> jnp.ndarray:
    """Unscaled forward DFT == jnp.fft.fft, evaluated as two batched
    smaller FFTs + twiddle + transpose."""
    n = x.shape[-1]
    if not n1:
        n1, n2 = _split_factors(n)
    assert n1 * n2 == n
    A = x.reshape(x.shape[:-1] + (n1, n2))
    B = jnp.fft.fft(A, axis=-2)
    k1 = jnp.arange(n1)[:, None]
    m2 = jnp.arange(n2)[None, :]
    tw = jnp.exp(-2j * jnp.pi * ((k1 * m2) % n) / n).astype(B.dtype)
    C = jnp.fft.fft(B * tw, axis=-1)
    return jnp.swapaxes(C, -1, -2).reshape(x.shape)


def four_step_ifft(x: jnp.ndarray, n1: int = 0, n2: int = 0) -> jnp.ndarray:
    """Unscaled inverse DFT == N * jnp.fft.ifft (rustfft convention)."""
    out = jnp.conj(four_step_fft(jnp.conj(x), n1, n2))
    return out


def _factors_for_mesh(n: int, d: int):
    """n = n1 * n2 with d | n1 and d | n2, as balanced as divisibility
    allows (both divisibilities are required: the input reshape needs
    d | n1 and the all_to_all column splits need d | n2)."""
    n1, n2 = _split_factors(n)
    if n1 % d == 0 and n2 % d == 0:
        return n1, n2
    if n % (d * d) == 0:
        m = n // (d * d)
        r = int(math.isqrt(m))
        while m % r != 0:
            r -= 1
        return r * d, (m // r) * d
    raise ValueError(
        f"sharded_fft: length {n} cannot split as n1*n2 with mesh size {d} "
        f"dividing both factors; need d^2 | n — power-of-two lengths >= "
        f"d^2 always qualify (docs/API.md, divisibility contract)")


_TWIDDLE_CACHE: dict = {}
_FN_CACHE: dict = {}


def _twiddle_for(n: int, n1: int, n2: int, mesh: Mesh, axis_name,
                 dtype) -> jnp.ndarray:
    """Precomputed four-step twiddle W[j2, k1] = exp(-2πi·k1·j2/n), built
    ONCE on the host in numpy and device_put sharded over j2 (FFTW-style
    plan data).  jnp ops on constants are STAGED inside jit traces, so a
    jnp-built twiddle would recompute the full N complex exponentials on
    every call."""
    import numpy as np
    key = (n, n1, n2, axis_name, tuple(d.id for d in mesh.devices.flat),
           jnp.dtype(dtype).name)
    tw = _TWIDDLE_CACHE.get(key)
    if tw is None:
        k1 = np.arange(n1)[None, :]
        j2 = np.arange(n2)[:, None]
        ang = (-2.0 * np.pi / n) * ((k1 * j2) % n)
        tw = np.exp(1j * ang).astype(dtype)
        sharding = jax.sharding.NamedSharding(mesh, P(axis_name, None))
        tw = jax.device_put(tw, sharding)
        _TWIDDLE_CACHE[key] = tw
    return tw


def _local_fourstep(xl, twl, n1, n2, d, axis_name, natural_order):
    """Per-device body of the distributed four-step FFT (runs inside
    shard_map; comm-volume model in the module docstring).

    xl: this device's contiguous (n/d,) time block == rows
    [i*n1/d, (i+1)*n1/d) of the row-major (n1, n2) matrix."""
    A = xl.reshape(n1 // d, n2)
    # (1) time blocks -> column shards: (n1, n2/d) local after.
    A = jax.lax.all_to_all(A, axis_name, split_axis=1, concat_axis=0,
                           tiled=True)
    # Stage 1: length-n1 FFTs, one per local column, along the
    # contiguous axis: B[j2_local, k1].
    B = jnp.fft.fft(A.T)
    B = B * twl  # twl[j2_local, k1], precomputed
    # (2) column -> row shards: split k1, gather j2 -> (n2, n1/d).
    B = jax.lax.all_to_all(B, axis_name, split_axis=1, concat_axis=0,
                           tiled=True)
    # Stage 2: length-n2 FFTs along the contiguous axis after a
    # local transpose: C[k1_local, k2].
    C = jnp.fft.fft(B.T)
    if not natural_order:
        return C
    # (3) row shards -> output blocks: device i ends with all k1 and
    # k2 in [i*n2/d, (i+1)*n2/d); transpose+flatten is then exactly
    # the contiguous output block [i*n/d, (i+1)*n/d) of the
    # natural-order spectrum X[k2*n1 + k1].
    C = jax.lax.all_to_all(C, axis_name, split_axis=1, concat_axis=0,
                           tiled=True)
    return C.T.reshape(-1)


def _twiddle_planes_for(n: int, n1: int, n2: int, mesh: Mesh,
                        axis_name, rdtype_name: str):
    """Planar (cos, sin) twiddle planes, host-built and device_put
    sharded — the complex-free analog of :func:`_twiddle_for`."""
    import numpy as np
    key = ("planes", n, n1, n2, axis_name,
           tuple(d.id for d in mesh.devices.flat), rdtype_name)
    tw = _TWIDDLE_CACHE.get(key)
    if tw is None:
        k1 = np.arange(n1)[None, :]
        j2 = np.arange(n2)[:, None]
        ang = (-2.0 * np.pi / n) * ((k1 * j2) % n)
        rdtype = np.dtype(rdtype_name)
        sharding = jax.sharding.NamedSharding(mesh, P(axis_name, None))
        tw = (jax.device_put(np.cos(ang).astype(rdtype), sharding),
              jax.device_put(np.sin(ang).astype(rdtype), sharding))
        _TWIDDLE_CACHE[key] = tw
    return tw


def sharded_fft(x: jnp.ndarray, mesh: Mesh, axis_name=None,
                natural_order: bool = True) -> jnp.ndarray:
    """Distributed unscaled DFT of a time-sharded signal (explicit
    shard_map; comm-volume model in the module docstring).

    Every FFT runs along the CONTIGUOUS last axis (a strided axis-0 FFT
    measured 12x slower on the CPU mesh: 17.0 vs 1.45 ms at (1024,1024));
    the layout flips are explicit local transposes, which XLA fuses with
    the adjoining collective's copy.

    With ``natural_order=False`` the result is the four-step (n1, n2)
    matrix BEFORE the final transpose, sharded over rows — element
    (k1, k2) is spectrum bin ``k1 + n1*k2``.  That skips the third
    all_to_all for pipelines that can consume the transposed layout
    (e.g. magnitude reductions)."""
    from . import collectives
    axis_name = collectives.resolve_axes(mesh, axis_name)
    n = x.shape[-1]
    d = collectives.mesh_size(mesh, axis_name)
    n1, n2 = _factors_for_mesh(n, d)
    # Twiddle dtype must be the COMPLEX result type: astype(x.dtype) for
    # a real input would silently truncate the imaginary part (numpy only
    # warns) and corrupt the whole spectrum.
    tw = _twiddle_for(n, n1, n2, mesh, axis_name,
                      jnp.result_type(x.dtype, jnp.complex64))

    # jit caches on function identity — a fresh `local` closure per call
    # would RECOMPILE every invocation (~50 ms, dominated round-2 CPU-mesh
    # timings).  Key the compiled program like the twiddle.
    fkey = (n, n1, n2, axis_name, natural_order,
            tuple(dev.id for dev in mesh.devices.flat),
            jnp.dtype(x.dtype).name)
    cached = _FN_CACHE.get(fkey)
    if cached is not None:
        return cached(x, tw)

    def local(xl, twl):
        return _local_fourstep(xl, twl, n1, n2, d, axis_name,
                               natural_order)

    out_spec = P(axis_name) if natural_order else P(axis_name, None)
    in_specs = (P(axis_name), P(axis_name, None))
    try:
        fn = shard_map(local, mesh=mesh, in_specs=in_specs,
                       out_specs=out_spec, check_vma=False)
    except TypeError:  # pragma: no cover - jax < 0.7 spelling
        fn = shard_map(local, mesh=mesh, in_specs=in_specs,
                       out_specs=out_spec, check_rep=False)
    fn = jax.jit(fn)
    _FN_CACHE[fkey] = fn
    return fn(x, tw)


def sharded_fft_planar(xr: jnp.ndarray, xi: jnp.ndarray, mesh: Mesh,
                       axis_name=None,
                       natural_order: bool = True):
    """:func:`sharded_fft` with a PLANAR (re, im) program boundary.

    The planar-mode program boundary (``_planar.py``): this entry ships
    the time-sharded signal and the spectrum as f32/f64 plane pairs,
    building the complex view only inside the traced shard_map.  Same collectives, comm model and
    divisibility contract as :func:`sharded_fft`.
    """
    from . import collectives
    axis_name = collectives.resolve_axes(mesh, axis_name)
    n = xr.shape[-1]
    d = collectives.mesh_size(mesh, axis_name)
    n1, n2 = _factors_for_mesh(n, d)
    cdtype = jnp.result_type(xr.dtype, jnp.complex64)
    # Ship the twiddle as PLANES too: device_put of a complex host array
    # is itself a boundary crossing on hostile backends.
    twr, twi = _twiddle_planes_for(n, n1, n2, mesh, axis_name,
                                   jnp.dtype(xr.dtype).name)

    fkey = ("planar", n, n1, n2, axis_name, natural_order,
            tuple(dev.id for dev in mesh.devices.flat),
            jnp.dtype(xr.dtype).name)
    fn = _FN_CACHE.get(fkey)
    if fn is None:
        def local(xlr, xli, twlr, twli):
            out = _local_fourstep(
                (xlr + 1j * xli).astype(cdtype),
                (twlr + 1j * twli).astype(cdtype),
                n1, n2, d, axis_name, natural_order)
            return jnp.real(out), jnp.imag(out)

        out_sp = P(axis_name) if natural_order else P(axis_name, None)
        in_specs = (P(axis_name), P(axis_name),
                    P(axis_name, None), P(axis_name, None))
        try:
            fn = shard_map(local, mesh=mesh, in_specs=in_specs,
                           out_specs=(out_sp, out_sp), check_vma=False)
        except TypeError:  # pragma: no cover - jax < 0.7 spelling
            fn = shard_map(local, mesh=mesh, in_specs=in_specs,
                           out_specs=(out_sp, out_sp), check_rep=False)
        fn = jax.jit(fn)
        _FN_CACHE[fkey] = fn
    return fn(xr, xi, twr, twi)
