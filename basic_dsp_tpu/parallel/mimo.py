"""Channel-parallel MIMO convolution over a device mesh.

``matrix.convolve_mat`` (vector side: time_freq/mod.rs:365-453) mixes C
input channels into C output channels through a (C, C) grid of impulse
responses, evaluated in the frequency domain.  Distributed form: the
channel axis shards over the mesh, every device FFTs its local input
rows, contracts them against ITS column block of the kernel grid, and one
``psum_scatter`` both reduces the partial channel mixes and leaves each
device exactly its block of output channels — a single reduce-scatter,
no all_gather of the (C, n) spectrum ever materializes.

Comm volume: psum_scatter moves (d-1)/d of C*n complex samples per
device — the same traffic as one all_to_all, half an
all_gather+local-reduce.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

try:  # jax >= 0.4.35
    from jax import shard_map
except ImportError:  # pragma: no cover
    from jax.experimental.shard_map import shard_map

from .. import config
from ..ops import conv_ops

_FN_CACHE: dict = {}


def sharded_convolve_mat(x: jnp.ndarray, imp: np.ndarray, mesh: Mesh,
                         axis_name=None) -> jnp.ndarray:
    """Distributed ``matrix._convolve_mat``: ``out[c] = sum_r
    rows[r] (*) imp[c, r]`` with rows (C, n) sharded over channels.

    ``imp``: (C, C, taps) kernel grid (out_channel, in_channel, tap).
    Requires ``C % mesh_size == 0``.  Returns the (C, n) output sharded
    over channels.  On a hierarchical (host, chip) mesh the
    ``psum_scatter`` lowers to a reduce-scatter inside each host plus
    one cross-host reduce of the (C/d, n) partials.
    """
    from . import collectives
    axis_name = collectives.resolve_axes(mesh, axis_name)
    C, n = x.shape
    d = collectives.mesh_size(mesh, axis_name)
    if C % d != 0:
        raise ValueError(
            f"sharded_convolve_mat: channel count {C} must divide by the "
            f"mesh size {d} (channel-sharding contract, docs/API.md)")
    if imp.ndim != 3 or imp.shape[0] != C or imp.shape[1] != C:
        raise ValueError("impulse_response must be (C, C, taps)")

    cdtype = jnp.result_type(x.dtype, jnp.complex64)
    # Kernel spectra: small (taps -> n roll/pad) and static per call site —
    # built once globally, sharded over the INPUT-channel axis r so each
    # device holds G[:, r_local, :].
    g = conv_ops.kernel_layout(jnp.asarray(imp).astype(cdtype), n)
    G = jnp.fft.fft(g, axis=-1)
    G = jax.device_put(G, NamedSharding(mesh, P(None, axis_name, None)))

    prec = config.matmul_precision()

    fkey = (C, n, d, axis_name, jnp.dtype(x.dtype).name, str(prec),
            tuple(dev.id for dev in mesh.devices.flat))
    fn = _FN_CACHE.get(fkey)
    if fn is None:
        def local(xl, Gl):
            # xl: (C/d, n) local input rows; Gl: (C, C/d, n) kernel block.
            X = jnp.fft.fft(xl.astype(cdtype), axis=-1)
            partial = jnp.einsum("crn,rn->cn", Gl, X, precision=prec)
            # Reduce the channel mix across devices AND scatter the output
            # channel axis in one collective.
            Y = jax.lax.psum_scatter(partial, axis_name,
                                     scatter_dimension=0, tiled=True)
            return jnp.fft.ifft(Y, axis=-1)

        in_specs = (P(axis_name, None), P(None, axis_name, None))
        out_specs = P(axis_name, None)
        try:
            fn = shard_map(local, mesh=mesh, in_specs=in_specs,
                           out_specs=out_specs, check_vma=False)
        except TypeError:  # pragma: no cover - jax < 0.7 spelling
            fn = shard_map(local, mesh=mesh, in_specs=in_specs,
                           out_specs=out_specs, check_rep=False)
        fn = jax.jit(fn)
        _FN_CACHE[fkey] = fn
    out = fn(x, G)
    if not jnp.iscomplexobj(x):
        return jnp.real(out).astype(x.dtype)
    return out
