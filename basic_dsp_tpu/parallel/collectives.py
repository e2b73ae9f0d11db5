"""Hierarchical (multi-host-shaped) collective helpers.

The distributed layer scales 1 device -> 1 host -> N hosts.  A multi-host
deployment is a 2-D ``(host, chip)`` mesh: the ``chip`` axis stays inside
a host (fast links, e.g. NVLink between the GPUs of one machine), the
``host`` axis crosses the network between hosts (slow).  Four GPUs of one
machine are a 1-D mesh.  Every sharded op in this package therefore
addresses the
mesh through these helpers, which accept EITHER a single axis name (the
1-D intra-host mesh, the reference's multicore analog —
threading.rs:293-765) or a tuple of axis names ordered outermost-first
(``("host", "chip")``): the time/channel axis shards over the flattened
host-major device order.

Comm placement:

* ``shift_from_left/right`` (halo exchange for overlap-save, resampling,
  channelizer lookback) decomposes the flattened-ring neighbor shift
  hierarchically: every device ppermutes along the INNERMOST (intra-host)
  axis; only devices on a host boundary (chip index 0 or C-1, i.e. 1/C
  of them) additionally forward their halo along the host axis.
  Inter-host traffic per step = halo_bytes * n_hosts, independent of the
  per-host device count — the halo handoff is the only inter-host data.
* ``psum``/``pmin``/``pmax`` take tuples natively in jax; XLA lowers
  them hierarchically (reduce inside hosts first, then across hosts) on
  multi-host topologies.
* ``all_to_all`` over the tuple (used by the distributed four-step FFT)
  is the one op whose traffic is inherently all-pairs; callers document
  their inter-host volume separately (see sharded_fft).
"""
from __future__ import annotations

from typing import Sequence, Tuple, Union

import jax
import jax.numpy as jnp
import numpy as np

AxisNames = Union[str, Tuple[str, ...]]


def norm_axes(axis_name: AxisNames) -> Tuple[str, ...]:
    """Axis spec -> tuple ordered outermost-first."""
    if isinstance(axis_name, str):
        return (axis_name,)
    return tuple(axis_name)


def mesh_axes(mesh: jax.sharding.Mesh) -> Tuple[str, ...]:
    """All axis names of a mesh, outermost-first (the time-axis shard
    order)."""
    return tuple(mesh.axis_names)


def resolve_axes(mesh: jax.sharding.Mesh,
                 axis_name: AxisNames = None) -> Tuple[str, ...]:
    """Default axis spec: every mesh axis (host-major).  A 1-D ``dsp``
    mesh keeps its historical behavior; passing an explicit name (or
    tuple) selects a sub-sharding."""
    if axis_name is None:
        return mesh_axes(mesh)
    axes = norm_axes(axis_name)
    missing = [a for a in axes if a not in mesh.axis_names]
    if missing:
        raise ValueError(f"axis {missing} not in mesh axes "
                         f"{mesh.axis_names}")
    return axes


def mesh_size(mesh: jax.sharding.Mesh, axes: Sequence[str]) -> int:
    out = 1
    for a in norm_axes(tuple(axes)):
        out *= int(mesh.shape[a])
    return out


def axis_sizes(mesh: jax.sharding.Mesh, axes: Sequence[str]):
    return tuple(int(mesh.shape[a]) for a in norm_axes(tuple(axes)))


def flat_index(axes: AxisNames):
    """Global host-major rank of this device along the flattened axes
    (inside shard_map)."""
    axes = norm_axes(axes)
    idx = jax.lax.axis_index(axes[0])
    for a in axes[1:]:
        idx = idx * jax.lax.axis_size(a) + jax.lax.axis_index(a)
    return idx


def flat_size(axes: AxisNames):
    axes = norm_axes(axes)
    n = 1
    for a in axes:
        n *= jax.lax.axis_size(a)
    return n


def shift_from_left(val, axes: AxisNames, wrap: bool = True):
    """Each device receives ``val`` from its LEFT neighbor in the
    flattened host-major ring (inside shard_map).

    Hierarchical: one ppermute along the innermost (intra-host) axis
    moves every shard; a recursive outer-axis ppermute then corrects
    the devices that sit on an outer-axis boundary — only the halo
    crosses hosts.  ``wrap=False`` feeds zeros into the global first
    device (ppermute's missing-source convention), the causal-padding
    edge the channelizer uses."""
    axes = norm_axes(axes)
    inner = axes[-1]
    outer = axes[:-1]
    d = jax.lax.axis_size(inner)
    if outer or wrap:
        perm = [(i, (i + 1) % d) for i in range(d)]
    else:
        perm = [(i, i + 1) for i in range(d - 1)]
    p1 = jax.lax.ppermute(val, inner, perm)
    if outer:
        fixed = shift_from_left(p1, outer, wrap)
        p1 = jnp.where(jax.lax.axis_index(inner) == 0, fixed, p1)
    return p1


def shift_from_right(val, axes: AxisNames, wrap: bool = True):
    """Mirror of :func:`shift_from_left`: receive from the RIGHT
    neighbor of the flattened ring."""
    axes = norm_axes(axes)
    inner = axes[-1]
    outer = axes[:-1]
    d = jax.lax.axis_size(inner)
    if outer or wrap:
        perm = [(i, (i - 1) % d) for i in range(d)]
    else:
        perm = [(i, i - 1) for i in range(1, d)]
    p1 = jax.lax.ppermute(val, inner, perm)
    if outer:
        fixed = shift_from_right(p1, outer, wrap)
        p1 = jnp.where(jax.lax.axis_index(inner) == d - 1, fixed, p1)
    return p1
