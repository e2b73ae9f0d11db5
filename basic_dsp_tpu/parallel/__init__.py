"""Multi-device execution: mesh sharding, halo-exchange convolution,
collective statistics.

This subsystem replaces the reference's multicore scheduler
(multicore_support/threading.rs — thread fan-out over sample chunks) with
``jax.sharding`` + ``shard_map`` over a device mesh: sample blocks become
*shards*, the ``imp_len - 1`` overlap that the reference's overlap-save loop
carries between blocks (convolution.rs:325-341) becomes a ``ppermute`` halo
exchange between neighbouring devices, and the mergeable per-thread
statistics partials (statistics.rs:211-250) become ``psum``/merge across
devices.
"""
from . import collectives
from .sharded import (
    sharded_convolve_signal,
    sharded_interpolatef,
    sharded_statistics,
    sharded_sum,
    shard_time_axis,
)
from .channelizer import (polyphase_channelizer, fm_demodulate,
                          channelize_and_demod,
                          channelize_and_demod_planar,
                          sharded_channelize_and_demod)
from .mimo import sharded_convolve_mat
