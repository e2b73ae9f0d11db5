"""Edge-case sweep for the distributed layer and the Gen erroneous
protocol: NaN/tie inputs through sharded_statistics,
non-divisible meshes raising cleanly, sharded convolution with the kernel
filling a whole shard, and wrong-flavor Gen vectors marking erroneous across
every op family — the reference's parameterized_vector_test discipline
(tests/tools/mod.rs:225-321) applied to the failure paths."""
import jax.numpy as jnp
import numpy as np
import pytest

import basic_dsp_tpu as bd
from basic_dsp_tpu.meta import DataDomain
from basic_dsp_tpu.ops import conv_ops
from basic_dsp_tpu.parallel import (sharded_convolve_signal,
                                    sharded_statistics, shard_time_axis)
from tools import assert_vector_eq, create_complex_data, create_data


@pytest.fixture(scope="module")
def mesh():
    return bd.make_mesh()


# ----------------------------------------------------------------------
# NaN / tie semantics: statistics.rs:250-263 updates min/max with strict
# comparisons, so NaN never wins an extremum (only sum/rms get poisoned)
# and ties keep the FIRST index.  Sharded must agree with single-chip.
# ----------------------------------------------------------------------
def test_statistics_nan_skipped_for_extrema():
    data = create_data(1, 64)
    data[10] = np.nan
    s = bd.to_real_time_vec(data).statistics()
    clean = data[~np.isnan(data)]
    assert np.isnan(s.sum) and np.isnan(s.rms)
    assert s.min == clean.min() and s.max == clean.max()
    assert s.min_index == int(np.nanargmin(data))
    assert s.max_index == int(np.nanargmax(data))


def test_statistics_all_nan_leaves_empty_extrema():
    data = np.full(16, np.nan, dtype=np.float64)
    s = bd.to_real_time_vec(data).statistics()
    # Reference Stats::empty min/max stay untouched at +-inf, index 0
    # (statistics.rs:185-196 + strict-compare add).
    assert s.min == np.inf and s.max == -np.inf
    assert s.min_index == 0 and s.max_index == 0
    assert np.isnan(s.sum)


def test_sharded_statistics_nan_matches_single(mesh):
    data = create_data(2, 1024)
    data[100] = np.nan
    data[900] = np.nan
    ref = bd.to_real_time_vec(data).statistics()
    xs = shard_time_axis(jnp.asarray(data), mesh)
    got = sharded_statistics(xs, mesh)
    assert np.isnan(got.sum) and np.isnan(ref.sum)
    assert got.min == ref.min and got.min_index == ref.min_index
    assert got.max == ref.max and got.max_index == ref.max_index


def test_sharded_statistics_all_nan(mesh):
    data = np.full(64, np.nan)
    got = sharded_statistics(shard_time_axis(jnp.asarray(data), mesh), mesh)
    assert got.min == np.inf and got.max == -np.inf
    assert got.min_index == 0 and got.max_index == 0


def test_sharded_statistics_complex_nan(mesh):
    data = create_complex_data(3, 512, dtype=np.complex64)
    data[77] = np.nan + 1j * np.nan
    ref = bd.to_complex_time_vec(data).statistics()
    got = sharded_statistics(shard_time_axis(jnp.asarray(data), mesh), mesh)
    assert got.min == ref.min and got.min_index == ref.min_index
    assert got.max == ref.max and got.max_index == ref.max_index


def test_sharded_statistics_tied_extrema_first_index(mesh):
    # The identical extremum appears on three different shards (1024/8 =
    # 128 per shard); both paths must report the FIRST occurrence.
    data = create_data(4, 1024)
    lo, hi = data.min() - 1.0, data.max() + 1.0
    for i in (200, 500, 900):
        data[i] = lo
    for i in (130, 640, 1000):
        data[i] = hi
    ref = bd.to_real_time_vec(data).statistics()
    got = sharded_statistics(shard_time_axis(jnp.asarray(data), mesh), mesh)
    assert ref.min_index == 200 and ref.max_index == 130
    assert got.min == ref.min and got.min_index == ref.min_index
    assert got.max == ref.max and got.max_index == ref.max_index


def test_tied_extrema_within_one_shard():
    data = np.array([3.0, 1.0, 5.0, 1.0, 5.0, 2.0])
    s = bd.to_real_time_vec(data).statistics()
    assert s.min_index == 1 and s.max_index == 2


# ----------------------------------------------------------------------
# Mesh-shape misuse must raise cleanly, not crash inside shard_map.
# ----------------------------------------------------------------------
def test_sharded_conv_non_divisible_raises(mesh):
    x = jnp.asarray(create_complex_data(5, 1002, dtype=np.complex64))
    h = jnp.asarray(create_complex_data(6, 7, dtype=np.complex64))
    with pytest.raises(ValueError, match="not divisible"):
        sharded_convolve_signal(x, h, mesh)


def test_sharded_statistics_non_divisible_raises(mesh):
    x = jnp.asarray(create_data(7, 1002))
    with pytest.raises(ValueError, match="not divisible"):
        sharded_statistics(x, mesh)


def test_sharded_conv_kernel_longer_than_shard_raises(mesh):
    # 8 devices, 512 per shard; a 600-tap (m_eff 600) kernel cannot halo.
    x = jnp.asarray(create_complex_data(8, 4096, dtype=np.complex64))
    h = jnp.asarray(create_complex_data(9, 600, dtype=np.complex64))
    with pytest.raises(ValueError, match="shard"):
        sharded_convolve_signal(x, h, mesh)


def test_sharded_conv_kernel_fills_whole_shard(mesh):
    # m_eff == shard length exactly: halos span a full neighbor shard.
    n, m = 1024, 128  # 1024/8 == 128 == m_eff
    x = create_complex_data(10, n, dtype=np.complex64)
    h = create_complex_data(11, m, dtype=np.complex64)
    expected = conv_ops.convolve_signal_fft(jnp.asarray(x), jnp.asarray(h),
                                            True)
    out = sharded_convolve_signal(shard_time_axis(jnp.asarray(x), mesh),
                                  jnp.asarray(h), mesh)
    scale = float(np.abs(np.asarray(expected)).max())
    assert_vector_eq(np.asarray(out), np.asarray(expected),
                     tol=1e-5 * max(scale, 1.0))


# ----------------------------------------------------------------------
# Gen erroneous propagation through every op family
# (vector_types/mod.rs:213-229: wrong-flavor ops set valid_len=0,
# delta=NaN instead of panicking).
# ----------------------------------------------------------------------
def _gen_real_time():
    return bd.to_gen_dsp_vec([1.0, 2.0, 3.0, 4.0], is_complex=False,
                             domain=DataDomain.TIME)


def _gen_real_freq():
    return bd.to_gen_dsp_vec([1.0, 2.0, 3.0, 4.0], is_complex=False,
                             domain=DataDomain.FREQUENCY)


def _gen_complex_time():
    return bd.to_gen_dsp_vec([1.0, 2.0, 3.0, 4.0], is_complex=True,
                             domain=DataDomain.TIME)


def _gen_complex_freq():
    return bd.to_gen_dsp_vec([1.0, 2.0, 3.0, 4.0], is_complex=True,
                             domain=DataDomain.FREQUENCY)


_WRONG_FLAVOR_OPS = [
    # (family, make_vector, op)
    ("complex_to_real", _gen_real_time, lambda v: v.magnitude()),
    ("complex_to_real", _gen_real_time, lambda v: v.phase()),
    ("complex_to_real", _gen_real_time, lambda v: v.to_real()),
    ("complex_to_real", _gen_real_time, lambda v: v.to_imag()),
    ("complex_ops", _gen_real_time, lambda v: v.conj()),
    ("complex_ops", _gen_real_time,
     lambda v: v.multiply_complex_exponential(1.0, 0.0)),
    ("real_to_complex", _gen_complex_time, lambda v: v.to_complex()),
    ("real_ops", _gen_complex_time, lambda v: v.abs()),
    ("time_to_freq", _gen_real_freq, lambda v: v.plain_fft()),
    ("time_to_freq", _gen_real_freq, lambda v: v.fft()),
    ("freq_to_time", _gen_complex_time, lambda v: v.plain_ifft()),
    ("freq_to_time", _gen_complex_time, lambda v: v.ifft()),
    ("freq_to_time", _gen_complex_time, lambda v: v.plain_sifft()),
    ("freq", _gen_complex_time, lambda v: v.mirror()),
    ("freq", _gen_real_time, lambda v: v.fft_shift()),
    ("convolution", _gen_complex_freq,
     lambda v: v.convolve_signal(bd.to_complex_time_vec(
         np.asarray([1.0 + 0j, 2.0 + 0j])))),
    ("correlation", _gen_complex_freq, lambda v: v.prepare_argument()),
    ("statistics", _gen_real_time, lambda v: v.offset(1 + 2j)),
]


@pytest.mark.parametrize("family,make,op", _WRONG_FLAVOR_OPS,
                         ids=[f"{f}-{i}" for i, (f, _, _)
                              in enumerate(_WRONG_FLAVOR_OPS)])
def test_gen_wrong_flavor_marks_erroneous(family, make, op):
    out = op(make())
    assert out.is_erroneous(), family
    assert len(out) == 0


@pytest.mark.parametrize("chain", [
    lambda v: v.sin(), lambda v: v.scale(2.0), lambda v: v.sqrt(),
    lambda v: v.reverse(), lambda v: v.diff(), lambda v: v.cum_sum(),
])
def test_erroneous_propagates_through_elementwise(chain):
    bad = _gen_real_time().conj()  # wrong flavor -> erroneous
    assert bad.is_erroneous()
    out = chain(bad)
    assert out.is_erroneous()
