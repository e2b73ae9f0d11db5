"""Double-float (*_prec) accuracy contracts and slow-path/backend warnings.

The reference accumulates f32 data in compensated f64
(precise_stats.rs:120-124, 622-660); our device-side double-float
(TwoSum/TwoProd trees, stats_ops) must match numpy f64 oracles to the same
grade WITHOUT shipping the array to host."""
import warnings

import jax.numpy as jnp
import numpy as np
import pytest

import basic_dsp_tpu as bd
from basic_dsp_tpu.ops import interp_ops, stats_ops


def test_df_sum_adversarial_cancellation():
    # Large + tiny: naive f32 sum loses the tail entirely.
    x = np.zeros(4096, np.float32)
    x[0] = 1e8
    x[1:] = 1e-3
    v = bd.to_real_time_vec(x)
    exact = x.astype(np.float64).sum()
    naive = np.float32(x.sum(dtype=np.float32))
    assert abs(v.sum_prec() - exact) < 1e-4 * abs(exact) * 2 ** -24
    assert abs(v.sum_prec() - exact) < abs(naive - exact) or naive == exact


def test_df_dot_large_n():
    rng = np.random.default_rng(11)
    a = rng.normal(size=1 << 18).astype(np.float32)
    b = rng.normal(size=1 << 18).astype(np.float32)
    exact = float(np.dot(a.astype(np.float64), b.astype(np.float64)))
    va, vb = bd.to_real_time_vec(a), bd.to_real_time_vec(b)
    assert abs(va.dot_product_prec(vb) - exact) < 1e-6 * abs(exact) + 1e-8


def test_df_complex_sum_sq():
    rng = np.random.default_rng(12)
    c = (rng.normal(size=65536)
         + 1j * rng.normal(size=65536)).astype(np.complex64)
    v = bd.to_complex_time_vec(c)
    exact = (c.astype(np.complex128) ** 2).sum()
    assert abs(v.sum_sq_prec() - exact) < 1e-6 * abs(exact) + 1e-8


def test_interpolatef_gather_warning():
    interp_ops._gather_warned[0] = False
    x = np.zeros(1 << 17, np.float32)
    from basic_dsp_tpu.conv_types import SincFunction
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        interp_ops.interpolatef(x, SincFunction(), float(np.pi) / 2,
                                0.0, 5, 1.0)
    assert any("gather path" in str(w.message) for w in rec)
    # small inputs stay silent
    interp_ops._gather_warned[0] = False
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        interp_ops.interpolatef(np.zeros(256, np.float32), SincFunction(),
                                float(np.pi) / 2, 0.0, 5, 1.0)
    assert not any("gather path" in str(w.message) for w in rec)


def test_prec_reductions_survive_large_magnitudes():
    """|x| > ~1.8e19 overflows a naive f32 square to inf; the guarded
    power-of-two prescale (round-3 review finding) keeps sum_sq_prec /
    dot_product_prec / statistics_prec exact vs the f64 oracle."""
    x32 = np.array([3e20, 1.0, -2.5e19], np.float32)
    x = jnp.asarray(x32)
    want = float(np.sum(np.float64(x32) ** 2))
    got = stats_ops.sum_sq_prec(x)
    assert np.isfinite(got) and abs(got - want) / want < 1e-12
    got_d = stats_ops.dot_product_prec(x, x)
    assert abs(got_d - want) / want < 1e-12
    st = stats_ops.statistics_prec(x, False)
    assert np.isfinite(st.rms)
    z64 = np.array([3e20 + 2e20j, 1.0 + 0j], np.complex64)
    sq = stats_ops.sum_sq_prec(jnp.asarray(z64))
    want_z = np.sum(np.complex128(z64) ** 2)
    assert np.isfinite(sq.real) and abs(sq - want_z) / abs(want_z) < 1e-10


def test_prec_reductions_survive_accumulation_growth():
    """Round-3 advisor finding: a fixed per-element guard bounded only the
    element magnitude, so a LONG reduction still overflowed — e.g.
    sum_sq_prec(np.full(1<<20, 2e16)) -> NaN while the f64 oracle is
    ~4.2e38.  The guard now folds the reduction length in."""
    x32 = np.full(1 << 20, 2e16, np.float32)
    want = float(np.sum(np.float64(x32) ** 2))
    got = stats_ops.sum_sq_prec(jnp.asarray(x32))
    assert np.isfinite(got) and abs(got - want) / want < 1e-10
    x2 = np.full(256, 1.5e18, np.float32)
    want2 = float(np.sum(np.float64(x2) ** 2))
    got2 = stats_ops.sum_sq_prec(jnp.asarray(x2))
    assert np.isfinite(got2) and abs(got2 - want2) / want2 < 1e-10
    # plain sums too: 2^20 terms of ~2^120 magnitude
    x3 = np.full(1 << 20, 1e36, np.float32)
    want3 = float(np.sum(np.float64(x3)))
    got3 = stats_ops.sum_prec(jnp.asarray(x3))
    assert np.isfinite(got3) and abs(got3 - want3) / want3 < 1e-10
    d = stats_ops.dot_product_prec(jnp.asarray(x32), jnp.asarray(x32))
    assert np.isfinite(d) and abs(d - want) / want < 1e-10


def test_split_prec_single_program_matches_per_bucket_oracle():
    """statistics_split_prec must match per-bucket f64 oracles with n not
    divisible by length (the batched single-program path zero-pads)."""
    rng = np.random.default_rng(13)
    x = (rng.normal(size=1003) * 10.0 ** rng.integers(-3, 3, 1003)) \
        .astype(np.float32)
    out = stats_ops.statistics_split_prec(jnp.asarray(x), 5, False)
    for k in range(5):
        sub = np.float64(x[k::5])
        assert abs(out[k].sum - sub.sum()) < 1e-9 * max(abs(sub.sum()), 1)
        want_rms = np.sqrt(np.mean(sub ** 2))
        assert abs(out[k].rms - want_rms) < 1e-6 * want_rms
    z = (rng.normal(size=257) + 1j * rng.normal(size=257)) \
        .astype(np.complex64)
    outz = stats_ops.statistics_split_prec(jnp.asarray(z), 3, True)
    for k in range(3):
        sub = np.complex128(z[k::3])
        assert abs(outz[k].sum - sub.sum()) < 1e-6 * max(abs(sub.sum()), 1)


def test_setitem_int_index_single_program():
    """Integer-index writes share ONE compiled program (the index is a
    device argument) — round-3 advisor finding: static=(key,) compiled a
    new program per distinct index."""
    from basic_dsp_tpu import _planar
    v = bd.to_real_time_vec(np.arange(64, dtype=np.float32))
    v[0] = -1.0  # warm the program
    before = _planar._compiled.cache_info().currsize
    for i in (1, 2, 17, 40, 63, -2):
        v[i] = float(100 + i)
    assert _planar._compiled.cache_info().currsize == before
    got = v.to_numpy()
    for i in (1, 2, 17, 40, 63):
        assert got[i] == 100 + i
    assert got[62] == 98.0 and got[0] == -1.0
    # complex scalar writes share a program too
    c = bd.to_complex_time_vec(np.zeros(8, np.complex64))
    c[3] = 1 + 2j
    b2 = _planar._compiled.cache_info().currsize
    c[5] = 4 - 1j
    assert _planar._compiled.cache_info().currsize == b2
    gz = c.to_numpy()
    assert gz[3] == 1 + 2j and gz[5] == 4 - 1j
    with pytest.raises(IndexError):
        v[64] = 0.0
