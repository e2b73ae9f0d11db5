"""Matrix layer: batched ops agree with per-row vector ops; MIMO
convolution matches the sum-over-rows definition
(matrix/src/time_freq.rs:439-520)."""
import numpy as np
import pytest

import basic_dsp_tpu as bd
from tools import assert_vector_eq, create_complex_data, create_data


def test_matrix_roundtrip_rows():
    rows = [bd.to_real_time_vec(create_data(i, 16)) for i in range(3)]
    mat = bd.from_rows(rows)
    assert mat.col_len() == 3 and mat.row_len() == 16
    back = mat.rows()
    for r, b in zip(rows, back):
        assert isinstance(b, bd.RealTimeVector)
        assert_vector_eq(b.array, r.array, tol=0)


def test_matrix_elementwise_matches_rows():
    rows = [bd.to_real_time_vec(np.abs(create_data(i, 32)) + 1.0)
            for i in range(4)]
    mat = bd.from_rows(rows)
    out = mat.sin().scale(2.0).offset(1.0)
    for i, r in enumerate(rows):
        expected = r.sin().scale(2.0).offset(1.0)
        assert_vector_eq(out.rows()[i].array, expected.array, tol=1e-12)


def test_matrix_fft_matches_rows():
    rows = [bd.to_complex_time_vec(create_complex_data(i, 64))
            for i in range(2)]
    mat = bd.from_rows(rows)
    freq = mat.fft()
    assert isinstance(freq, bd.ComplexFreqMatrix)
    for i, r in enumerate(rows):
        assert_vector_eq(freq.rows()[i].array, r.fft().array, tol=1e-9)
    back = freq.ifft()
    for i, r in enumerate(rows):
        assert_vector_eq(back.rows()[i].array, r.array, tol=1e-9)


def test_matrix_convolve_signal_matches_rows():
    rows = [bd.to_complex_time_vec(create_complex_data(i, 100))
            for i in range(3)]
    imp = bd.to_complex_time_vec(create_complex_data(99, 7))
    mat = bd.from_rows(rows)
    out = mat.convolve_signal(imp)
    for i, r in enumerate(rows):
        assert_vector_eq(out.rows()[i].array, r.convolve_signal(imp).array,
                         tol=1e-9)


def test_matrix_statistics_per_row():
    rows = [bd.to_real_time_vec(create_data(i, 50)) for i in range(3)]
    mat = bd.from_rows(rows)
    stats = mat.statistics()
    assert len(stats) == 3
    for s, r in zip(stats, rows):
        rs = r.statistics()
        assert abs(s.sum - rs.sum) < 1e-9
        assert s.max_index == rs.max_index
    sums = mat.sum()
    for s, r in zip(sums, rows):
        assert abs(s - r.sum()) < 1e-9


def test_mimo_convolution():
    """out[c] = sum_r rows[r] conv imp[c][r] — crosstalk-style 2x2 mix."""
    n = 64
    x0 = create_complex_data(0, n)
    x1 = create_complex_data(1, n)
    atten = create_complex_data(10, 5)
    cross = create_complex_data(11, 5) * 0.1
    mat = bd.from_rows([bd.to_complex_time_vec(x0),
                        bd.to_complex_time_vec(x1)])
    imp = np.stack([np.stack([atten, cross]), np.stack([cross, atten])])
    out = mat.convolve_mat(imp)
    v0 = bd.to_complex_time_vec(x0)
    v1 = bd.to_complex_time_vec(x1)
    k_at = bd.to_complex_time_vec(atten)
    k_cr = bd.to_complex_time_vec(cross)
    exp0 = v0.convolve_signal(k_at).add(v1.convolve_signal(k_cr))
    exp1 = v0.convolve_signal(k_cr).add(v1.convolve_signal(k_at))
    assert_vector_eq(out.rows()[0].array, exp0.array, tol=1e-8)
    assert_vector_eq(out.rows()[1].array, exp1.array, tol=1e-8)


def test_matrix_magnitude_flavor():
    mat = bd.to_complex_time_mat(create_complex_data(5, 32).reshape(2, 16))
    mag = mat.magnitude()
    assert isinstance(mag, bd.RealTimeMatrix)
    assert mag.col_len() == 2


def test_matrix_interpolatef():
    rows = [bd.to_complex_time_vec(create_complex_data(i, 40))
            for i in range(2)]
    mat = bd.from_rows(rows)
    out = mat.interpolatef(bd.SincFunction(), 2.0, 0.0, 8)
    for i, r in enumerate(rows):
        expected = r.interpolatef(bd.SincFunction(), 2.0, 0.0, 8)
        assert_vector_eq(out.rows()[i].array, expected.array, tol=1e-9)


def test_matrix_channel_sharded():
    """Channel-sharded matrix ops agree with unsharded (the 'TP' analog for
    the MIMO layer — channels sharded over the mesh)."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P
    mesh = bd.make_mesh()
    data = create_complex_data(3, 8 * 256).reshape(8, 256)
    mat = bd.to_complex_time_mat(data)
    sharded_data = jax.device_put(
        jnp_asarray(data), NamedSharding(mesh, P("dsp", None)))
    mat_sharded = bd.to_complex_time_mat(sharded_data)
    out = mat.fft().magnitude()
    out_sharded = mat_sharded.fft().magnitude()
    assert_vector_eq(np.asarray(out_sharded.array), np.asarray(out.array),
                     tol=1e-9)


def jnp_asarray(x):
    import jax.numpy as jnp
    return jnp.asarray(x)


def test_matrix_toeplitz_path():
    """Matrix conv through the direct (Toeplitz) dispatch path (n > 1000)."""
    data = create_complex_data(9, 3 * 1500).reshape(3, 1500)
    mat = bd.to_complex_time_mat(data)
    imp = bd.to_complex_time_vec(create_complex_data(10, 31))
    out = mat.convolve_signal(imp)
    for i in range(3):
        row = bd.to_complex_time_vec(data[i])
        assert_vector_eq(out.rows()[i].array,
                         row.convolve_signal(imp).array, tol=1e-9)


def test_matrix_batched_reductions_1024_rows():
    """Row-wise reductions must be ONE device program, not C
    Python-loop dispatches — exercised at the advertised 1024-channel scale
    and checked against numpy f64 oracles."""
    rng = np.random.default_rng(7)
    m = rng.normal(size=(1024, 256)).astype(np.float32)
    ref = m.astype(np.float64)
    mat = bd.to_real_time_mat(m)

    stats = mat.statistics()
    assert len(stats) == 1024
    for i in (0, 511, 1023):
        assert abs(stats[i].sum - m[i].sum()) < 1e-3
        assert stats[i].min_index == m[i].argmin()
        assert stats[i].max_index == m[i].argmax()

    prec = mat.statistics_prec()
    for i in (0, 1023):
        assert abs(prec[i].sum - ref[i].sum()) < 1e-9
        assert abs(prec[i].rms - np.sqrt((ref[i] ** 2).mean())) < 1e-9

    sp = mat.sum_prec()
    ssq = mat.sum_sq_prec()
    assert max(abs(a - b) for a, b in zip(sp, ref.sum(axis=1))) < 1e-9
    assert max(abs(a - b)
               for a, b in zip(ssq, (ref ** 2).sum(axis=1))) < 1e-7

    other = bd.to_real_time_mat(m[:, ::-1].copy())
    dots = mat.dot_product_prec(other)
    dref = (ref * ref[:, ::-1]).sum(axis=1)
    assert max(abs(a - b) for a, b in zip(dots, dref)) < 1e-7


def test_matrix_statistics_split_batched():
    rng = np.random.default_rng(3)
    m = rng.normal(size=(5, 97)).astype(np.float32)
    mat = bd.to_real_time_mat(m)
    split = mat.statistics_split(4)
    assert len(split) == 5 and len(split[0]) == 4
    for i in range(5):
        for k in range(4):
            sub = m[i, k::4]
            assert split[i][k].count == sub.size
            assert abs(split[i][k].sum - sub.sum()) < 1e-4
            assert split[i][k].max_index == sub.argmax()
    splitp = mat.statistics_split_prec(3)
    for k in range(3):
        sub = m[2, k::3].astype(np.float64)
        assert abs(splitp[2][k].sum - sub.sum()) < 1e-9


def test_matrix_complex_batched_statistics():
    rng = np.random.default_rng(9)
    cm = (rng.normal(size=(6, 128))
          + 1j * rng.normal(size=(6, 128))).astype(np.complex64)
    mat = bd.to_complex_time_mat(cm)
    stats = mat.statistics()
    norms = np.abs(cm)
    for i in range(6):
        assert abs(stats[i].sum - cm[i].sum()) < 1e-4
        assert stats[i].min_index == norms[i].argmin()
    prec = mat.statistics_prec()
    c128 = cm.astype(np.complex128)
    for i in range(6):
        assert abs(prec[i].sum - c128[i].sum()) < 1e-9
        assert abs(prec[i].rms
                   - (c128[i] ** 2).mean() ** 0.5) < 1e-9


def test_matrix_statistics_split_longer_than_rows():
    """length > row length: the trailing interleave buckets are EMPTY
    Statistics (reference Stats::empty), not a crash (round-3 review
    finding: the batched path lacked the nk==0 guard)."""
    import numpy as np
    import basic_dsp_tpu as bd

    m = bd.from_rows([bd.to_real_time_vec(np.arange(3.0)),
                      bd.to_real_time_vec(np.arange(3.0) + 1)])
    rows = m.statistics_split(5)
    assert len(rows) == 2 and len(rows[0]) == 5
    assert rows[0][4].count == 0
    assert rows[0][0].count == 1
