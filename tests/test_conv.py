"""Convolution goldens and identities, ported from reference
time_freq/convolution.rs:612-909."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import basic_dsp_tpu as bd
from basic_dsp_tpu.ops import conv_ops
from tools import assert_vector_eq, create_complex_data


def test_shift_left_by_1_as_conv():
    """convolution.rs:819-842 — pins the centered-kernel alignment."""
    a = bd.to_real_time_vec(np.arange(10.0)).to_complex()
    b = bd.to_real_time_vec(
        [0.0, 0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 0.0, 0.0]).to_complex()
    out = a.convolve_signal(b).magnitude()
    assert_vector_eq(out.array, np.arange(10.0), tol=1e-4)


def test_shift_left_by_1_as_conv_shorter():
    """convolution.rs:832-842."""
    a = bd.to_real_time_vec(np.arange(10.0)).to_complex()
    b = bd.to_real_time_vec([0.0, 0.0, 1.0]).to_complex()
    out = a.convolve_signal(b).magnitude()
    assert_vector_eq(out.array,
                     [9.0, 0.0, 1.0, 2.0, 3.0, 4.0, 5.0, 6.0, 7.0, 8.0],
                     tol=1e-4)


def test_convolve_complex_vectors():
    """convolution.rs:738-775 — sinc taps vs golden magnitudes."""
    LEN = 11
    time = np.zeros(LEN, dtype=complex)
    time[LEN // 2] = 1.0
    sinc = bd.SincFunction()
    v = np.arange(LEN) - 5.0
    real = np.asarray(sinc.calc(v * 0.5))
    arg = bd.interleave_to_complex_time_vec(real, np.zeros(LEN))
    a = bd.to_complex_time_vec(time)
    out = a.convolve_signal(arg).magnitude()
    expected = [0.12732396, 0.000000027827534, 0.21220659, 0.000000027827534,
                0.63661975, 1.0, 0.63661975, 0.000000027827534, 0.21220659,
                0.000000027827534, 0.12732396]
    assert_vector_eq(out.array, expected, tol=1e-4)


def test_convolve_real_time_and_time():
    """convolution.rs:651-669 — analytic RC kernel on a real dirac."""
    data = np.zeros(10)
    data[5] = 1.0
    v = bd.to_real_time_vec(data)
    rc = bd.RaisedCosineFunction(0.35)
    out = v.convolve(rc, 0.2, 5)
    expected = [0.0, 0.2171850639713355, 0.4840621929215732,
                0.7430526238101408, 0.9312114164253432, 1.0,
                0.9312114164253432, 0.7430526238101408, 0.4840621929215732,
                0.2171850639713355]
    assert_vector_eq(out.array, expected, tol=1e-4)


def test_convolve_complex_time_and_time():
    """convolution.rs:671-702 — sinc on a complex dirac, ratio 0.5."""
    LEN = 11
    time = np.zeros(LEN, dtype=complex)
    time[LEN // 2] = 1.0  # data_mut(len) sets float element 11 == re of point 5
    v = bd.to_complex_time_vec(time)
    out = v.convolve(bd.SincFunction(), 0.5, LEN // 2).magnitude()
    expected = [0.12732396, 0.000000027827534, 0.21220659, 0.000000027827534,
                0.63661975, 1.0, 0.63661975, 0.000000027827534, 0.21220659,
                0.000000027827534, 0.12732396]
    assert_vector_eq(out.array, expected, tol=1e-4)


def test_invalid_length_parameter_no_panic():
    """convolution.rs:722-735 — huge conv_len is clamped, not an error."""
    LEN = 20
    v = bd.to_complex_time_vec(np.zeros(LEN, dtype=complex))
    out = v.convolve(bd.SincFunction(), 0.5, 10 * LEN)
    assert out.points() == LEN


def test_vector_conv_vs_freq_multiplication():
    """convolution.rs:802-816: conv == reverse(swap_halves(ifft(fft*fft)))."""
    a = bd.to_complex_time_vec(np.arange(10.0).astype(complex))
    b = bd.to_complex_time_vec(np.arange(15.0, 5.0, -1.0).astype(complex))
    conv = a.convolve_signal(b)
    mul = a.fft().mul(b.fft()).ifft().reverse().swap_halves()
    assert_vector_eq(mul.array, conv.array, tol=1e-4)


@pytest.mark.parametrize("n", [9, 10])
def test_conv_vs_freq_multiplication_real_data(n):
    """convolution.rs:844-882 (even and odd)."""
    a = bd.to_real_time_vec(np.arange(float(n))).to_complex()
    b = bd.to_real_time_vec(np.arange(15.0, 15.0 - n, -1.0)).to_complex()
    conv = a.convolve_signal(b).magnitude()
    mul = (a.fft().mul(b.fft()).ifft().magnitude()
           .reverse().swap_halves())
    assert_vector_eq(mul.array, conv.array, tol=1e-4)


def test_overlap_save_matches_direct():
    """convolution.rs:885-898 plus larger sizes: the blocked overlap-save
    pipeline must equal the whole-signal FFT path exactly."""
    for n, m, fft_len in [(100, 6, 32), (1000, 17, 64), (4096, 128, 1024),
                          (5000, 31, 0)]:
        x = create_complex_data(n, n)
        h = create_complex_data(m, m)
        direct = conv_ops.convolve_signal_fft(x, h, True)
        blocked = conv_ops.overlap_save(
            x, h, True, conv_ops.pick_fft_len(m, fft_len))
        assert_vector_eq(blocked, direct, tol=1e-8,
                         msg=f"n={n} m={m} fft_len={fft_len}")


def test_overlap_save_dispatch_threshold():
    """Long signals route through overlap_save and still agree."""
    n, m = 50000, 63
    x = create_complex_data(1, n)
    h = create_complex_data(2, m)
    a = bd.to_complex_time_vec(x)
    b = bd.to_complex_time_vec(h)
    out = a.convolve_signal(b)
    direct = conv_ops.convolve_signal_fft(x, h, True)
    assert_vector_eq(out.array, direct, tol=1e-7)


def test_kernel_longer_than_signal_errors():
    a = bd.to_complex_time_vec(create_complex_data(1, 5))
    b = bd.to_complex_time_vec(create_complex_data(2, 8))
    with pytest.raises(bd.DspError):
        a.convolve_signal(b)


def test_multiply_frequency_response_golden():
    """convolution.rs:632-648."""
    v = bd.to_complex_freq_vec(np.array([1.0] * 10))  # 5 complex points
    rc = bd.RaisedCosineFunction(1.0)
    out = v.multiply_frequency_response(rc, 2.0)
    expected = [0.0, 0.0, 1.0, 1.0, 2.0, 2.0, 1.0, 1.0, 0.0, 0.0]
    assert_vector_eq(out.interleaved(), expected, tol=1e-4)


def test_multiply_frequency_response_even_golden():
    """convolution.rs:641-648."""
    v = bd.to_complex_freq_vec(np.array([1.0] * 12))  # 6 complex points
    rc = bd.RaisedCosineFunction(1.0)
    out = v.multiply_frequency_response(rc, 2.0)
    expected = [0.0, 0.0, 0.5, 0.5, 1.5, 1.5, 2.0, 2.0, 1.5, 1.5, 0.5, 0.5]
    assert_vector_eq(out.interleaved(), expected, tol=1e-4)


def test_compare_conv_freq_mul():
    """convolution.rs:704-720: time-domain sinc conv vs freq-domain
    multiply (cross-algorithm tolerance 0.2)."""
    LEN = 11
    time = np.zeros(LEN, dtype=complex)
    time[LEN // 2] = 1.0
    t = bd.to_complex_time_vec(time)
    sinc = bd.SincFunction()
    freq = t.fft().multiply_frequency_response(sinc, 1.0 / 0.5)
    conv = t.convolve(sinc, 0.5, LEN).magnitude()
    ifft = freq.ifft().magnitude()
    assert_vector_eq(ifft.array, conv.array, tol=0.2)


def test_real_convolve_signal():
    """Real (non-complex) vectors go through the same path with real
    output."""
    x = np.arange(10.0)
    h = np.array([0.0, 0.0, 1.0])
    a = bd.to_real_time_vec(x)
    b = bd.to_real_time_vec(h)
    out = a.convolve_signal(b)
    assert not out.is_complex()
    assert_vector_eq(out.array,
                     [9.0, 0.0, 1.0, 2.0, 3.0, 4.0, 5.0, 6.0, 7.0, 8.0],
                     tol=1e-6)


def test_toeplitz_conv_matches_fft():
    """The Toeplitz-matmul direct path must equal the spectral path."""
    import jax.numpy as jnp
    for n, m in [(256, 3), (512, 64), (1024, 129), (1280, 202),
                 (1000, 17), (333, 31), (5000, 202)]:
        x = create_complex_data(n, n)
        h = create_complex_data(m, m)
        direct = conv_ops.convolve_signal_fft(jnp.asarray(x), jnp.asarray(h),
                                              True)
        toep = conv_ops.toeplitz_conv(jnp.asarray(x), jnp.asarray(h), True)
        assert_vector_eq(np.asarray(toep), np.asarray(direct), tol=1e-8,
                         msg=f"n={n} m={m}")
    # Real flavor.
    x = np.random.default_rng(0).normal(size=512)
    h = np.random.default_rng(1).normal(size=17)
    direct = conv_ops.convolve_signal_fft(jnp.asarray(x), jnp.asarray(h),
                                          False)
    toep = conv_ops.toeplitz_conv(jnp.asarray(x), jnp.asarray(h), False)
    assert_vector_eq(np.asarray(toep), np.asarray(direct), tol=1e-8)


def test_dispatch_respects_config():
    """DspConfig thresholds steer the conv dispatch (the MultiCoreSettings
    analog: per-call config overrides)."""
    n, m = 5000, 31
    x = create_complex_data(1, n)
    h = create_complex_data(2, m)
    a = bd.to_complex_time_vec(x)
    b = bd.to_complex_time_vec(h)
    default = a.convolve_signal(b)
    forced_blocked = a.convolve_signal(b, cfg=bd.DspConfig(
        overlap_save_min_len=1000, overlap_save_min_imp_len=4,
        overlap_save_len_ratio=2, direct_conv_max_imp_len=0,
        direct_conv_min_len=10**9))
    forced_fft = a.convolve_signal(b, cfg=bd.DspConfig(
        overlap_save_min_len=10**9, direct_conv_min_len=10**9))
    assert_vector_eq(forced_blocked.array, default.array, tol=1e-6)
    assert_vector_eq(forced_fft.array, default.array, tol=1e-6)


def test_convolve_signal_delta_mismatch():
    """Sample spacings differing by >10% must be rejected
    (convolution.rs:257-268)."""
    a = bd.to_complex_time_vec(create_complex_data(1, 100), delta=1.0)
    b = bd.to_complex_time_vec(create_complex_data(2, 5), delta=2.0)
    with pytest.raises(bd.DspError):
        a.convolve_signal(b)
    ok = bd.to_complex_time_vec(create_complex_data(2, 5), delta=1.05)
    a.convolve_signal(ok)  # within 10% — fine


def test_toeplitz_fold_policy():
    """Concrete REAL kernels fold their tap matrices at compile time (no
    staged gather in the jaxpr); concrete COMPLEX kernels stay staged —
    the eager fold would create an eager complex device array per
    construction, which the staged path avoids."""
    import jax
    import jax.numpy as jnp
    from basic_dsp_tpu.ops import conv_ops

    x = jnp.asarray(np.random.default_rng(3).normal(size=256)
                    .astype(np.float32))
    h_real = jnp.asarray(np.hamming(9).astype(np.float32))
    h_cplx = h_real.astype(jnp.complex64) * (1 + 0.5j)

    jp_real = jax.make_jaxpr(
        lambda v: conv_ops._toeplitz_body(v, h_real, "highest"))(x)
    jp_cplx = jax.make_jaxpr(
        lambda v: conv_ops._toeplitz_body(v.astype(jnp.complex64), h_cplx,
                                          "highest"))(x)
    assert "gather" not in str(jp_real)
    assert "gather" in str(jp_cplx)

    # And the staged complex path is still correct vs the spectral path.
    out = jax.jit(lambda v: conv_ops._toeplitz_body(
        v.astype(jnp.complex64), h_cplx, "highest"))(x)
    oracle = conv_ops.convolve_signal_fft(x.astype(jnp.complex64), h_cplx,
                                          True)
    np.testing.assert_allclose(np.asarray(out), np.asarray(oracle),
                               atol=1e-4)


def test_toeplitz_complex_signal_real_taps_folds_and_two_dots():
    """Complex signal + CONCRETE real taps (the flagship/facade FIR
    shape): the tap matrices fold at compile time (no staged gathers)
    and each band shift costs 2 plane dots, not 3 Karatsuba dots
    (round-3 review finding)."""
    rng = np.random.default_rng(3)
    x = jnp.asarray((rng.normal(size=4096) + 1j * rng.normal(size=4096))
                    .astype(np.complex64))
    h = jnp.asarray(np.hamming(64).astype(np.float32))

    def f(xv):
        return conv_ops._toeplitz_body(xv, h, "highest")

    txt = str(jax.make_jaxpr(f)(x))
    assert txt.count("gather") == 0
    assert txt.count("dot_general") == 4  # 2 shifts x 2 planes
    got = np.asarray(jax.jit(f)(x))
    want = np.asarray(conv_ops.convolve_signal_fft(
        x, h.astype(jnp.complex64), True))
    assert np.max(np.abs(got - want)) / np.max(np.abs(want)) < 1e-5


def test_convolve_signal_planar_matches_complex():
    """Planar-boundary conv entry == complex entry (toeplitz and FFT
    dispatch regions), real and complex taps."""
    import jax.numpy as jnp
    from basic_dsp_tpu.ops import conv_ops

    rng = np.random.default_rng(5)
    for n, m in [(4096, 33), (4096, 128), (2048, 700)]:
        xr = jnp.asarray(rng.normal(size=n).astype(np.float32))
        xi = jnp.asarray(rng.normal(size=n).astype(np.float32))
        for cplx_taps in (False, True):
            if cplx_taps:
                h = jnp.asarray((rng.normal(size=m) + 1j *
                                 rng.normal(size=m)).astype(np.complex64))
            else:
                h = jnp.asarray(rng.normal(size=m).astype(np.float32))
            want = np.asarray(conv_ops.convolve_signal(
                xr + 1j * xi, h if cplx_taps else h.astype(jnp.complex64),
                True))
            gr, gi = conv_ops.convolve_signal_planar(
                xr, xi, h if cplx_taps else h.astype(jnp.complex64))
            got = np.asarray(gr) + 1j * np.asarray(gi)
            np.testing.assert_allclose(got, want, atol=2e-4, rtol=2e-4)
