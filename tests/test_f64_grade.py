"""f64 flavors compute in f64 (vector_types/mod.rs:121-123): c128 FFT,
convolution on each dispatch path, interpolatef and statistics against
numpy float64 at 1e-9."""
import numpy as np
import pytest

import basic_dsp_tpu as bd
from basic_dsp_tpu import reference

pytestmark = pytest.mark.requires_x64


def _c128(n, seed):
    r = np.random.default_rng(seed)
    return r.normal(size=n) + 1j * r.normal(size=n)


@pytest.mark.parametrize("n", [256, 4096, 1 << 16])
def test_c128_plain_fft(n):
    z = _c128(n, n)
    got = bd.to_complex_time_vec(z).plain_fft().to_numpy()
    assert got.dtype == np.complex128
    assert reference.max_rel_err(got, np.fft.fft(z)) < 1e-9


@pytest.mark.parametrize("n,m", [
    (4096, 128),     # Toeplitz matmul path (n > 1000, m <= 202)
    (800, 31),       # whole-signal FFT path
    (20000, 400),    # blocked overlap-save path
])
def test_c128_convolve_signal(n, m):
    z = _c128(n, m)
    h = _c128(m, n)
    got = bd.to_complex_time_vec(z).convolve_signal(
        bd.to_complex_time_vec(h)).to_numpy()
    assert got.dtype == np.complex128
    want = reference.convolve_circular_centered(z, h)
    assert reference.max_rel_err(got, want) < 1e-9


@pytest.mark.parametrize("factor", [1.5, 2.0, 4 / 3])
def test_f64_interpolatef(factor):
    x = np.random.default_rng(5).normal(size=3000)
    got = bd.to_real_time_vec(x).interpolatef(bd.SincFunction(), factor,
                                              0.0, 10).to_numpy()
    assert got.dtype == np.float64
    want = reference.interpolatef(x, reference.sinc, factor, 0.0, 10)
    assert reference.max_rel_err(got, want) < 1e-9


@pytest.mark.parametrize("cplx", [False, True])
def test_f64_statistics(cplx):
    n = 1 << 16
    x = _c128(n, 7) if cplx else \
        np.random.default_rng(7).normal(size=n) * 10.0 + 3.0
    v = bd.to_complex_time_vec(x) if cplx else bd.to_real_time_vec(x)
    st = v.statistics()
    got = np.array([st.sum, st.average, st.rms], np.complex128)
    # rms squares with the complex product (statistics.rs:532-561)
    want = np.array([x.sum(), x.mean(), np.sqrt(np.mean(x * x))],
                    np.complex128)
    assert reference.max_rel_err(got, want) < 1e-9
