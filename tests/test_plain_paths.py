"""The plain XLA paths of the flagship spectrum, overlap-save, the
resampler and the channelizer against the numpy float64 definitions in
``basic_dsp_tpu.reference``, at the geometries the benchmark chains use
scaled down to CPU size."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

from basic_dsp_tpu import pipelines, reference
from basic_dsp_tpu.conv_types import SincFunction
from basic_dsp_tpu.ops import conv_ops, fourstep, interp_ops
from basic_dsp_tpu.parallel import channelizer
from tools import interpolatef_oracle


def _cplx(n, seed):
    r = np.random.default_rng(seed)
    return (r.normal(size=n) + 1j * r.normal(size=n)).astype(np.complex64)


# ---- overlap-save (conv_ops.overlap_save), fft_len 1024..16384 ----------

OS_GEOMETRIES = [
    (4096, 33, 1024),
    (4096, 128, 1024),
    (8192, 129, 2048),      # pad crosses a 128 boundary
    (5000, 63, 1024),       # n not a multiple of the block payload
    (4096, 257, 4096),
    (32768, 200, 8192),
    (65536, 384, 16384),
]


@pytest.mark.parametrize("complex_taps", [True, False])
@pytest.mark.parametrize("n,m,fft_len", OS_GEOMETRIES)
def test_overlap_save_matches_circular_convolution(n, m, fft_len,
                                                   complex_taps):
    x = _cplx(n, n)
    h = _cplx(m, m) if complex_taps else \
        np.random.default_rng(m).normal(size=m).astype(np.float32)
    got = np.asarray(conv_ops.overlap_save(jnp.asarray(x), jnp.asarray(h),
                                           True, fft_len))
    want = reference.convolve_circular_centered(x, h)
    assert reference.max_rel_err(got, want) < 2e-6


@pytest.mark.parametrize("n,m,fft_len", [(4096, 65, 1024),
                                         (16384, 300, 4096)])
def test_overlap_save_real_signal(n, m, fft_len):
    r = np.random.default_rng(n + m)
    x = r.normal(size=n).astype(np.float32)
    h = r.normal(size=m).astype(np.float32)
    got = np.asarray(conv_ops.overlap_save(jnp.asarray(x), jnp.asarray(h),
                                           False, fft_len))
    assert got.dtype == np.float32
    want = reference.convolve_circular_centered(x, h)
    assert reference.max_rel_err(got, want) < 2e-6


# ---- resampler: banded-matmul direct path and large-Q row-block path ----

@pytest.mark.parametrize("cplx", [False, True])
@pytest.mark.parametrize("P,Q,L", [
    (3, 2, 10),     # cfg3: x1.5
    (10, 1, 12),    # integer factor (cfg4 family)
    (2, 1, 5),
    (5, 4, 10),
])
def test_interpolatef_direct_matches_oracle(P, Q, L, cplx):
    n = 4096
    x = _cplx(n, P * 100 + Q) if cplx else \
        np.random.default_rng(P + Q).normal(size=n).astype(np.float32)
    got = np.asarray(interp_ops.interpolatef(jnp.asarray(x), SincFunction(),
                                             P / Q, 0.0, L, 1.0))
    want = reference.interpolatef(x, reference.sinc, P / Q, 0.0, L)
    assert reference.max_rel_err(got, want) < 2e-6


@pytest.mark.parametrize("cplx", [False, True])
@pytest.mark.parametrize("P,Q", [(160, 147), (147, 160)])
def test_interpolatef_rowblock_matches_oracle(P, Q, cplx):
    """44.1 <-> 48 kHz: large Q takes the row-block formulation."""
    L, n = 10, 1 << 16
    assert interp_ops._rowblock_geometry(P, Q, L) is not None
    x = _cplx(n, P) if cplx else \
        np.random.default_rng(Q).normal(size=n).astype(np.float32)
    want = reference.interpolatef(x, reference.sinc, P / Q, 0.0, L)
    # interpolatef itself only takes matmul paths for factors >= 1; the
    # direct resampler is exact for any P/Q.
    taps, offs = interp_ops.polyphase_taps(SincFunction(), P, Q, 0.0, L,
                                           jnp.float32)
    got = np.asarray(interp_ops._interpolatef_direct(
        jnp.asarray(x), taps, P, Q, offs, L, len(want)))
    assert reference.max_rel_err(got, want) < 2e-6


@pytest.mark.parametrize("factor,n,delay", [(1.5, 300, 0.0),
                                            (0.77, 300, 0.0),
                                            (4 / 3, 300, 0.25)])
def test_vectorized_oracle_matches_scalar_loop(factor, n, delay):
    x = _cplx(n, 3)
    np.testing.assert_allclose(
        reference.interpolatef(x, reference.sinc, factor, delay, 10),
        interpolatef_oracle(x, np.sinc, factor, delay, 10),
        rtol=0, atol=1e-12)


# ---- channelizer (XLA pipeline) ------------------------------------------

@pytest.mark.parametrize("C,S,taps", [(256, 512, 8), (512, 512, 8),
                                      (1024, 256, 8), (1024, 64, 4)])
def test_channelize_and_demod_matches_filterbank(C, S, taps):
    x = _cplx(C * S, C)
    proto = (np.hamming(C * taps) / C).astype(np.float32)
    got = np.asarray(channelizer.channelize_and_demod(
        jnp.asarray(x), jnp.asarray(proto), C))
    ang, amp = reference.channelize_and_demod(x, proto, C)
    assert got.shape == ang.shape
    assert reference.wrapped_angle_error(got, ang, amp) < 1e-5


@pytest.mark.parametrize("C,S", [(256, 64), (1024, 32), (128, 256)])
def test_polyphase_channelizer_matches_filterbank(C, S):
    x = _cplx(C * S, S)
    proto = (np.hamming(C * 8) / C).astype(np.float32)
    got = np.asarray(channelizer.polyphase_channelizer(
        jnp.asarray(x), jnp.asarray(proto), C))
    want = reference.polyphase_filterbank(x, proto, C).T
    assert reference.max_rel_err(got, want) < 2e-6


def test_sharded_channelizer_matches_filterbank():
    C, S, d = 256, 512, 2
    x = _cplx(C * S, 11)
    proto = (np.hamming(C * 8) / C).astype(np.float32)
    mesh = Mesh(np.array(jax.devices()[:d]), ("t",))
    got = np.asarray(channelizer.sharded_channelize_and_demod(
        jnp.asarray(x), jnp.asarray(proto), C, mesh))
    ang, amp = reference.channelize_and_demod(x, proto, C)
    assert reference.wrapped_angle_error(got, ang, amp) < 1e-5


# ---- spectrum: four-step, _shifted_mag, the flagship chain ---------------

SPECTRUM_GRID = [(8, 2048), (16, 4096), (4, 1024), (8, 32768), (8, 65536)]


@pytest.mark.parametrize("shift", [True, False])
@pytest.mark.parametrize("n1,n2", SPECTRUM_GRID)
def test_dif_spectrum_mag_matches_numpy(n1, n2, shift):
    x = _cplx(n1 * n2, n2)
    got = np.asarray(fourstep.dif_spectrum_mag(jnp.asarray(x), n1, shift))
    spec = np.fft.fft(x.astype(np.complex128))
    want = np.abs(np.fft.fftshift(spec) if shift else spec)
    assert reference.max_rel_err(got, want) < 2e-6


@pytest.mark.parametrize("n1,n2", SPECTRUM_GRID)
def test_shifted_mag_matches_numpy(n1, n2):
    x = _cplx(n1 * n2, n1)
    got = np.asarray(jax.jit(pipelines._shifted_mag)(jnp.asarray(x)))
    assert reference.max_rel_err(got, reference.shifted_spectrum_mag(x)) \
        < 2e-6


@pytest.mark.parametrize("complex_taps", [True, False])
@pytest.mark.parametrize("n,m", [(1 << 16, 128), (1 << 18, 64),
                                 (1 << 16, 300)])   # 300: overlap-save FIR
def test_fir_fft_chain_matches_numpy(n, m, complex_taps):
    x = _cplx(n, m)
    r = np.random.default_rng(n + m)
    h = (r.normal(size=m) + 1j * r.normal(size=m)).astype(np.complex64) \
        if complex_taps else r.normal(size=m).astype(np.float32)
    h = h / np.abs(h).sum()
    w = np.hamming(n).astype(np.float32)
    got = np.asarray(pipelines.fir_fft_chain(jnp.asarray(x), jnp.asarray(h),
                                             jnp.asarray(w)))
    want = reference.shifted_spectrum_mag(
        reference.convolve_circular_centered(x, h) * w)
    assert reference.max_rel_err(got, want) < 5e-6
