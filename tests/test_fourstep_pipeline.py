"""Four-step matmul FFT path (ops/fourstep.py): exact agreement with
jnp.fft/numpy across factorizations, shift folding, and the flagship
chain wiring (pipelines.fir_fft_chain)."""
import jax.numpy as jnp
import numpy as np
import pytest

from basic_dsp_tpu.ops import conv_ops, fourstep
from basic_dsp_tpu import pipelines
from tools import create_complex_data, scaled_tol


@pytest.mark.parametrize("n,n1", [(1 << 12, 0), (1 << 14, 128),
                                  (1 << 14, 64), (3 * (1 << 12), 0),
                                  (1 << 16, 256)])
def test_dif_fft_matches_numpy(n, n1):
    x = create_complex_data(n, n, dtype=np.complex64)
    got = np.asarray(fourstep.dif_fft(jnp.asarray(x), n1))
    exp = np.fft.fft(x)
    assert np.max(np.abs(got - exp)) / np.abs(exp).max() < scaled_tol(2e-6)


@pytest.mark.parametrize("variant", [fourstep.dif_spectrum_mag,
                                     fourstep.dit_spectrum_mag])
@pytest.mark.parametrize("n", [1 << 12, 1 << 14])
def test_spectrum_mag_matches_numpy(variant, n):
    x = create_complex_data(n + 1, n, dtype=np.complex64)
    got = np.asarray(variant(jnp.asarray(x)))
    exp = np.abs(np.fft.fftshift(np.fft.fft(x)))
    assert got.shape == exp.shape
    assert np.max(np.abs(got - exp)) / exp.max() < scaled_tol(2e-6)


@pytest.mark.parametrize("variant", [fourstep.dif_spectrum_mag,
                                     fourstep.dit_spectrum_mag])
def test_spectrum_mag_no_shift(variant):
    n = 1 << 12
    x = create_complex_data(7, n, dtype=np.complex64)
    got = np.asarray(variant(jnp.asarray(x), shift=False))
    exp = np.abs(np.fft.fft(x))
    assert np.max(np.abs(got - exp)) / exp.max() < scaled_tol(2e-6)


def test_fir_fft_chain_uses_fourstep_and_matches_reference():
    n, m = 1 << 14, 64
    x = create_complex_data(3, n, dtype=np.complex64)
    h = create_complex_data(4, m, dtype=np.complex64)
    w = np.hamming(n).astype(np.float32)
    got = np.asarray(pipelines.fir_fft_chain(jnp.asarray(x), jnp.asarray(h),
                                             jnp.asarray(w)))
    filt = np.asarray(conv_ops.convolve_signal_fft(jnp.asarray(x),
                                                   jnp.asarray(h), True))
    exp = np.abs(np.fft.fftshift(np.fft.fft(filt * w)))
    assert np.max(np.abs(got - exp)) / exp.max() < scaled_tol(1e-5)


def test_fir_fft_chain_odd_length_fallback():
    """Non-factorable lengths still work (whole-signal FFT fallback)."""
    n, m = 4095, 33
    x = create_complex_data(5, n, dtype=np.complex64)
    h = create_complex_data(6, m, dtype=np.complex64)
    w = np.hamming(n).astype(np.float32)
    got = np.asarray(pipelines.fir_fft_chain(jnp.asarray(x), jnp.asarray(h),
                                             jnp.asarray(w)))
    filt = np.asarray(conv_ops.convolve_signal_fft(jnp.asarray(x),
                                                   jnp.asarray(h), True))
    exp = np.abs(np.fft.fftshift(np.fft.fft(filt * w)))
    assert np.max(np.abs(got - exp)) / exp.max() < scaled_tol(1e-5)


def test_modulation_chain_planar_matches_complex_path():
    """pipelines.modulation_chain_planar == interpolatef on the complex
    vector, exactly (real taps resample the planes independently;
    reference examples/modulation.rs:14-41)."""
    from basic_dsp_tpu.ops import interp_ops
    from basic_dsp_tpu.conv_types import RaisedCosineFunction

    rng = np.random.default_rng(12)
    n = 4096
    sr = jnp.asarray(rng.choice([-0.5, 0.5], n).astype(np.float32))
    si = jnp.asarray(rng.choice([-0.5, 0.5], n).astype(np.float32))
    re, im = pipelines.modulation_chain_planar(sr, si)
    shaped = interp_ops.interpolatef(
        sr + 1j * si, RaisedCosineFunction(0.35), 10.0, 0.0, 10, 1.0)
    np.testing.assert_array_equal(np.asarray(re), np.real(shaped))
    np.testing.assert_array_equal(np.asarray(im), np.imag(shaped))
