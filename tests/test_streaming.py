"""Streaming FIR: chunked processing equals the whole-buffer linear
convolution; chains are differentiable (a bonus beyond the
reference)."""
import jax
import pytest
import jax.numpy as jnp
import numpy as np

import basic_dsp_tpu as bd
from basic_dsp_tpu import streaming
from basic_dsp_tpu.ops import conv_ops
from tools import assert_vector_eq, create_complex_data


def test_streaming_matches_whole_buffer():
    n, m, chunk = 4096, 33, 256
    x = create_complex_data(1, n, dtype=np.complex64)
    h = create_complex_data(2, m, dtype=np.complex64)
    fir = streaming.StreamingFir(jnp.asarray(h))
    out = np.asarray(streaming.stream_chunks(fir, jnp.asarray(x), chunk))
    # Whole-buffer linear convolution, causal part (lin[0:n]).
    lin = np.convolve(x, np.asarray(h))
    assert_vector_eq(out, lin[:n], tol=1e-3)


def test_streaming_state_carries():
    m = 9
    h = np.zeros(m, dtype=np.complex64)
    h[-1] = 1.0  # pure delay of m-1 samples
    fir = streaming.StreamingFir(jnp.asarray(h))
    state = fir.init_state(jnp.complex64)
    c1 = jnp.asarray(np.arange(16, dtype=np.complex64))
    c2 = jnp.asarray(np.arange(16, 32, dtype=np.complex64))
    o1, state = fir.process(c1, state)
    o2, state = fir.process(c2, state)
    got = np.concatenate([np.asarray(o1), np.asarray(o2)]).real
    expected = np.concatenate([np.zeros(m - 1), np.arange(32 - (m - 1))])
    assert_vector_eq(got, expected, tol=1e-4)


def test_streaming_one_tap_kernel():
    """m=1 regression: the tail must stay empty, not grow to the chunk."""
    fir = streaming.StreamingFir(jnp.asarray([2.0 + 0j]))
    state = fir.init_state(jnp.complex64)
    assert state.tail.shape == (0,)
    c = jnp.asarray(np.arange(8, dtype=np.complex64))
    out, state = fir.process(c, state)
    assert state.tail.shape == (0,)
    assert_vector_eq(np.asarray(out), 2.0 * np.arange(8), tol=1e-6)
    # and through the scan harness (carry structure must be stable)
    x = create_complex_data(3, 64, dtype=np.complex64)
    got = np.asarray(streaming.stream_chunks(fir, jnp.asarray(x), 16))
    assert_vector_eq(got, 2.0 * x, tol=1e-5)


def test_streaming_real_dtype_stays_real():
    x = np.random.default_rng(0).normal(size=512).astype(np.float32)
    h = np.hamming(17).astype(np.float32)
    fir = streaming.StreamingFir(jnp.asarray(h))
    out = streaming.stream_chunks(fir, jnp.asarray(x), 128)
    assert out.dtype == jnp.float32
    lin = np.convolve(x, h)
    assert_vector_eq(np.asarray(out), lin[:512].astype(np.float32), tol=1e-3)


def test_streaming_nondivisible_tail():
    """A chunk_size that doesn't divide n must still produce every sample."""
    n, m, chunk = 1000, 21, 256  # 1000 = 3*256 + 232
    x = create_complex_data(5, n, dtype=np.complex64)
    h = create_complex_data(6, m, dtype=np.complex64)
    fir = streaming.StreamingFir(jnp.asarray(h))
    out = np.asarray(streaming.stream_chunks(fir, jnp.asarray(x), chunk))
    assert out.shape == (n,)
    lin = np.convolve(x, h)
    assert_vector_eq(out, lin[:n], tol=1e-3)


def test_streaming_chunk_size_sweep():
    """Chunked output is chunk-size invariant, incl. long-kernel regime
    (m > chunk) where the whole-extent FFT path engages."""
    n, m = 768, 129
    x = create_complex_data(7, n, dtype=np.complex64)
    h = create_complex_data(8, m, dtype=np.complex64)
    fir = streaming.StreamingFir(jnp.asarray(h))
    lin = np.convolve(x, h)[:n]
    for chunk in (64, 96, 256, 768):
        out = np.asarray(streaming.stream_chunks(fir, jnp.asarray(x), chunk))
        assert_vector_eq(out, lin, tol=1e-3)


def test_streaming_no_recompile_across_instances():
    """Equal-shape taps share one compiled step (taps are traced, not
    baked): a second instance must not add jit cache entries."""
    h1 = create_complex_data(1, 33, dtype=np.complex64)
    h2 = create_complex_data(2, 33, dtype=np.complex64)
    f1 = streaming.StreamingFir(jnp.asarray(h1))
    x = jnp.asarray(create_complex_data(3, 256, dtype=np.complex64))
    f1.process(x, f1.init_state(jnp.complex64))
    before = streaming._fir_step._cache_size()
    f2 = streaming.StreamingFir(jnp.asarray(h2))
    f2.process(x, f2.init_state(jnp.complex64))
    assert streaming._fir_step._cache_size() == before


def test_dsp_chain_is_differentiable():
    """jax.grad flows through vector ops (pytree + pure functions) — a
    capability the reference cannot offer."""
    data = np.linspace(0.1, 1.0, 64)

    def loss(scale):
        v = bd.to_real_time_vec(jnp.asarray(data))
        # Reductions that return Python scalars (.sum()) are host-side by
        # design; differentiable code reduces on the array.
        return jnp.sum(v.scale(scale).sin().array)

    g = jax.grad(loss)(1.0)
    expected = float(np.sum(data * np.cos(data)))
    assert abs(float(g) - expected) < 1e-6


def _lin_resample_oracle(x, factor, conv_len):
    """Zero-padded linear resample (f64): out[i] = sum_t xpad[K*Q +
    offs[p] + t - L] * sinc(t - L - fracs[p]), i = K*P + p."""
    from fractions import Fraction
    frac = Fraction(float(factor)).limit_denominator(64)
    P, Q = frac.numerator, frac.denominator
    L = conv_len
    n = len(x)
    p = np.arange(P)
    fracs = ((p * Q) % P) / P
    offs = (p * Q) // P
    s = np.arange(-L, L + 1, dtype=np.float64)
    taps = np.sinc(s[None, :] - fracs[:, None])
    xpad = np.concatenate([x, np.zeros(2 * L + Q + 1, x.dtype)])
    m = n * P // Q
    out = np.zeros(m, dtype=np.result_type(x.dtype, np.float64))
    for i in range(m):
        K, ph = divmod(i, P)
        idx = K * Q + offs[ph] + np.arange(2 * L + 1) - L
        valid = idx >= 0
        out[i] = np.sum(xpad[idx[valid]] * taps[ph][valid])
    return out


@pytest.mark.parametrize("factor,cplx", [(1.5, True), (2.0, False)])
def test_streaming_resampler_matches_linear_resample(factor, cplx):
    """Concatenated streaming outputs == whole-buffer zero-padded linear
    resample, delayed by resampler.output_delay samples."""
    from basic_dsp_tpu.streaming import StreamingResampler
    rng = np.random.default_rng(5)
    n, S = 2048, 512
    if cplx:
        x = (rng.normal(size=n) + 1j * rng.normal(size=n)).astype(np.complex64)
    else:
        x = rng.normal(size=n).astype(np.float32)
    r = StreamingResampler(bd.SincFunction(), factor, 0.0, 10)
    st = r.init_state(x.dtype)
    outs = []
    for c in range(n // S):
        out, st = r.process(jnp.asarray(x[c * S:(c + 1) * S]), st)
        outs.append(np.asarray(out))
    got = np.concatenate(outs)
    want = _lin_resample_oracle(x.astype(np.complex128 if cplx
                                         else np.float64), factor, 10)
    D = r.output_delay
    m = len(got) - D
    assert m > 0
    np.testing.assert_allclose(got[D:], want[:m], atol=2e-5 * max(
        1.0, np.abs(want).max()))
    # jit-cache sharing: a second equal-geometry instance must not
    # recompile (value-agnostic M argument).
    r2 = StreamingResampler(bd.SincFunction(), factor, 0.0, 10)
    out2, _ = r2.process(jnp.asarray(x[:S]), r2.init_state(x.dtype))
    np.testing.assert_allclose(np.asarray(out2), got[:len(out2)], rtol=1e-6)
