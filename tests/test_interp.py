"""Interpolation goldens ported from reference
time_freq/interpolation.rs:636-1008 and real_interpolation.rs:181-238."""
import numpy as np
import pytest

import basic_dsp_tpu as bd
from tools import assert_vector_eq, multitone


def dirac_complex(n):
    t = np.zeros(n, dtype=complex)
    t[n // 2] = 1.0
    return bd.to_complex_time_vec(t)


def test_interpolatei_sinc():
    """interpolation.rs:653-678."""
    time = dirac_complex(6)
    out = time.interpolatei(bd.SincFunction(), 2).magnitude()
    expected = [0.16666667, 0.044658206, 0.16666667, 0.16666667, 0.16666667,
                0.6220085, 1.1666667, 0.6220085, 0.16666667, 0.16666667,
                0.16666667, 0.044658206]
    assert_vector_eq(out.array, expected, tol=1e-4)


def test_interpolatei_rc():
    """interpolation.rs:726-750."""
    time = dirac_complex(6)
    out = time.interpolatei(bd.RaisedCosineFunction(0.4), 2).magnitude()
    expected = [0.0, 0.038979173, 0.0, 0.15530863, 0.0, 0.6163295, 1.0,
                0.61632943, 0.0, 0.15530863, 0.0, 0.038979173]
    assert_vector_eq(out.array, expected, tol=1e-4)


def test_interpolate_sinc_even():
    """interpolation.rs:681-700."""
    time = dirac_complex(6)
    out = time.interpolate(bd.SincFunction(), 12, 0.0).to_real()
    expected = [0.00000, 0.04466, 0.00000, -0.16667, 0.00000, 0.62201,
                1.00000, 0.62201, 0.00000, -0.16667, 0.00000, 0.04466]
    assert_vector_eq(out.array, expected, tol=1e-4)


def test_interpolate_sinc_odd():
    """interpolation.rs:703-723."""
    time = np.zeros(7)
    time[3] = 1.0
    v = bd.to_real_time_vec(time).to_complex()
    out = v.interpolate(bd.SincFunction(), 14, 0.0).to_real()
    expected = [0.00000, 0.15856, 0.00000, -0.22913, 0.00000, 0.64199,
                1.00000, 0.64199, 0.00000, -0.22913, -0.00000, 0.15856,
                0.00000, -0.14286]
    assert_vector_eq(out.array, expected, tol=1e-4)


def test_interpolatef_by_integer_sinc_even():
    """interpolation.rs:753-773 (cross-algorithm tolerance 0.1)."""
    time = np.zeros(6)
    time[3] = 1.0
    v = bd.to_real_time_vec(time).to_complex()
    out = v.interpolatef(bd.SincFunction(), 2.0, 0.0, 6).to_real()
    expected = [0.00000, 0.04466, 0.00000, -0.16667, 0.00000, 0.62201,
                1.00000, 0.62201, 0.00000, -0.16667, 0.00000, 0.04466]
    assert_vector_eq(out.array, expected, tol=0.1)


def test_interpolatef_by_integer_sinc_odd():
    """interpolation.rs:776-796."""
    time = np.zeros(7)
    time[3] = 1.0
    v = bd.to_real_time_vec(time).to_complex()
    out = v.interpolatef(bd.SincFunction(), 2.0, 0.0, 7).to_real()
    expected = [0.00000, 0.15856, 0.00000, -0.22913, 0.00000, 0.64199,
                1.00000, 0.64199, 0.00000, -0.22913, -0.00000, 0.15856,
                0.00000, -0.14286]
    assert_vector_eq(out.array, expected, tol=0.1)


def test_interpolatef_fractional():
    """interpolation.rs:799-831 — vs Octave interpft golden."""
    time = np.zeros(6)
    time[3] = 1.0
    v = bd.to_real_time_vec(time).to_complex()
    out = v.interpolatef(bd.SincFunction(), 13.0 / 6.0, 0.0, 6).to_real()
    expected = [-2.7756e-17, 4.0780e-02, 2.0934e-02, -1.3806e-01,
                -1.1221e-01, 3.6167e-01, 9.1022e-01, 9.1022e-01, 3.6167e-01,
                -1.1221e-01, -1.3806e-01, 2.0934e-02, 4.0780e-02]
    assert_vector_eq(out.array, expected, tol=0.1)


def test_interpolate_fractional():
    """interpolation.rs:834-865."""
    time = np.zeros(6)
    time[3] = 1.0
    v = bd.to_real_time_vec(time).to_complex()
    out = v.interpolate(bd.SincFunction(), 13, 0.0).to_real()
    expected = [-2.7756e-17, 4.0780e-02, 2.0934e-02, -1.3806e-01,
                -1.1221e-01, 3.6167e-01, 9.1022e-01, 9.1022e-01, 3.6167e-01,
                -1.1221e-01, -1.3806e-01, 2.0934e-02, 4.0780e-02]
    assert_vector_eq(out.array, expected, tol=0.1)


def test_interpolate_fractional_real_data():
    """interpolation.rs:868-897 — same through the real-vector path."""
    time = np.zeros(6)
    time[3] = 1.0
    v = bd.to_real_time_vec(time)
    out = v.interpolate(bd.SincFunction(), 13, 0.0)
    assert not out.is_complex()
    expected = [-2.7756e-17, 4.0780e-02, 2.0934e-02, -1.3806e-01,
                -1.1221e-01, 3.6167e-01, 9.1022e-01, 9.1022e-01, 3.6167e-01,
                -1.1221e-01, -1.3806e-01, 2.0934e-02, 4.0780e-02]
    assert_vector_eq(out.array, expected, tol=0.1)


def test_interpolatef_delayed_sinc():
    """interpolation.rs:900-919."""
    time = dirac_complex(6)
    out = time.interpolatef(bd.SincFunction(), 2.0, 1.0, 6).magnitude()
    expected = [0.00000, 0.00000, 0.00000, 0.04466, 0.00000, 0.16667,
                0.00000, 0.62201, 1.00000, 0.62201, 0.00000, 0.16667]
    assert_vector_eq(out.array, expected, tol=0.1)


def test_interpolate_delayed_sinc():
    """interpolation.rs:922-948."""
    time = np.array([0.019827, 0.132513, 0.347660, 0.347660, 0.132513,
                     0.019827])
    v = bd.to_real_time_vec(time).to_complex()
    out = v.interpolate(bd.SincFunction(), 12, 1.0).magnitude()
    expected = [0.132513, 0.244227, 0.347660, 0.390094, 0.347660, 0.244227,
                0.132513, 0.054953, 0.019827, 0.011546, 0.019827, 0.054953]
    assert_vector_eq(out.array, expected, tol=0.1)


def test_interpolate_identity():
    """interpolation.rs:951-960."""
    time = np.array([0.019827, 0.132513, 0.347660, 0.347660, 0.132513,
                     0.019827])
    v = bd.to_real_time_vec(time)
    out = v.interpft(6)
    assert_vector_eq(out.array, time, tol=0.1)


def test_decimatei():
    """interpolation.rs:963-969."""
    v = bd.to_complex_time_vec(np.arange(12.0))
    out = v.decimatei(2, 1)
    assert_vector_eq(out.interleaved(), [2.0, 3.0, 6.0, 7.0, 10.0, 11.0],
                     tol=0)


def test_decimate_with_interpolate():
    """interpolation.rs:972-1007 — downsample via interpolate, vs Octave
    interpft golden."""
    time = np.array([-2.6551e-03, 1.5106e-04, 1.6104e-02, 5.9695e-02,
                     1.2705e-01, 1.9096e-01, 2.1739e-01, 1.9096e-01,
                     1.2705e-01, 5.9695e-02, 1.6104e-02, 1.5106e-04,
                     -2.6551e-03])
    v = bd.to_real_time_vec(time).to_complex()
    out = v.interpolate(bd.SincFunction(), 6, 0.0).magnitude()
    expected = [2.0600e-03, 2.1088e-02, 1.5072e-01, 2.1024e-01, 8.0868e-02,
                7.5036e-04]
    assert_vector_eq(out.array, expected, tol=1e-4)


def test_interpolate_delta_update():
    v = bd.to_real_time_vec(multitone(1, 100), delta=1.0)
    out = v.interpft(200)
    assert out.delta() == pytest.approx(0.5)


def test_interpolate_lin():
    """Linear interpolation of a straight line is exact."""
    data = np.arange(10.0)
    v = bd.to_real_time_vec(data)
    out = v.interpolate_lin(2.0, 0.0)
    assert out.points() == 19
    assert_vector_eq(out.array, np.arange(19.0) / 2.0, tol=1e-12)


def test_interpolate_hermite():
    """Hermite interpolation reproduces input samples exactly and is close
    to the true signal between samples (reference tolerance: 6e-2 over a
    sine, real_interpolation.rs:181-238)."""
    n = 64
    t = np.arange(n, dtype=float)
    data = np.sin(2 * np.pi * 0.04 * t)
    v = bd.to_real_time_vec(data)
    out = np.asarray(v.interpolate_hermite(2.0, 0.0).array)
    assert_vector_eq(out[::2], data, tol=1e-9)
    fine = np.sin(2 * np.pi * 0.04 * np.arange(out.shape[0]) / 2.0)
    assert_vector_eq(out, fine, tol=6e-2)


def test_interpolatef_vs_interpolatei_multitone():
    """tests/interpolation_test.rs-style cross-agreement on a smooth
    multitone signal (tolerance 0.1-0.2)."""
    data = multitone(7, 64)
    cv = bd.to_real_time_vec(data).to_complex()
    f = cv.interpolatef(bd.SincFunction(), 2.0, 0.0, 12)
    i = cv.interpolatei(bd.SincFunction(), 2)
    assert_vector_eq(np.asarray(f.to_real().array)[12:-12],
                     np.asarray(i.to_real().array)[12:-12], tol=0.2)


def test_upsample_downsample_round_trip():
    """tests/interpolation_test.rs:340-404 analog."""
    data = multitone(8, 100)
    v = bd.to_real_time_vec(data).to_complex()
    up = v.interpft(200)
    down = up.interpft(100)
    assert_vector_eq(down.to_real().array, data, tol=1e-6)


def test_interpolatef_integer_spectral_matches_gather():
    """The integer-factor spectral polyphase fast path must agree with the
    general gather path to numerical precision."""
    from basic_dsp_tpu.ops import interp_ops
    import jax.numpy as jnp
    for n, F, L, delay in [(40, 2, 5, 0.0), (33, 3, 7, 1.0), (64, 8, 8, 0.5)]:
        x = multitone(n, n) + 1j * multitone(n + 1, n)
        xj = jnp.asarray(x)
        fast = interp_ops._interpolatef_integer_spectral(
            xj, bd.SincFunction(), F, delay, L)
        slow = interp_ops._interpolatef_gather(
            xj, bd.SincFunction(), float(F), delay, L, F * n)
        assert_vector_eq(np.asarray(fast), np.asarray(slow), tol=1e-9,
                         msg=f"n={n} F={F} L={L}")


def test_interpolatef_rational_spectral_matches_gather():
    from basic_dsp_tpu.ops import interp_ops
    import jax.numpy as jnp
    for n, P, Q, L, delay in [(40, 3, 2, 5, 0.0), (64, 5, 4, 7, 1.0),
                              (48, 7, 3, 8, 0.5)]:
        x = multitone(n, n) + 1j * multitone(n + 1, n)
        xj = jnp.asarray(x)
        fast = interp_ops._interpolatef_rational_spectral(
            xj, bd.SincFunction(), P, Q, delay, L)
        slow = interp_ops._interpolatef_gather(
            xj, bd.SincFunction(), P / Q, delay, L, n * P // Q)
        # At indices where i*Q/P is an exact integer the gather path's
        # float floor may land one sample low; the rational path computes
        # the exact value, so those entries differ by a window edge tap.
        i = np.arange(n * P // Q)
        interior = (i * Q) % P != 0
        assert_vector_eq(np.asarray(fast)[interior],
                         np.asarray(slow)[interior], tol=1e-9,
                         msg=f"n={n} P={P} Q={Q}")
        assert_vector_eq(np.asarray(fast), np.asarray(slow), tol=0.2,
                         msg=f"n={n} P={P} Q={Q} (boundary)")


def test_interpolatef_1_5x_uses_rational_path():
    """1.5x (the slow_down_music factor) matches the gather semantics
    through the public API."""
    n = 64
    data = multitone(3, n) + 1j * multitone(4, n)
    v = bd.to_complex_time_vec(data)
    out = v.interpolatef(bd.SincFunction(), 1.5, 0.0, 10)
    assert out.points() == 96
    from basic_dsp_tpu.ops import interp_ops
    import jax.numpy as jnp
    slow = interp_ops._interpolatef_gather(
        jnp.asarray(data), bd.SincFunction(), 1.5, 0.0, 10, 96)
    assert_vector_eq(np.asarray(out.array), np.asarray(slow), tol=1e-9)


def test_hermite_spline_golden():
    """real_interpolation.rs:197-211 (interior points, tol 6e-2)."""
    v = bd.to_real_freq_vec([-1.0, -2.0, -1.0, 0.0, 1.0, 3.0, 4.0])
    out = np.asarray(v.interpolate_hermite(4.0, 0.0).array)
    expected = np.array([
        -1.0000, -1.4375, -1.7500, -1.9375, -2.0000, -1.8906, -1.6250,
        -1.2969, -1.0000, -0.7500, -0.5000, -0.2500, 0.0, 0.2344, 0.4583,
        0.7031, 1.0000, 1.4375, 2.0000, 2.5625, 3.0000, 3.3203, 3.6042,
        3.8359, 4.0])
    assert_vector_eq(out[4:-4], expected[4:-4], tol=6e-2)


def test_hermite_linear_increment_golden():
    """real_interpolation.rs:214-224 — straight line stays straight."""
    v = bd.to_real_freq_vec([-3.0, -2.0, -1.0, 0.0, 1.0, 2.0, 3.0])
    out = np.asarray(v.interpolate_hermite(3.0, 0.0).array)
    expected = [-3.0, -2.666, -2.333, -2.0, -1.666, -1.333, -1.0, -0.666,
                -0.333, 0.0, 0.333, 0.666, 1.0, 1.333, 1.666, 2.0, 2.333,
                2.666, 3.0]
    assert_vector_eq(out, expected, tol=5e-3)


def test_linear_golden():
    """real_interpolation.rs:227-239."""
    v = bd.to_real_freq_vec([-1.0, -2.0, -1.0, 0.0, 1.0, 3.0, 4.0])
    out = np.asarray(v.interpolate_lin(4.0, 0.0).array)
    expected = [-1.0000, -1.2500, -1.5000, -1.7500, -2.0000, -1.7500,
                -1.5000, -1.2500, -1.0000, -0.7500, -0.5000, -0.2500, 0.0,
                0.2500, 0.5000, 0.7500, 1.0000, 1.5000, 2.0000, 2.5000,
                3.0000, 3.2500, 3.5000, 3.7500, 4.0]
    assert_vector_eq(out, expected, tol=0.1)


def _lin_oracle(data, factor, delay):
    n = data.shape[-1]
    dest_len = int(round((n - 1) * factor)) + 1
    i = np.arange(dest_len - 1, dtype=np.float64)
    pos = i / factor + delay
    before_f = np.floor(pos)
    before = np.clip(before_f.astype(np.int64), 0, n - 2)
    y0, y1 = data[before], data[before + 1]
    body = y0 + (y1 - y0) * (pos - before_f)
    return np.concatenate([body, data[-1:]])


def _hermite_oracle(data, factor, delay):
    n = data.shape[-1]
    dest_len = int(round((n - 1) * factor)) + 1
    i = np.arange(dest_len, dtype=np.float64)
    pos = i / factor + delay
    before_f = np.floor(pos)
    before = before_f.astype(np.int64)
    t = pos - before_f

    def grab(idx):
        return data[np.clip(idx, 0, n - 1)]

    y1 = grab(before)
    y2_in = grab(before + 1)
    y0_in = grab(before - 1)
    y3_in = grab(before + 2)
    y0 = np.where(before <= 0, y1 - (y2_in - y1), y0_in)
    y2 = np.where(before >= n - 1, y1 + (y1 - y0), y2_in)
    y3 = np.where(before >= n - 2, y2 + (y2 - y1), y3_in)
    t2 = t * t
    a0 = -0.5 * y0 + 1.5 * y1 - 1.5 * y2 + 0.5 * y3
    a1 = y0 - 2.5 * y1 + 2.0 * y2 - 0.5 * y3
    a2 = -0.5 * y0 + 0.5 * y2
    return a0 * t * t2 + a1 * t2 + a2 * t + y1


@pytest.mark.parametrize("factor,delay", [
    (1.5, 0.0), (2.0, 0.25), (2.5, -0.75), (10.0, 0.0), (0.75, 0.5),
    (1.0, 0.5), (3.0, -1.25),
])
def test_interpolate_lin_rational_fast_path(factor, delay):
    """The banded-matmul fast path (large rational factors) must agree
    with the reference gather formula, including the patched clipped
    boundary samples."""
    rng = np.random.default_rng(7)
    data = rng.normal(size=4096)
    v = bd.to_real_time_vec(data)
    out = np.asarray(v.interpolate_lin(factor, delay).array)
    expected = _lin_oracle(data, factor, delay)
    assert out.shape == expected.shape
    assert_vector_eq(out, expected, tol=2e-5)


@pytest.mark.parametrize("factor,delay", [
    (1.5, 0.0), (2.0, 0.25), (2.5, -0.75), (10.0, 0.0), (0.75, 0.5),
    (1.0, 0.5), (3.0, -1.25),
])
def test_interpolate_hermite_rational_fast_path(factor, delay):
    rng = np.random.default_rng(8)
    data = rng.normal(size=4096)
    v = bd.to_real_time_vec(data)
    out = np.asarray(v.interpolate_hermite(factor, delay).array)
    expected = _hermite_oracle(data, factor, delay)
    assert out.shape == expected.shape
    assert_vector_eq(out, expected, tol=2e-5)


def test_interpolatef_direct_batch_dims():
    """The direct banded-matmul resampler must honor leading batch dims
    (matrix layer drives per-row interpolation through the same op)."""
    from basic_dsp_tpu.ops import interp_ops
    import jax.numpy as jnp
    rows = np.stack([multitone(3, 64), multitone(5, 64)])
    xj = jnp.asarray(rows)
    out = interp_ops.interpolatef(xj, bd.SincFunction(), 2.0, 0.0, 6, 1.0)
    assert out.shape == (2, 128)
    for r in range(2):
        ref = interp_ops.interpolatef(jnp.asarray(rows[r]),
                                      bd.SincFunction(), 2.0, 0.0, 6, 1.0)
        assert_vector_eq(np.asarray(out[r]), np.asarray(ref), tol=1e-9)


def test_polyphase_taps_staging_policy():
    """Real conv functions fold their tap build at compile time; complex-
    valued ones stay STAGED — ensure_compile_time_eval would run fun.calc
    eagerly and put a complex array on the device at construction
    time."""
    import jax
    import jax.numpy as jnp
    from basic_dsp_tpu.ops import interp_ops
    import basic_dsp_tpu.conv_types as ct

    seen = {}
    lut = ct.ComplexTimeLinearTableLookup.from_raw_parts(
        np.arange(9, dtype=np.complex64), 1.0, False)

    def probe(x):
        sinc_taps, offs = interp_ops.polyphase_taps(
            ct.SincFunction(), 3, 2, 0.0, 4, jnp.float32)
        lut_taps, _ = interp_ops.polyphase_taps(lut, 3, 2, 0.0, 4,
                                                jnp.float32)
        seen["offs"] = offs
        seen["sinc_traced"] = isinstance(sinc_taps, jax.core.Tracer)
        seen["lut_traced"] = isinstance(lut_taps, jax.core.Tracer)
        return x

    jax.jit(probe)(jnp.zeros(4))
    assert seen["offs"] == (0, 0, 1)
    assert not seen["sinc_traced"]
    assert seen["lut_traced"]


def test_interpolatef_complex_fun_matches_gather():
    """A complex-valued impulse response rides the staged per-phase
    correlation path and must agree with the exact gather formulation."""
    import jax.numpy as jnp
    from basic_dsp_tpu.ops import interp_ops
    import basic_dsp_tpu.conv_types as ct

    n, L, factor = 64, 4, 2
    t = np.arange(-L, L + 1) * 0.5
    table = (np.sinc(t) * np.exp(1j * 0.3 * t)).astype(np.complex64)
    fun = ct.ComplexTimeLinearTableLookup.from_raw_parts(table, 0.5, False)
    x = jnp.asarray(multitone(3, n).astype(np.complex64))
    out = interp_ops.interpolatef(x, fun, float(factor), 0.0, L, 1.0)
    oracle = interp_ops._interpolatef_gather(x, fun, float(factor), 0.0, L,
                                             factor * n)
    assert_vector_eq(np.asarray(out), np.asarray(oracle), tol=1e-5)


def test_interpolatef_audio_rate_rational_no_gather():
    """44.1 kHz -> 48 kHz (P/Q = 160/147, the flagship audio case) must
    ride the banded-matmul fast path — no slow-path warning, any length
    (no Q | n requirement) — and match an exact-rational f64 oracle
    (reference semantics interpolation.rs:92-131).  The
    f32 GATHER path itself drifts at large output indices (f32 ulp of
    the center position ~0.004 at i~40k), so the oracle is the exact
    integer phase decomposition evaluated in f64."""
    import warnings

    import jax
    import jax.numpy as jnp

    from basic_dsp_tpu.conv_types import SincFunction
    from basic_dsp_tpu.ops import interp_ops

    rng = np.random.default_rng(44)
    P, Q, L, delay = 160, 147, 10, 0.25
    factor = 160.0 / 147.0
    for n in (147 * 300 + 13, 2048):  # NOT divisible by 147
        x = rng.normal(size=n).astype(np.float32)
        interp_ops._gather_warned[0] = False
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            got = np.asarray(interp_ops.interpolatef(
                jnp.asarray(x), SincFunction(), factor, delay, L, 1.0))
        assert not any("gather path" in str(w.message) for w in rec)
        # f64 exact-rational oracle
        x64 = np.float64(x)
        new_points = got.shape[-1]
        i = np.arange(new_points)
        k, p = i // P, i % P
        base = k * Q + (p * Q) // P
        frac = ((p * Q) % P) / P
        t = np.arange(2 * L + 1)
        args = t[None, :] - L - frac[:, None] + delay
        w = np.asarray(jax.device_get(SincFunction().calc(
            jnp.asarray(np.float64(args)))))
        idx = (base[:, None] + t[None, :] - L) % n
        want = (x64[idx] * np.float64(w)).sum(-1)
        scale = np.abs(want).max()
        assert np.abs(got - want).max() / scale < 1e-5, n
    # complex input rides the same path
    z = (rng.normal(size=2048) + 1j * rng.normal(size=2048)
         ).astype(np.complex64)
    interp_ops._gather_warned[0] = False
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        gz = interp_ops.interpolatef(jnp.asarray(z), SincFunction(),
                                     factor, 0.0, L, 1.0)
    assert not any("gather path" in str(w.message) for w in rec)
    assert np.asarray(gz).shape[-1] == int(round(2 * 2048 * factor)) // 2


def test_fail_on_slow_path_raises(monkeypatch):
    """DspConfig.fail_on_slow_path: the gather fallback raises
    PerformanceError instead of warn-and-crawl."""
    import dataclasses
    from basic_dsp_tpu import config
    from basic_dsp_tpu.errors import PerformanceError
    from basic_dsp_tpu.conv_types import SincFunction

    import jax.numpy as jnp
    from basic_dsp_tpu.ops import interp_ops

    cfg = dataclasses.replace(config.default_config(),
                              fail_on_slow_path=True)
    monkeypatch.setattr(config, "_default_config", cfg)
    x = jnp.asarray(np.random.default_rng(0).normal(size=1 << 17)
                    .astype(np.float32))
    with pytest.raises(PerformanceError):
        interp_ops.interpolatef(x, SincFunction(), 3.14159, 0.0, 10, 1.0)
    # Small calls (below the warn threshold) stay allowed: the guard is
    # about production-size stalls, not semantics.
    out = interp_ops.interpolatef(x[:4096], SincFunction(), 3.14159,
                                  0.0, 10, 1.0)
    assert out.shape[-1] == round(4096 * 3.14159)


def test_rowblock_geometry_and_matrices():
    """The large-Q row-block formulation (round 5): geometry invariants
    and band-matrix correctness for a spread of (P, Q, L).  The window
    [s0, s0+W0) of output row j must cover every input index the direct
    semantics touch, and the per-view matrices must reassemble M0."""
    from basic_dsp_tpu.ops import interp_ops

    for P, Q, L in ((160, 147, 10), (147, 160, 10), (3, 147, 5),
                    (441, 480, 12), (65, 64, 3)):
        g = interp_ops._rowblock_geometry(P, Q, L)
        if g is None:
            continue
        W0, off, s0, splits = g
        maxoff = max((p * Q) // P for p in range(P))
        # coverage: window starts at ext lane j*Q + s0; must cover
        # [j*Q + off - L, j*Q + off + maxoff + L]
        assert s0 <= off - L
        assert s0 + W0 > off + maxoff + L
        # splits tile [s0, s0+W0) exactly
        covered = []
        for (r, lo, hi) in splits:
            covered.extend(range(r * Q + lo, r * Q + hi))
        assert covered == list(range(s0, s0 + W0)), (P, Q, L)
        # view matrices reassemble M0
        mats, _ = interp_ops._rowblock_matrices(
            np.ones((P, 2 * L + 1), np.float32), P, Q,
            tuple((p * Q) // P for p in range(P)), L, np.dtype(np.float32))
        M0 = np.zeros((W0, P), np.float32)
        cum = 0
        for (r, lo, hi), m in zip(splits, mats):
            M0[cum:cum + hi - lo] = m[lo:hi]
            cum += hi - lo
        pp, tt = np.meshgrid(np.arange(P), np.arange(2 * L + 1),
                             indexing="ij")
        ww = (pp * Q) // P + tt + (off - s0 - L)
        want = np.zeros((W0, P), np.float32)
        want[ww.ravel(), pp.ravel()] = 1.0
        np.testing.assert_array_equal(M0, want)


def test_rowblock_path_matches_generic_banded():
    """The rowblock dispatch (Q >= 64) must equal the generic banded
    windows formulation bit-for-bit at matmul precision, for several
    rationals and signal lengths (incl. n not divisible by Q)."""
    import jax.numpy as jnp

    from basic_dsp_tpu.ops import interp_ops

    rng = np.random.default_rng(5)
    for P, Q, L, n in ((160, 147, 10, 44113), (147, 160, 8, 32768),
                       (97, 96, 6, 20000)):
        x = jnp.asarray(rng.normal(size=n).astype(np.float32))
        taps, offs = interp_ops.polyphase_taps(
            _sinc_fun(), P, Q, 0.25, L, jnp.float32)
        out_len = int(round(n * P / Q)); out_len += out_len % 2
        got = interp_ops._interpolatef_rowblock(x, taps, P, Q, offs, L,
                                                out_len)
        M = interp_ops._direct_band_matrix(taps, P, Q, offs, L,
                                           np.dtype(np.float32), 2)
        nb = -(-out_len // (2 * P))
        need = nb * 2 * Q + M.shape[0]
        k = L % n
        pieces = ([x[n - k:]] if k else [])
        remaining = need - k
        while remaining > 0:
            take = min(remaining, n)
            pieces.append(x[:take]); remaining -= take
        ext = jnp.concatenate(pieces)
        want = interp_ops._direct_apply(ext, jnp.asarray(M), P, Q, nb,
                                        2)[:out_len]
        err = float(jnp.max(jnp.abs(got - want)))
        scale = float(jnp.max(jnp.abs(want)))
        assert err < 2e-6 * max(scale, 1), (P, Q, err)


def _sinc_fun():
    from basic_dsp_tpu.conv_types import SincFunction
    return SincFunction()
