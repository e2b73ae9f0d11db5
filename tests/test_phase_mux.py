"""phase_mux / toeplitz_conv_multi: the matmul interleave-decimate machinery
behind the interpolatef fast paths (reorg_ops.phase_mux,
conv_ops.toeplitz_conv_multi)."""
import numpy as np
import jax.numpy as jnp
import pytest

import basic_dsp_tpu as bd
from basic_dsp_tpu.ops import conv_ops, reorg_ops


def mux_ref(phases, Q, offs, out_len):
    P, n = phases.shape[-2], phases.shape[-1]
    out = np.zeros(phases.shape[:-2] + (out_len,), dtype=phases.dtype)
    for i in range(out_len):
        k, p = divmod(i, P)
        out[..., i] = phases[..., p, k * Q + offs[p]]
    return out


@pytest.mark.parametrize("P,Q,n", [(1, 2, 256), (3, 2, 300), (2, 1, 64),
                                   (4, 3, 384), (5, 4, 128), (1, 7, 252)])
def test_phase_mux_matches_reference(P, Q, n):
    rng = np.random.default_rng(P * 100 + Q)
    phases = rng.normal(size=(P, n)).astype(np.float32)
    offs = [(p * Q) // P for p in range(P)]
    out_len = (n // Q) * P
    got = np.asarray(reorg_ops.phase_mux(jnp.asarray(phases), Q,
                                         tuple(offs), out_len))
    np.testing.assert_array_equal(got, mux_ref(phases, Q, offs, out_len))


def test_phase_mux_complex_and_batched():
    rng = np.random.default_rng(7)
    phases = (rng.normal(size=(2, 3, 128))
              + 1j * rng.normal(size=(2, 3, 128))).astype(np.complex64)
    offs = (0, 0, 1)
    got = np.asarray(reorg_ops.phase_mux(jnp.asarray(phases), 2, offs, 192))
    for b in range(2):
        np.testing.assert_array_equal(got[b], mux_ref(phases[b], 2, offs, 192))


def test_phase_mux_gate_fallback():
    """P*P*Q > 256 routes through the bounded-memory einsum fallback."""
    P, Q, n = 17, 2, 34  # 17*17*2 = 578 > 256
    rng = np.random.default_rng(3)
    phases = rng.normal(size=(P, n)).astype(np.float32)
    offs = [(p * Q) // P for p in range(P)]
    out_len = (n // Q) * P
    got = np.asarray(reorg_ops.phase_mux(jnp.asarray(phases), Q,
                                         tuple(offs), out_len))
    np.testing.assert_array_equal(got, mux_ref(phases, Q, offs, out_len))


def test_phase_mux_nonmultiple_padding():
    """n not a multiple of 128*Q exercises the zero-pad block edge."""
    P, Q, n = 2, 2, 300  # span 256, needs padding to 512
    rng = np.random.default_rng(5)
    phases = rng.normal(size=(P, n)).astype(np.float32)
    got = np.asarray(reorg_ops.phase_mux(jnp.asarray(phases), Q, (0, 1),
                                         (n // Q) * P))
    np.testing.assert_array_equal(got, mux_ref(phases, Q, (0, 1),
                                               (n // Q) * P))


@pytest.mark.parametrize("n,m,P", [(300, 7, 3), (1000, 31, 2), (256, 129, 4)])
def test_toeplitz_conv_multi_matches_single(n, m, P):
    rng = np.random.default_rng(n + m)
    x = (rng.normal(size=n) + 1j * rng.normal(size=n)).astype(np.complex64)
    taps = rng.normal(size=(P, m)).astype(np.float32)
    multi = np.asarray(conv_ops.toeplitz_conv_multi(jnp.asarray(x),
                                                    jnp.asarray(taps)))
    for p in range(P):
        single = np.asarray(conv_ops.toeplitz_conv(jnp.asarray(x),
                                                   jnp.asarray(taps[p]),
                                                   True))
        np.testing.assert_allclose(multi[p], single, rtol=0, atol=5e-5)


def test_decimatei_zero_interleave_stay_exact():
    """decimatei / zero_interleave are pure picks and must be BIT-exact —
    they deliberately do NOT use phase_mux (whose one-hot matmuls leave
    ~3e-7 residue on an accelerator even at highest precision)."""
    rng = np.random.default_rng(11)
    x = (rng.normal(size=1000) + 1j * rng.normal(size=1000)).astype(np.complex64)
    v = bd.to_complex_time_vec(x)
    np.testing.assert_array_equal(v.decimatei(4, 2).to_numpy(), x[2::4])
    np.testing.assert_array_equal(v.decimatei(7, 3).to_numpy(), x[3::7])
    r = rng.normal(size=250).astype(np.float32)
    got = np.asarray(reorg_ops.zero_interleave(jnp.asarray(r), 3))
    want = np.zeros(750, dtype=np.float32)
    want[0::3] = r
    np.testing.assert_array_equal(got, want)


def test_fresh_kernel_instances_share_compiled_programs():
    """bd.SincFunction()/windows hash by value, so jit caches keyed on the
    kernel object (vector._jit_static -> _planar.call) hit across freshly
    constructed instances instead of recompiling per instance."""
    from basic_dsp_tpu import _planar
    rng = np.random.default_rng(21)
    x = (rng.normal(size=300) + 1j * rng.normal(size=300)).astype(np.complex64)
    v = bd.to_complex_time_vec(x)
    v.interpolatef(bd.SincFunction(), 1.5, 0.0, 8)
    before = _planar._compiled.cache_info()
    out2 = v.interpolatef(bd.SincFunction(), 1.5, 0.0, 8)  # fresh instance
    after = _planar._compiled.cache_info()
    assert after.misses == before.misses, "fresh SincFunction recompiled"
    assert out2.points() == 450
    assert bd.HammingWindow() == bd.HammingWindow()
    assert bd.HammingWindow(0.5) != bd.HammingWindow(0.54)
    assert bd.RaisedCosineFunction(0.35) == bd.RaisedCosineFunction(0.35)
    assert bd.RaisedCosineFunction(0.35) != bd.RaisedCosineFunction(0.25)
    assert bd.SincFunction() != bd.RaisedCosineFunction(0.35)


def test_matmul_precision_dial_invalidates_programs():
    """config.set_matmul_precision bumps the epoch keyed into _planar's jit
    cache, so the dial takes effect without stale programs (the
    analog of the reference's *_approx fast-math family)."""
    from basic_dsp_tpu import _planar, config
    rng = np.random.default_rng(31)
    x = (rng.normal(size=2048) + 1j * rng.normal(size=2048)).astype(np.complex64)
    h = (rng.normal(size=31)).astype(np.float32)
    start = config.matmul_precision()
    # Switch to a tier DIFFERENT from the starting one (the matrix runner
    # may have set BDSP_MATMUL_PRECISION=high as the initial dial).
    other = "high" if start != "high" else "default"
    try:
        v = bd.to_complex_time_vec(x)
        hv = bd.to_real_time_vec(h)
        base = v.convolve_signal(hv.to_complex()).to_numpy()
        before = _planar._compiled.cache_info()
        config.set_matmul_precision(other)
        relaxed = v.convolve_signal(hv.to_complex()).to_numpy()
        after = _planar._compiled.cache_info()
        assert after.misses > before.misses, "precision change must retrace"
        # CPU executes every precision tier with full f32 math, so results
        # stay equal here; the on-card difference is measured by
        # chip_smoke.py (phase accuracy).
        np.testing.assert_allclose(relaxed, base, rtol=0, atol=1e-4)
        with pytest.raises(ValueError):
            config.set_matmul_precision("fast")
    finally:
        config.set_matmul_precision(start)
