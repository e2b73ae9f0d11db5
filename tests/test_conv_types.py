"""Analytic kernel goldens ported from reference conv_types.rs:582-703."""
import numpy as np

import basic_dsp_tpu as bd
from tools import assert_vector_eq

RC_035_GOLDEN = [
    0.0, 0.2171850639713355, 0.4840621929215732, 0.7430526238101408,
    0.9312114164253432, 1.0, 0.9312114164253432, 0.7430526238101408,
    0.4840621929215732, 0.2171850639713355,
]


def sweep(calc, n, step):
    j = np.arange(n) - n // 2
    return np.asarray(calc(j * step))


def test_raised_cosine():
    rc = bd.RaisedCosineFunction(0.35)
    assert_vector_eq(sweep(rc.calc, 10, 0.2), RC_035_GOLDEN, tol=1e-4)


def test_raised_cosine_pole():
    # |x| == 1/(2*rolloff) hits the removable singularity.
    rc = bd.RaisedCosineFunction(0.5)
    val = float(rc.calc(np.array(1.0)))
    arg = np.pi / 2 / 0.5
    assert abs(val - np.sin(arg) / arg * np.pi / 4) < 1e-6


def test_sinc():
    sinc = bd.SincFunction()
    expected = [0.1273, -0.0000, -0.2122, 0.0000, 0.6366, 1.0000, 0.6366,
                0.0000, -0.2122, -0.0000]
    assert_vector_eq(sweep(sinc.calc, 10, 0.5), expected, tol=1e-4)


def test_sinc_freq():
    sinc = bd.SincFunction()
    expected = [0.0, 0.0, 0.0, 1.0, 1.0, 1.0, 1.0, 1.0, 0.0, 0.0]
    assert_vector_eq(sweep(sinc.calc_freq, 10, 0.5), expected, tol=1e-4)


def test_rc_freq():
    rc = bd.RaisedCosineFunction(0.5)
    expected = [0.0, 0.0, 0.20610737385376332, 0.7938926261462365, 1.0, 1.0,
                1.0, 0.7938926261462365, 0.20610737385376332, 0.0]
    assert_vector_eq(sweep(rc.calc_freq, 10, 0.4), expected, tol=0.1)


def test_lookup_table_exact_bins():
    rc = bd.RaisedCosineFunction(0.35)
    table = bd.RealTimeLinearTableLookup.from_conv_function(rc, 0.2, 5)
    assert_vector_eq(sweep(table.calc, 10, 0.2), RC_035_GOLDEN, tol=1e-4)


def test_lookup_table_linear_interpolation():
    rc = bd.RaisedCosineFunction(0.35)
    table = bd.RealTimeLinearTableLookup.from_conv_function(rc, 0.4, 5)
    assert_vector_eq(sweep(table.calc, 10, 0.2), RC_035_GOLDEN, tol=0.1)


def test_lookup_to_complex():
    rc = bd.RaisedCosineFunction(0.35)
    table = bd.RealTimeLinearTableLookup.from_conv_function(rc, 0.4, 5)
    cplx = table.to_complex()
    mags = np.abs(sweep(cplx.calc, 10, 0.2))
    assert_vector_eq(mags, RC_035_GOLDEN, tol=0.1)


def test_lookup_fft():
    """Reference conv_types.rs:674-684."""
    rc = bd.RaisedCosineFunction(0.5)
    table = bd.RealTimeLinearTableLookup.from_conv_function(rc, 0.2, 5)
    freq = table.fft()
    assert abs(freq.delta - 2.2) < 1e-9
    expected = [0.0078, 0.0269, 0.0602, 0.1311, 2.7701, 5.6396, 2.7701,
                0.1311, 0.0602, 0.0269, 0.0078]
    assert_vector_eq(sweep(freq.calc_freq, 11, 2.2), expected, tol=0.1)


def test_lookup_fft_ifft_round_trip():
    rc = bd.RaisedCosineFunction(0.35)
    table = bd.RealTimeLinearTableLookup.from_conv_function(
        rc, 0.2, 5).to_complex()
    back = table.fft().ifft()
    assert_vector_eq(np.asarray(back.table), np.asarray(table.table), tol=1e-5)


def test_lookup_tables_stay_on_host():
    """LUT tables are HOST numpy through every construction-time
    transform: building complex kernels must never create an eager
    complex device array (construction stays on the host; CLAUDE.md
    "build static matrices in numpy")."""
    rc = bd.RaisedCosineFunction(0.35)
    t0 = bd.RealTimeLinearTableLookup.from_conv_function(rc, 0.2, 5)
    chain = [t0, t0.to_complex(), t0.fft(), t0.to_complex().fft(),
             t0.to_complex().fft().ifft(),
             t0.to_complex().fft().to_real(),
             bd.ComplexTimeLinearTableLookup.from_raw_parts(
                 np.arange(9, dtype=np.complex64), 1.0, False)]
    for lut in chain:
        assert isinstance(lut.table, np.ndarray), type(lut)
    # And a complex table still evaluates correctly through jit.
    import jax
    import jax.numpy as jnp
    lut = chain[1]
    pts = np.linspace(-0.8, 0.8, 9).astype(np.float32)
    got = jax.jit(lambda p: lut.calc(p))(jnp.asarray(pts))
    want = np.asarray(t0.calc(jnp.asarray(pts)))
    assert_vector_eq(np.asarray(got).real, want, tol=1e-6)
