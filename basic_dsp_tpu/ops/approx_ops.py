"""Fast-math transcendental approximations — the array realization of the
reference's SIMD ``*_approx`` family (simd_extensions/approximations.rs,
itself a port of the Cephes-style ``sse_mathfun`` polynomials).

The reference evaluates short range-reduced polynomials in SIMD registers
because libm calls cannot vectorize.  On an accelerator the analogous win
is instruction count: these evaluators compile to ~8-12 elementwise ops
versus the much longer exact lowerings, and carry the same documented
contract —
*faster, less accurate* (real_ops.rs:96-233: "less accurate", valid over a
restricted range).  Accuracy is ~1e-6 relative on the reference ranges
(matching the sse_mathfun grade), pinned by tests/test_elementary.py.

All functions are f32 polynomial evaluations regardless of input dtype
(the reference's approximations are likewise f32-register math even for
f64 vectors via the fallback, approx_fallback.rs).
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np

_LN2 = 0.6931471805599453
_LOG2E = 1.4426950408889634


def _poly(r, coeffs):
    acc = jnp.full_like(r, coeffs[0])
    for c in coeffs[1:]:
        acc = acc * r + c
    return acc


def ln_approx(x):
    """Range-reduced natural log: x = m * 2^e with m in [sqrt(1/2),
    sqrt(2)); ln x = e*ln2 + poly(m-1).  Cephes logf polynomial
    (sse_mathfun log_ps).  Valid for x > 0 like the reference (negative
    inputs produce garbage there too — approximations.rs doc)."""
    dtype = x.dtype
    xf = x.astype(jnp.float32)
    m, e = jnp.frexp(xf)                 # m in [0.5, 1)
    # Shift mantissa into [sqrt(0.5), sqrt(2)) for a symmetric range.
    shift = m < np.float32(0.7071067811865476)
    m = jnp.where(shift, m + m, m)
    e = jnp.where(shift, e - 1, e).astype(jnp.float32)
    t = m - 1.0
    # Full Horner incl. the t^3*p - 0.5 t^2 + t tail (cephes logf).
    p = _poly(t, (7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1,
                  -1.2420140846e-1, 1.4249322787e-1, -1.6668057665e-1,
                  2.0000714765e-1, -2.4999993993e-1, 3.3333331174e-1,
                  -0.5, 1.0, 0.0))
    return (p + e * np.float32(_LN2)).astype(dtype)


def exp_approx(x):
    """exp via 2^k * e^r with k = round(x/ln2) (sse_mathfun exp_ps).
    Clamped to the f32 exponent range like the reference."""
    dtype = x.dtype
    xf = jnp.clip(x.astype(jnp.float32), -87.3365, 88.3762)
    k = jnp.round(xf * np.float32(_LOG2E))
    r = xf - k * np.float32(0.693359375) - k * np.float32(-2.12194440e-4)
    p = _poly(r, (1.9875691500e-4, 1.3981999507e-3, 8.3334519073e-3,
                  4.1665795894e-2, 1.6666665459e-1, 5.0000001201e-1,
                  1.0, 1.0))
    return (p * jnp.exp2(k)).astype(dtype)


def _sincos_reduced(xf):
    """Quadrant reduction (sse_mathfun sin_ps/cos_ps): j = round(x*2/pi),
    r = x - j*pi/2 via extended-precision steps; returns (j mod 4, sin_r,
    cos_r polynomials)."""
    j = jnp.round(xf * np.float32(2.0 / np.pi))
    # Three-step Cody-Waite reduction; sse_mathfun's pi/4-scaled constants
    # doubled for the pi/2 quadrant step.
    r = xf + j * np.float32(-2 * 0.78515625)
    r = r + j * np.float32(-2 * 2.4187564849853515625e-4)
    r = r + j * np.float32(-2 * 3.77489497744594108e-8)
    r2 = r * r
    sin_p = _poly(r2, (-1.9515295891e-4, 8.3321608736e-3,
                       -1.6666654611e-1)) * r2 * r + r
    cos_p = _poly(r2, (2.443315711809948e-5, -1.388731625493765e-3,
                       4.166664568298827e-2)) * r2 * r2 \
        - 0.5 * r2 + 1.0
    q = jnp.mod(j, 4.0)
    return q, sin_p, cos_p


def sin_approx(x):
    dtype = x.dtype
    xf = x.astype(jnp.float32)
    q, s, c = _sincos_reduced(xf)
    out = jnp.where(q == 0, s,
                    jnp.where(q == 1, c,
                              jnp.where(q == 2, -s, -c)))
    return out.astype(dtype)


def cos_approx(x):
    dtype = x.dtype
    xf = x.astype(jnp.float32)
    q, s, c = _sincos_reduced(xf)
    out = jnp.where(q == 0, c,
                    jnp.where(q == 1, -s,
                              jnp.where(q == 2, -c, s)))
    return out.astype(dtype)


def log_approx(x, base: float):
    """log_base via ln_approx (reference log_approx composes the same
    way, real_ops.rs:154-170)."""
    return ln_approx(x) * np.float32(1.0 / np.log(base))


def expf_approx(x, base: float):
    """base^x = exp(x * ln base) (reference real_ops.rs:172-188)."""
    return exp_approx(x * np.float32(np.log(base)))


def powf_approx(x, exponent: float):
    """x^y = exp(y * ln x), valid for x > 0 (reference
    real_ops.rs:190-209: same composition, same restriction)."""
    return exp_approx(ln_approx(x) * np.float32(exponent))
