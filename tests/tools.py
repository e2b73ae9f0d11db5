"""Shared test fixtures, modeled on reference tests/tools/mod.rs:
seeded data generators, rich-diff assert helpers, and a parameterized
runner that exercises sizes on both the plain and the blocked/sharded code
paths (the reference's single-core vs multi-core analog)."""
import jax
import numpy as np

# In the f32-only matrix configuration (BDSP_TEST_X64=0):
#  * the data generators produce f32/c64 so numpy reference computations
#    see the same values the device sees (no input-downcast skew), and
#  * tolerance-based asserts scale to the reference's own f32 golden grade
#    (convolution.rs:638 uses 1e-4 on ~unit data; ours is +-10 with
#    products ~100, hence the 5e-3 floor).
X64 = bool(jax.config.jax_enable_x64)
TOL_SCALE = 1.0 if X64 else 500.0
TOL_FLOOR = 0.0 if X64 else 5e-3


def scaled_tol(tol):
    return max(tol * TOL_SCALE, TOL_FLOOR)


def assert_vector_eq(left, right, tol=1e-6, msg=""):
    tol = scaled_tol(tol)
    left = np.asarray(left)
    right = np.asarray(right)
    assert left.shape == right.shape, (
        f"{msg}: shape {left.shape} != {right.shape}")
    diff = np.abs(left - right)
    bad = diff > tol
    if bad.any():
        idx = int(np.argmax(bad))
        raise AssertionError(
            f"{msg}: {int(bad.sum())}/{left.size} elements differ by >{tol}; "
            f"first at {idx}: {left.flat[idx]} != {right.flat[idx]} "
            f"(max diff {diff.max()})")


def create_data(seed, length, dtype=None):
    dtype = dtype or (np.float64 if X64 else np.float32)
    rng = np.random.default_rng(seed)
    return rng.uniform(-10.0, 10.0, length).astype(dtype)


def create_complex_data(seed, points, dtype=None):
    dtype = dtype or (np.complex128 if X64 else np.complex64)
    rng = np.random.default_rng(seed)
    return (rng.uniform(-10.0, 10.0, points)
            + 1j * rng.uniform(-10.0, 10.0, points)).astype(dtype)


def multitone(seed, points, tones=4, dtype=None):
    dtype = dtype or (np.float64 if X64 else np.float32)
    """Band-limited multi-tone signal (reference tools/mod.rs:189-212) —
    smooth enough for interpolation cross-checks."""
    rng = np.random.default_rng(seed)
    t = np.arange(points, dtype=dtype)
    out = np.zeros(points, dtype=dtype)
    for _ in range(tones):
        freq = rng.uniform(0.001, 0.05)
        phase = rng.uniform(0, 2 * np.pi)
        amp = rng.uniform(0.1, 1.0)
        out += (amp * np.sin(2 * np.pi * freq * t + phase)).astype(dtype)
    return out


def interpolatef_oracle(x, fun, factor, delay, conv_len, delta=1.0):
    """The reference's scalar interpolatef loop (interpolation.rs:92-131,
    387-482), one output and one tap at a time in float64 — the loop
    version of ``basic_dsp_tpu.reference.interpolatef``."""
    n = len(x)
    delay = delay / delta
    L = min(conv_len, n // 2)
    is_c = np.iscomplexobj(x)
    new_len = int(round(n * (2 if is_c else 1) * factor))
    new_len += new_len % 2
    pts = new_len // 2 if is_c else new_len
    out = np.zeros(pts, dtype=np.complex128 if is_c else np.float64)
    for i in range(pts):
        center = i / factor
        r = np.floor(center)
        acc = 0.0
        for t in range(2 * L + 1):
            w = fun(t - L - (center - r) + delay)
            acc += x[int(r - L + t) % n] * w
        out[i] = acc
    return out
