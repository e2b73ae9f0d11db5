"""FFT window functions.

Behavioral parity with reference window_functions.rs:14-183 (formulas and the
``window(n, len)`` contract: n ranges over ``0..points`` and windows must match
the reference's golden five-point tables to 1e-4).  Unlike the reference —
which evaluates the window per sample inside a thread fan-out with a
symmetric-pair optimization (threading.rs:552-612) — this library evaluates
the whole window as one fused vectorized expression; XLA fuses it into the
consumer (windowed FFT) so the window never round-trips through HBM.
"""
from __future__ import annotations

import jax.numpy as jnp


class WindowFunction:
    """Base window contract (reference window_functions.rs:14-24)."""

    is_symmetric: bool = True

    def _key(self):
        """Value identity: two instances with equal keys produce identical
        windows.  Jit caches (vector._jit_static -> _planar.call) key traced
        programs on the window object, so value-based equality lets freshly
        constructed instances reuse compiled programs instead of
        recompiling per instance."""
        return (type(self),)

    def __eq__(self, other):
        return (isinstance(other, WindowFunction)
                and self._key() == other._key())

    def __hash__(self):
        return hash(self._key())

    def window(self, n, length):
        """Evaluates the window at (array of) integer position(s) ``n``.

        ``length`` is ``vector.points()``; valid ``n`` range is
        ``0..length`` (reference contract).
        """
        raise NotImplementedError

    def sample(self, length: int, dtype=jnp.float32):
        """Returns the full window as a device array of ``length`` points."""
        n = jnp.arange(length, dtype=dtype)
        return self.window(n, jnp.asarray(length, dtype=dtype)).astype(dtype)


class TriangularWindow(WindowFunction):
    """Triangular window (reference window_functions.rs:27-43)."""

    def window(self, n, length):
        n = jnp.asarray(n)
        length = jnp.asarray(length, dtype=jnp.result_type(n, jnp.float32))
        n = n.astype(length.dtype)
        return 1.0 - jnp.abs((n - (length - 1.0) / 2.0) / (length / 2.0))


class HammingWindow(WindowFunction):
    """Generalized Hamming window (reference window_functions.rs:46-88).

    ``alpha = 0.54`` is the GNU-Octave default.
    """

    def __init__(self, alpha: float = 0.54):
        self.alpha = float(alpha)
        self.beta = 1.0 - self.alpha

    def _key(self):
        return (type(self), self.alpha)

    def window(self, n, length):
        n = jnp.asarray(n)
        length = jnp.asarray(length, dtype=jnp.result_type(n, jnp.float32))
        n = n.astype(length.dtype)
        return self.alpha - self.beta * jnp.cos(2.0 * jnp.pi * n / (length - 1.0))


class BlackmanHarrisWindow(WindowFunction):
    """4-term Blackman-Harris window (reference window_functions.rs:91-116)."""

    A0, A1, A2, A3 = 0.35875, 0.48829, 0.14128, 0.01168

    def window(self, n, length):
        n = jnp.asarray(n)
        length = jnp.asarray(length, dtype=jnp.result_type(n, jnp.float32))
        n = n.astype(length.dtype)
        x = jnp.pi * n / (length - 1.0)
        return (self.A0
                - self.A1 * jnp.cos(2.0 * x)
                + self.A2 * jnp.cos(4.0 * x)
                - self.A3 * jnp.cos(6.0 * x))


class RectangularWindow(WindowFunction):
    """Rectangular window (reference window_functions.rs:119-132)."""

    def window(self, n, length):
        n = jnp.asarray(n)
        return jnp.ones_like(n, dtype=jnp.result_type(n, jnp.float32))
