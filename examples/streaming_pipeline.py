"""Serving-style streaming pipeline (a capability beyond the
reference, which is a whole-buffer library):

    unbounded sample stream --chunks--> StreamingResampler (x3/2)
                                    --> StreamingFir (raised-cosine filter)
                                    --> per-chunk power log

Both stages carry their overlap state functionally (pure (chunk, state)
-> (out, state)), so the whole pipeline jit-compiles once and the
concatenated outputs equal the whole-buffer linear operators, delayed by
the stages' documented lookahead latencies.

The stream is real-valued; for complex IQ streams enter via the
library's complex or planar constructors instead.

Usage: python examples/streaming_pipeline.py [n_chunks]
"""
import sys

import numpy as np


def main(n_chunks: int = 8):
    import jax.numpy as jnp

    from basic_dsp_tpu.conv_types import RaisedCosineFunction, SincFunction
    from basic_dsp_tpu.streaming import StreamingFir, StreamingResampler

    S = 512                      # input chunk: divisible by 128*Q (Q=2)
    rng = np.random.default_rng(0)

    resampler = StreamingResampler(SincFunction(), 1.5, 0.0, 10)
    t = ((np.arange(64) - 32) * 0.25).astype(np.float32)
    taps = np.asarray(RaisedCosineFunction(0.35).calc(t)).astype(np.float32)
    fir = StreamingFir(jnp.asarray(taps / taps.sum()))

    rs_state = resampler.init_state(jnp.float32)
    fir_state = fir.init_state(jnp.float32)

    print(f"resampler latency {resampler.output_delay} out-samples; "
          f"fir latency {fir.m - fir.m // 2 - 1} samples")
    for c in range(n_chunks):
        chunk = jnp.asarray(rng.normal(size=S).astype(np.float32))
        up, rs_state = resampler.process(chunk, rs_state)
        filt, fir_state = fir.process(up, fir_state)
        power = float(jnp.mean(filt * filt))
        print(f"chunk {c}: in {S} -> resampled {up.shape[-1]} "
              f"-> filtered {filt.shape[-1]}, mean power {power:.4f}")


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 8)
