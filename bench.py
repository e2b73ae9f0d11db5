"""Headline benchmark: Msamples/s of the flagship FIR + FFT chain.

The flagship (BASELINE.md): a 4M-sample complex64 signal, a 128-tap
raised-cosine FIR, a Hamming window and the shifted FFT magnitude spectrum,
through ``pipelines.fir_fft_chain`` (configuration built by
``bench_all.flagship``).  Timing is ``profiling.time_op``: compile and warm
up, then the median of reps that each end in ``block_until_ready``.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", "device",
"card"}.  ``vs_baseline`` is the compulsory-bytes floor share: the time the
chain's input read plus output write take at the card's published HBM peak
over the measured time.  It is a lower bound on the work, not a model of
the chain.  An unknown ``device_kind`` is an error.

Usage: ``python bench.py`` on a machine with a GPU.
"""
import json

import bench_all


def main():
    dev, card = bench_all.setup()
    rec = bench_all.measure(bench_all.flagship(bench_all.SIZES),
                            bench_all.SIZES, dev["kind"])
    print(json.dumps({"metric": "fir_fft_chain_throughput",
                      "value": rec["value"], "unit": "Msamples/s",
                      "vs_baseline": rec["floor_share"],
                      "measured_ms": rec["measured_ms"],
                      "device": dev, "card": card}))


if __name__ == "__main__":
    main()
