"""basic_dsp_tpu — a JAX DSP library.

A from-scratch JAX/XLA re-design with the capabilities of the Rust
crate ``basic_dsp`` (see SURVEY.md for the full blueprint): typed
real/complex vectors in time or frequency domain, elementwise math and
statistics, windowed FFT/IFFT (incl. symmetric real-signal variants),
centered circular FIR convolution with a blocked overlap-save fast path,
cross-correlation, fractional and FFT resampling, analytic convolution
kernels and windows, a multi-channel matrix layer, and mesh-sharded
multi-device execution with halo exchange.
"""
from .config import (DspConfig, default_config, enable_x64, make_mesh,
                     matmul_precision, set_default_config,
                     set_matmul_precision)
from .conv_types import (
    ComplexFrequencyLinearTableLookup,
    ComplexFrequencyResponse,
    ComplexImpulseResponse,
    ComplexTimeLinearTableLookup,
    RaisedCosineFunction,
    RealFrequencyLinearTableLookup,
    RealFrequencyResponse,
    RealImpulseResponse,
    RealTimeLinearTableLookup,
    SincFunction,
)
from .errors import DspError, ErrorReason
from .matrix import (
    ComplexFreqMatrix,
    ComplexTimeMatrix,
    DspMatrix,
    GenDspMatrix,
    RealFreqMatrix,
    RealTimeMatrix,
    from_rows,
    to_mat,
    to_complex_freq_mat,
    to_complex_time_mat,
    to_gen_dsp_mat,
    to_real_freq_mat,
    to_real_time_mat,
)
from .meta import DataDomain, NumberSpace
from .ops.stats_ops import (STATS_VEC_CAPACITY, Statistics, merge_stats,
                            merge_stats_cols)
from .vector import (
    ComplexFreqVector,
    ComplexTimeVector,
    DspVector,
    GenDspVector,
    RealFreqVector,
    RealTimeVector,
    interleave_to_complex_freq_vec,
    interleave_to_complex_time_vec,
    to_complex_freq_vec,
    to_complex_freq_vec_par,
    to_complex_time_vec,
    to_complex_time_vec_par,
    to_gen_dsp_vec,
    to_real_freq_vec,
    to_real_freq_vec_par,
    to_real_time_vec,
    to_real_time_vec_par,
)
from . import autotune
from . import io
from .windows import (
    BlackmanHarrisWindow,
    HammingWindow,
    RectangularWindow,
    TriangularWindow,
    WindowFunction,
)

__version__ = "0.1.0"
