/* C ABI for the basic_dsp_tpu framework.
 *
 * The analog of the reference interop crate
 * (basic_dsp_interop facade32.rs/facade64.rs): an opaque vector handle, a
 * {result_code, vector} return struct, and per-precision entry points.
 * Error codes follow reference interop/src/lib.rs:107-141:
 *   0 ok; -1 unspecified/erroneous; 1..14 = ErrorReason enum order.
 *
 * Call bdsp_init() once before anything else (it attaches to or boots a
 * CPython runtime hosting the JAX/XLA compute path).  All handles must be
 * released with delete_vector32/64.
 */
#ifndef BASIC_DSP_TPU_H
#define BASIC_DSP_TPU_H

#include <stddef.h>
#include <stdint.h>

#ifdef __cplusplus
extern "C" {
#endif

typedef struct DspVec DspVec; /* opaque vector handle */

typedef struct {
  int32_t result_code;
  DspVec *vector;
} VectorResult;

typedef struct {
  int32_t result_code;
  double result;
} ScalarResult;

typedef struct {
  int32_t result_code;
  double real;
  double imag;
} ComplexResult;

typedef struct {
  double sum;
  uint64_t count;
  double average;
  double rms;
  double min;
  uint64_t min_index;
  double max;
  uint64_t max_index;
} RealStatistics;

typedef struct {
  double sum_re, sum_im;
  uint64_t count;
  double average_re, average_im;
  double rms_re, rms_im;
  double min_re, min_im;
  uint64_t min_index;
  double max_re, max_im;
  uint64_t max_index;
} ComplexStatistics;

/* User callbacks for map_inplace / map_aggregate (the analog of the
 * reference's ForeignRealConvolutionFunction-style fn pointers,
 * interop/src/lib.rs:244-377). */
typedef double (*bdsp_map_real_fn)(double value, size_t index,
                                   const void *user_data);
/* Custom window: fn(data, n, points) -> value (ForeignWindowFunction). */
typedef double (*bdsp_window_fn)(const void *user_data, size_t n,
                                 size_t points);
/* Custom impulse/frequency response: fn(data, x) -> value. */
typedef double (*bdsp_conv_fn)(const void *user_data, double x);

/* Complex value passed across the C boundary (always double precision,
 * like ScalarResult/ComplexResult). */
typedef struct {
  double re;
  double im;
} BdspComplex;
/* Complex map callback: fn(re, im, index, data) -> mapped complex
 * (reference map_inplace_complex32, facade32.rs:603-609). */
typedef BdspComplex (*bdsp_map_complex_fn)(double re, double im, size_t index,
                                           const void *user_data);
/* Complex aggregation callback: fn(a, b, data) -> combined
 * (the typed analog of the reference's void* aggregate,
 * facade32.rs:634-652). */
typedef BdspComplex (*bdsp_agg_complex_fn)(BdspComplex a, BdspComplex b,
                                           const void *user_data);
/* Complex-valued impulse/frequency response: fn(data, x) -> (re, im)
 * (reference ForeignComplexConvolutionFunction, lib.rs:313-377). */
typedef BdspComplex (*bdsp_conv_complex_fn)(const void *user_data, double x);

/* Runtime ------------------------------------------------------------- */
int32_t bdsp_init(void);
const char *bdsp_last_error(void);

/* WAV IO (native, no Python involved) --------------------------------- */
float *bdsp_read_wav(const char *path, int32_t *channels, int32_t *rate,
                     int64_t *frames);
int32_t bdsp_write_wav(const char *path, const float *data, int32_t channels,
                       int32_t rate, int64_t frames, int32_t bits);
void bdsp_free(void *p);

/* Per-precision surface.  X = 32 or 64. ------------------------------- */
#define BDSP_DECLARE(X, REAL)                                                  \
  DspVec *new##X(int32_t is_complex, int32_t domain, REAL init_value,          \
                 size_t length, REAL delta);                                   \
  DspVec *from_data##X(int32_t is_complex, int32_t domain, REAL delta,         \
                       const REAL *data, size_t length);                       \
  void delete_vector##X(DspVec *vector);                                       \
  DspVec *clone##X(DspVec *vector);                                            \
  REAL get_value##X(DspVec *vector, size_t index);                             \
  VectorResult set_value##X(DspVec *vector, size_t index, REAL value);         \
  int32_t is_complex##X(DspVec *vector);                                       \
  int32_t get_domain##X(DspVec *vector); /* 0 time, 1 freq */                  \
  REAL get_delta##X(DspVec *vector);                                           \
  size_t get_points##X(DspVec *vector);                                        \
  size_t get_len##X(DspVec *vector);                                           \
  int32_t is_erroneous##X(DspVec *vector);                                     \
  int32_t get_data##X(DspVec *vector, REAL *out, size_t capacity);             \
  /* elementary */                                                             \
  VectorResult add##X(DspVec *a, DspVec *b);                                   \
  VectorResult sub##X(DspVec *a, DspVec *b);                                   \
  VectorResult mul##X(DspVec *a, DspVec *b);                                   \
  VectorResult div##X(DspVec *a, DspVec *b);                                   \
  VectorResult add_smaller##X(DspVec *a, DspVec *b);                           \
  VectorResult sub_smaller##X(DspVec *a, DspVec *b);                           \
  VectorResult mul_smaller##X(DspVec *a, DspVec *b);                           \
  VectorResult div_smaller##X(DspVec *a, DspVec *b);                           \
  VectorResult real_scale##X(DspVec *v, REAL value);                           \
  VectorResult real_offset##X(DspVec *v, REAL value);                          \
  VectorResult complex_scale##X(DspVec *v, REAL re, REAL im);                  \
  VectorResult complex_offset##X(DspVec *v, REAL re, REAL im);                 \
  /* trig & powers */                                                          \
  VectorResult sin##X(DspVec *v);                                              \
  VectorResult cos##X(DspVec *v);                                              \
  VectorResult tan##X(DspVec *v);                                              \
  VectorResult asin##X(DspVec *v);                                             \
  VectorResult acos##X(DspVec *v);                                             \
  VectorResult atan##X(DspVec *v);                                             \
  VectorResult sinh##X(DspVec *v);                                             \
  VectorResult cosh##X(DspVec *v);                                             \
  VectorResult tanh##X(DspVec *v);                                             \
  VectorResult asinh##X(DspVec *v);                                            \
  VectorResult acosh##X(DspVec *v);                                            \
  VectorResult atanh##X(DspVec *v);                                            \
  VectorResult sqrt##X(DspVec *v);                                             \
  VectorResult square##X(DspVec *v);                                           \
  VectorResult ln##X(DspVec *v);                                               \
  VectorResult exp##X(DspVec *v);                                              \
  VectorResult root##X(DspVec *v, REAL degree);                                \
  VectorResult real_powf##X(DspVec *v, REAL exponent);                              \
  VectorResult log##X(DspVec *v, REAL base);                                   \
  VectorResult real_expf##X(DspVec *v, REAL base);                                  \
  /* real ops */                                                               \
  VectorResult abs##X(DspVec *v);                                              \
  VectorResult wrap##X(DspVec *v, REAL divisor);                               \
  VectorResult unwrap##X(DspVec *v, REAL divisor);                             \
  /* complex ops */                                                            \
  VectorResult to_complex##X(DspVec *v);                                       \
  VectorResult magnitude##X(DspVec *v);                                        \
  VectorResult magnitude_squared##X(DspVec *v);                                \
  VectorResult to_real##X(DspVec *v);                                          \
  VectorResult to_imag##X(DspVec *v);                                          \
  VectorResult phase##X(DspVec *v);                                            \
  VectorResult conj##X(DspVec *v);                                             \
  VectorResult multiply_complex_exponential##X(DspVec *v, REAL a, REAL b);     \
  /* reorganization */                                                         \
  VectorResult reverse##X(DspVec *v);                                          \
  VectorResult swap_halves##X(DspVec *v);                                      \
  VectorResult zero_pad##X(DspVec *v, size_t points, int32_t option);          \
  VectorResult zero_interleave##X(DspVec *v, int32_t factor);                  \
  VectorResult resize##X(DspVec *v, size_t points);                            \
  VectorResult diff##X(DspVec *v);                                             \
  VectorResult diff_with_start##X(DspVec *v);                                  \
  VectorResult cum_sum##X(DspVec *v);                                          \
  /* reductions */                                                             \
  ScalarResult real_sum##X(DspVec *v);                                         \
  ScalarResult real_sum_sq##X(DspVec *v);                                      \
  ScalarResult real_sum_prec##X(DspVec *v);                                    \
  ComplexResult complex_sum##X(DspVec *v);                                     \
  ComplexResult complex_sum_sq##X(DspVec *v);                                  \
  ScalarResult real_dot_product##X(DspVec *a, DspVec *b);                      \
  ComplexResult complex_dot_product##X(DspVec *a, DspVec *b);                  \
  int32_t real_statistics##X(DspVec *v, RealStatistics *out);                  \
  /* time <-> frequency */                                                     \
  VectorResult plain_fft##X(DspVec *v);                                        \
  VectorResult fft##X(DspVec *v);                                              \
  VectorResult windowed_fft##X(DspVec *v, int32_t window_id);                  \
  VectorResult plain_sfft##X(DspVec *v);                                       \
  VectorResult sfft##X(DspVec *v);                                             \
  VectorResult plain_ifft##X(DspVec *v);                                       \
  VectorResult ifft##X(DspVec *v);                                             \
  VectorResult windowed_ifft##X(DspVec *v, int32_t window_id);                 \
  VectorResult plain_sifft##X(DspVec *v);                                      \
  VectorResult sifft##X(DspVec *v);                                            \
  VectorResult mirror##X(DspVec *v);                                           \
  VectorResult fft_shift##X(DspVec *v);                                        \
  VectorResult ifft_shift##X(DspVec *v);                                       \
  VectorResult apply_window##X(DspVec *v, int32_t window_id);                  \
  VectorResult unapply_window##X(DspVec *v, int32_t window_id);                \
  /* convolution & correlation */                                              \
  VectorResult convolve_signal##X(DspVec *v, DspVec *impulse_response);        \
  VectorResult convolve_real##X(DspVec *v, int32_t function_id, REAL rolloff, \
                                REAL ratio, size_t length);                    \
  VectorResult multiply_frequency_response_real##X(                            \
      DspVec *v, int32_t function_id, REAL rolloff, REAL ratio);               \
  VectorResult prepare_argument_padded##X(DspVec *v);                          \
  VectorResult correlate##X(DspVec *v, DspVec *prepared);                      \
  /* interpolation */                                                          \
  VectorResult interpolatef##X(DspVec *v, int32_t function_id, REAL rolloff,   \
                               REAL interpolation_factor, REAL delay,          \
                               size_t conv_len);                               \
  VectorResult interpolatei##X(DspVec *v, int32_t function_id, REAL rolloff,   \
                               int32_t interpolation_factor);                  \
  VectorResult interpolate##X(DspVec *v, int32_t function_id, REAL rolloff,    \
                              size_t target_points, REAL delay);               \
  VectorResult interpft##X(DspVec *v, size_t target_points);                   \
  VectorResult decimatei##X(DspVec *v, int32_t decimation_factor,              \
                            int32_t delay);                                    \
  VectorResult interpolate_lin##X(DspVec *v, REAL factor, REAL delay);         \
  VectorResult interpolate_hermite##X(DspVec *v, REAL factor, REAL delay);     \
  /* approximated ops */                                                       \
  VectorResult ln_approx##X(DspVec *v);                                        \
  VectorResult exp_approx##X(DspVec *v);                                       \
  VectorResult sin_approx##X(DspVec *v);                                       \
  VectorResult cos_approx##X(DspVec *v);                                       \
  VectorResult log_approx##X(DspVec *v, REAL base);                            \
  VectorResult expf_approx##X(DspVec *v, REAL base);                           \
  VectorResult powf_approx##X(DspVec *v, REAL exponent);                       \
  /* non-consuming getters (new handle; original untouched) */                 \
  DspVec *get_real##X(DspVec *v);                                              \
  DspVec *get_imag##X(DspVec *v);                                              \
  DspVec *get_magnitude##X(DspVec *v);                                         \
  DspVec *get_magnitude_squared##X(DspVec *v);                                 \
  DspVec *get_phase##X(DspVec *v);                                             \
  VectorResult set_real_imag##X(DspVec *v, DspVec *re, DspVec *im);            \
  VectorResult set_mag_phase##X(DspVec *v, DspVec *mag, DspVec *phase);        \
  /* precise + complex reductions */                                           \
  ScalarResult real_sum_sq_prec##X(DspVec *v);                                 \
  ComplexResult complex_sum_prec##X(DspVec *v);                                \
  ComplexResult complex_sum_sq_prec##X(DspVec *v);                             \
  ScalarResult real_dot_product_prec##X(DspVec *a, DspVec *b);                 \
  ComplexResult complex_dot_product_prec##X(DspVec *a, DspVec *b);             \
  int32_t real_statistics_prec##X(DspVec *v, RealStatistics *out);             \
  int32_t complex_statistics##X(DspVec *v, ComplexStatistics *out);            \
  int32_t real_statistics_split##X(DspVec *v, size_t len,                      \
                                   RealStatistics *out);                       \
  /* symmetric windowed transforms */                                          \
  VectorResult windowed_sfft##X(DspVec *v, int32_t window_id);                 \
  VectorResult windowed_sifft##X(DspVec *v, int32_t window_id);                \
  /* split / merge (round-robin polyphase) */                                  \
  int32_t split_into##X(DspVec *v, DspVec **targets, size_t n);                \
  VectorResult merge##X(DspVec *v, DspVec *const *sources, size_t n);          \
  /* user-callback mapping */                                                  \
  VectorResult map_inplace_real##X(DspVec *v, bdsp_map_real_fn fn,             \
                                   const void *user_data);                     \
  ScalarResult map_aggregate_real##X(DspVec *v, bdsp_map_real_fn fn,           \
                                     const void *user_data);                   \
  /* custom (C-callback) windows and convolution functions */                  \
  VectorResult apply_custom_window##X(DspVec *v, bdsp_window_fn fn,            \
                                      const void *user_data,                   \
                                      int32_t is_symmetric);                   \
  VectorResult unapply_custom_window##X(DspVec *v, bdsp_window_fn fn,          \
                                        const void *user_data,                 \
                                        int32_t is_symmetric);                 \
  VectorResult windowed_custom_fft##X(DspVec *v, bdsp_window_fn fn,            \
                                      const void *user_data,                   \
                                      int32_t is_symmetric);                   \
  VectorResult windowed_custom_ifft##X(DspVec *v, bdsp_window_fn fn,           \
                                       const void *user_data,                  \
                                       int32_t is_symmetric);                  \
  VectorResult convolve_custom##X(DspVec *v, bdsp_conv_fn fn,                  \
                                  const void *user_data,                       \
                                  int32_t is_symmetric, REAL ratio,            \
                                  size_t length);                              \
  VectorResult multiply_frequency_response_custom##X(                          \
      DspVec *v, bdsp_conv_fn fn, const void *user_data,                       \
      int32_t is_symmetric, REAL ratio);                                       \
  VectorResult interpolatef_custom##X(DspVec *v, bdsp_conv_fn fn,              \
                                      const void *user_data,                   \
                                      int32_t is_symmetric, REAL factor,       \
                                      REAL delay, size_t conv_len);            \
  VectorResult interpolatei_custom##X(DspVec *v, bdsp_conv_fn fn,              \
                                      const void *user_data,                   \
                                      int32_t is_symmetric, int32_t factor);   \
  /* ---- reference-parity tail (facade32.rs names) ---- */                    \
  /* raw access: pointer into a host cache owned by the handle, valid until   \
   * the next operation on (or deletion of) the handle.  For complex         \
   * vectors the layout is interleaved re,im pairs (reference data32 /       \
   * complex_data32, facade32.rs:158-165). */                                  \
  const REAL *data##X(DspVec *v);                                              \
  const REAL *complex_data##X(DspVec *v);                                      \
  /* XLA owns device buffers, so allocated == logical length               \
   * (reference get_allocated_len32, facade32.rs:168). */                      \
  size_t get_allocated_len##X(DspVec *v);                                      \
  VectorResult overwrite_data##X(DspVec *v, const REAL *data, size_t len);     \
  /* len counts interleaved float elements (reference set_len32). */           \
  VectorResult set_len##X(DspVec *v, size_t len);                              \
  /* Threading knobs are accepted for API parity and ignored: XLA owns       \
   * scheduling (reference new_with_performance_options32,                   \
   * facade32.rs:44-100). */                                                   \
  DspVec *new_with_performance_options##X(int32_t is_complex, int32_t domain,  \
                                          REAL init_value, size_t length,      \
                                          REAL delta, size_t core_limit);      \
  DspVec *new_with_detailed_performance_options##X(                            \
      int32_t is_complex, int32_t domain, REAL init_value, size_t length,      \
      REAL delta, size_t core_limit, size_t med_dual_core_threshold,           \
      size_t med_multi_core_threshold, size_t large_dual_core_threshold,       \
      size_t large_multi_core_threshold);                                      \
  /* pair getters: overwrite the target handles (reference                    \
   * get_real_imag32/get_mag_phase32, facade32.rs:768-783). */                 \
  int32_t get_real_imag##X(DspVec *v, DspVec *re, DspVec *im);                 \
  int32_t get_mag_phase##X(DspVec *v, DspVec *mag, DspVec *phase);             \
  /* v * (1 / (re + i im)) (reference complex_divide32). */                    \
  VectorResult complex_divide##X(DspVec *v, REAL re, REAL im);                 \
  /* NOTE: the library also exports powf32/64 and expf32/64 (the reference  \
   * facade spellings, aliases of real_powf/real_expf) — they cannot be      \
   * declared here because glibc claims those names for the _FloatN math     \
   * functions; dlsym them or call the real_* spellings. */                    \
  /* reference spellings of the by-id convolution ops */                       \
  VectorResult convolve##X(DspVec *v, int32_t function_id, REAL rolloff,       \
                           REAL ratio, size_t length);                         \
  VectorResult multiply_frequency_response##X(DspVec *v, int32_t function_id,  \
                                              REAL rolloff, REAL ratio);       \
  /* reference *_vector spellings of the elementary binary ops */              \
  VectorResult add_vector##X(DspVec *a, DspVec *b);                            \
  VectorResult sub_vector##X(DspVec *a, DspVec *b);                            \
  VectorResult mul_vector##X(DspVec *a, DspVec *b);                            \
  VectorResult div_vector##X(DspVec *a, DspVec *b);                            \
  VectorResult add_smaller_vector##X(DspVec *a, DspVec *b);                    \
  VectorResult sub_smaller_vector##X(DspVec *a, DspVec *b);                    \
  VectorResult mul_smaller_vector##X(DspVec *a, DspVec *b);                    \
  VectorResult div_smaller_vector##X(DspVec *a, DspVec *b);                    \
  VectorResult prepare_argument##X(DspVec *v);                                 \
  /* precise / complex statistics families */                                  \
  int32_t complex_statistics_prec##X(DspVec *v, ComplexStatistics *out);       \
  int32_t complex_statistics_split##X(DspVec *v, size_t len,                   \
                                      ComplexStatistics *out);                 \
  int32_t complex_statistics_split_prec##X(DspVec *v, size_t len,              \
                                           ComplexStatistics *out);            \
  int32_t real_statistics_split_prec##X(DspVec *v, size_t len,                 \
                                        RealStatistics *out);                  \
  /* custom-window symmetric transforms */                                     \
  VectorResult windowed_custom_sfft##X(DspVec *v, bdsp_window_fn fn,           \
                                       const void *user_data,                  \
                                       int32_t is_symmetric);                  \
  VectorResult windowed_custom_sifft##X(DspVec *v, bdsp_window_fn fn,          \
                                        const void *user_data,                 \
                                        int32_t is_symmetric);                 \
  /* complex user-callback mapping */                                          \
  VectorResult map_inplace_complex##X(DspVec *v, bdsp_map_complex_fn fn,       \
                                      const void *user_data);                  \
  ComplexResult map_aggregate_complex##X(DspVec *v, bdsp_map_complex_fn map,   \
                                         bdsp_agg_complex_fn aggregate,        \
                                         const void *user_data);               \
  /* complex-valued custom convolution functions */                            \
  VectorResult convolve_complex##X(DspVec *v, bdsp_conv_complex_fn fn,         \
                                   const void *user_data,                      \
                                   int32_t is_symmetric, REAL ratio,           \
                                   size_t length);                             \
  VectorResult multiply_frequency_response_complex##X(                         \
      DspVec *v, bdsp_conv_complex_fn fn, const void *user_data,               \
      int32_t is_symmetric, REAL ratio);                                       \
  VectorResult interpolate_custom##X(DspVec *v, bdsp_conv_fn fn,               \
                                     const void *user_data,                    \
                                     int32_t is_symmetric, size_t dest_points, \
                                     REAL delay);

BDSP_DECLARE(32, float)
BDSP_DECLARE(64, double)

#undef BDSP_DECLARE

#ifdef __cplusplus
}
#endif

#endif /* BASIC_DSP_TPU_H */
