"""Consume the C ABI from plain Python ctypes — no basic_dsp_tpu import.

The analog of the reference's foreign-language interop demo
(examples/basic_dsp_example.py there: ctypes over the Rust cdylib); here
the shared library embeds the JAX runtime, so any language with a
C FFI drives the same compiled pipelines.

Run: make interop && python examples/python_ctypes_example.py
(BDSP_PLATFORM=cpu to force the CPU backend.)
"""
import ctypes
import os
import sys

LIB = os.path.join(os.path.dirname(__file__), "..", "interop", "build",
                   "libbasic_dsp_tpu.so")


class VectorResult(ctypes.Structure):
    _fields_ = [("result_code", ctypes.c_int32),
                ("vector", ctypes.c_void_p)]


class ScalarResult(ctypes.Structure):
    _fields_ = [("result_code", ctypes.c_int32),
                ("result", ctypes.c_double)]


def main():
    if not os.path.exists(LIB):
        print("build the library first: make interop", file=sys.stderr)
        return 1
    lib = ctypes.CDLL(LIB)

    lib.bdsp_init.restype = ctypes.c_int32
    if lib.bdsp_init() != 0:
        lib.bdsp_last_error.restype = ctypes.c_char_p
        print("init failed:", lib.bdsp_last_error(), file=sys.stderr)
        return 1

    lib.new64.restype = ctypes.c_void_p
    lib.new64.argtypes = [ctypes.c_int32, ctypes.c_int32, ctypes.c_double,
                          ctypes.c_size_t, ctypes.c_double]
    lib.get_value64.restype = ctypes.c_double
    lib.get_value64.argtypes = [ctypes.c_void_p, ctypes.c_size_t]
    lib.real_offset64.restype = VectorResult
    lib.real_offset64.argtypes = [ctypes.c_void_p, ctypes.c_double]
    lib.real_scale64.restype = VectorResult
    lib.real_scale64.argtypes = [ctypes.c_void_p, ctypes.c_double]
    lib.real_sum64.restype = ScalarResult
    lib.real_sum64.argtypes = [ctypes.c_void_p]
    lib.delete_vector64.restype = None
    lib.delete_vector64.argtypes = [ctypes.c_void_p]

    n = 4096
    # real time vector of zeros (is_complex=0, domain=0/time, delta=1.0)
    vec = ctypes.c_void_p(lib.new64(0, 0, 0.0, n, 1.0))
    print(f"vec[0] at start: {lib.get_value64(vec, 0)}")

    for _ in range(5):
        r = lib.real_offset64(vec, 5.0)
        assert r.result_code == 0, r.result_code
        vec = ctypes.c_void_p(r.vector)
    r = lib.real_scale64(vec, 2.0)
    assert r.result_code == 0
    vec = ctypes.c_void_p(r.vector)

    v0 = lib.get_value64(vec, 0)
    total = lib.real_sum64(vec)
    assert total.result_code == 0
    print(f"after 5 offsets of 5.0 and scale 2.0: vec[0] = {v0}")
    print(f"sum = {total.result} (expect {50.0 * n})")
    ok = abs(v0 - 50.0) < 1e-9 and abs(total.result - 50.0 * n) < 1e-6 * n
    lib.delete_vector64(vec)
    print("ok" if ok else "MISMATCH")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
