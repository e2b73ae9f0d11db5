"""Configuration-matrix test runner — the analog of the reference's
feature-matrix CI (Makefile:6-16 + .github/workflows/rust.yml:14-42, which
re-runs the same goldens under {default, no_std, SSE2, AVX2} builds).

Here the axes are the runtime representation modes that must all agree on
the same goldens:

  * planar-complex boundary mode on/off (_planar.py)
  * x64 (f64/c128 flavors) on/off (f32-only runs use the reference's own
    f32 golden tolerance grade — see tests/tools.py)

plus a precision-dial pass (``high`` matmul precision) of the conv and
resampling families, proving the dial only changes accuracy, not semantics.

Usage: python tests/run_matrix.py [extra pytest args]
"""
from __future__ import annotations

import os
import subprocess
import sys
import time

CONFIGS = [
    ("planar=off x64=on ", {"BDSP_PLANAR_COMPLEX": "0", "BDSP_TEST_X64": "1"},
     []),
    ("planar=on  x64=on ", {"BDSP_PLANAR_COMPLEX": "1", "BDSP_TEST_X64": "1"},
     []),
    ("planar=off x64=off", {"BDSP_PLANAR_COMPLEX": "0", "BDSP_TEST_X64": "0"},
     []),
    ("planar=on  x64=off", {"BDSP_PLANAR_COMPLEX": "1", "BDSP_TEST_X64": "0"},
     []),
    ("precision=high    ", {"BDSP_PLANAR_COMPLEX": "0", "BDSP_TEST_X64": "1",
                            "BDSP_MATMUL_PRECISION": "high"},
     ["tests/test_conv.py", "tests/test_interp.py", "tests/test_phase_mux.py",
      "tests/test_matrix.py"]),
]


def main() -> int:
    extra = sys.argv[1:]
    results = []
    for name, env_over, targets in CONFIGS:
        env = dict(os.environ, **env_over)
        cmd = [sys.executable, "-m", "pytest", "-q",
               *(targets or ["tests/"]), *extra]
        t0 = time.time()
        proc = subprocess.run(cmd, env=env, cwd=os.path.dirname(
            os.path.dirname(os.path.abspath(__file__))))
        dt = time.time() - t0
        ok = proc.returncode == 0
        results.append((name, ok, dt))
        print(f"[matrix] {name}: {'PASS' if ok else 'FAIL'} ({dt:.0f}s)",
              flush=True)
    print("\n=== configuration matrix ===")
    for name, ok, dt in results:
        print(f"  {name}  {'PASS' if ok else 'FAIL'}  {dt:6.0f}s")
    return 0 if all(ok for _, ok, _ in results) else 1


if __name__ == "__main__":
    sys.exit(main())
