"""Multi-process (host, device) mesh: the sharded ops must agree with the
single-device oracles when the mesh's host axis crosses a REAL process
boundary (``jax.distributed.initialize`` over 2 OS processes, which the
single-process virtual meshes cannot exercise).

The heavy lifting lives in multiproc_worker.py / bench_multihost.py;
this test launches the 2-process harness at a small size.  The subprocess
workers configure their own CPU backends — the parent suite's 8-device
virtual mesh is irrelevant to them.
"""
import os
import sys


sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def test_two_process_mesh_equality_and_handoff():
    import bench_multihost

    result = bench_multihost.run(nproc=2, local_devices=2, n=1 << 14,
                                 timeout=540)
    assert result["n_processes"] == 2
    assert result["global_devices"] == 4
    for name, chk in result["checks"].items():
        assert chk["ok"], (name, chk)
    assert result["ok"]
