"""Launch the multi-process (multi-"host") validation: N OS processes x
D local XLA CPU devices joined via ``jax.distributed.initialize`` — the
(host, device) mesh whose host axis crosses a REAL process boundary, as
it would cross the network between hosts.  The workers force the CPU
backend, so the run never opens a GPU.  Prints the result as one JSON
line.

Usage: python bench_multihost.py [nproc] [local_devices] [signal_len]
"""
import json
import os
import socket
import subprocess
import sys


def free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def run(nproc=2, local_devices=4, n=1 << 16, timeout=600):
    port = free_port()
    procs = []
    here = os.path.dirname(os.path.abspath(__file__))
    for pid in range(nproc):
        procs.append(subprocess.Popen(
            [sys.executable, os.path.join(here, "multiproc_worker.py"),
             str(pid), str(nproc), str(port), str(local_devices), str(n)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            cwd=here))
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=timeout)
            outs.append((p.returncode, out, err))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        raise
    result = None
    for rc, out, err in outs:
        if rc != 0:
            sys.stderr.write(err[-4000:])
            raise RuntimeError(f"worker failed rc={rc}")
        for line in out.splitlines():
            if line.startswith("MULTIHOST_RESULT "):
                result = json.loads(line[len("MULTIHOST_RESULT "):])
    assert result is not None, "worker 0 produced no result line"
    return result


def main():
    nproc = int(sys.argv[1]) if len(sys.argv) > 1 else 2
    local_devices = int(sys.argv[2]) if len(sys.argv) > 2 else 4
    n = int(sys.argv[3]) if len(sys.argv) > 3 else 1 << 16
    result = run(nproc, local_devices, n)
    print(json.dumps(result))
    sys.exit(0 if result["ok"] else 1)


if __name__ == "__main__":
    main()
