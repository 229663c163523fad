"""Multi-host smoke test: two OS processes, one CPU device
each, gloo TCP collectives — the process-level story the reference cannot
express (its multi-device path is in-process cudaMemcpy + a host-CPU sum,
multi_gpu.cpp:3-59, main.cu:199-210; SURVEY.md §5.8).

Spawns ``scripts/smoke_multihost.py`` twice; each process traces its half of
a tiny scene through ``parallel.multihost.run_sharded_multihost`` and
asserts the psum-combined grid equals an independently computed
single-device reference to f64 round-off.
"""

import os
import socket
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(REPO, "scripts", "smoke_multihost.py")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.slow
def test_two_process_multihost_trace():
    port = _free_port()
    env = dict(os.environ)
    # the script pins its own platform/device-count before importing jax
    env.pop("XLA_FLAGS", None)
    procs = [
        subprocess.Popen([sys.executable, SCRIPT, str(i), "2", str(port)],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                         text=True, env=env, cwd=REPO)
        for i in range(2)
    ]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=240)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {i} failed:\n{out[-3000:]}"
        assert f"MULTIHOST OK proc={i}/2 devices=2" in out, out[-3000:]
    # both hosts must report the identical replicated grid total
    tot = [line.split("edep_total=")[1].split()[0]
           for out in outs for line in out.splitlines()
           if "MULTIHOST OK" in line]
    assert len(tot) == 2 and tot[0] == tot[1], tot
