"""Two-process ``jax.distributed`` test.

Launches 2 local processes, each with 2 virtual CPU devices, connected via
``jax.distributed.initialize`` (Gloo CPU collectives — the same mechanism
that carries cross-host collectives on a real multi-host cluster). Each worker runs
the sharded ppermute engine over the 4-device global mesh and checks the
output against a scipy oracle; see ``tests/multihost_worker.py``.

The workers get the repo root as their whole PYTHONPATH (nothing else
from the parent's path is imported at interpreter start); this test is
CPU-only by construction.
"""

import os
import socket
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "multihost_worker.py")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_two_process_distributed_sharded_step():
    port = _free_port()
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO  # see module docstring
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    env.pop("JAX_PLATFORMS", None)
    procs = [
        subprocess.Popen(
            [sys.executable, WORKER, str(port), str(pid), "2"],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env,
        )
        for pid in range(2)
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
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {pid} failed:\n{out}"
        assert "MULTIHOST_OK" in out, f"worker {pid} did not complete:\n{out}"
        assert "mesh 2x2 OK" in out and "mesh 1x4 OK" in out, out
        assert "mesh 2x2 hc OK" in out and "mesh 1x4 hc OK" in out, out
        assert "mesh 2x2 nu OK" in out and "mesh 1x4 nu OK" in out, out
