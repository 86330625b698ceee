"""Multi-process ("multi-host") mesh: byte-identity vs single-process.

Launches 2 worker processes (tests/dist_worker.py), each contributing 4
virtual CPU devices to an 8-device global mesh over jax.distributed (the
CPU stand-in for a multi-host cluster; SURVEY.md section 4).  Workers check
rep-axis-sharded single proofs, a mixed z64+B2A circuit, distributed
verification, and the proof-axis-sharded batch path, each byte-identical to
the unsharded golden.
"""

import os
import socket
import subprocess
import sys

import pytest


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.mark.slow
def test_multiprocess_mesh_byte_identity(tmp_path):
    worker = os.path.join(os.path.dirname(__file__), "dist_worker.py")
    port = _free_port()
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    repo_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = repo_root + os.pathsep + env.get("PYTHONPATH", "")
    nproc = 2
    procs = []
    logs = []
    for i in range(nproc):
        log = open(tmp_path / f"worker_{i}.log", "w")
        logs.append(log)
        procs.append(
            subprocess.Popen(
                [sys.executable, worker, str(i), str(nproc), str(port),
                 str(tmp_path)],
                env=env, stdout=log, stderr=subprocess.STDOUT,
            )
        )
    try:
        rcs = [p.wait(timeout=840) for p in procs]
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        rcs = [p.wait() for p in procs]
    finally:
        for log in logs:
            log.close()
    for i, rc in enumerate(rcs):
        if rc != 0:
            tail = (tmp_path / f"worker_{i}.log").read_text()[-4000:]
            raise AssertionError(f"worker {i} exited {rc}:\n{tail}")
    for i in range(nproc):
        assert (tmp_path / f"ok_{i}").exists(), f"worker {i} missing OK file"
