"""Multi-host distribution: 2-process CPU conformance run.

SURVEY.md §4 calls for multiprocess CPU runs to validate the host-level
pattern without a pod: two separate processes each own 2 virtual CPU
devices, join via jax.distributed.initialize, build one global 4-device
('ch','time') mesh, and run the halo-exchange FIR over it. Process 0
asserts bit-identity against the single-process sequential reference
(tools/multihost_worker.py).
"""

import os
import socket
import subprocess
import sys

import pytest

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_stream():
    port = _free_port()
    n_proc, dev_per_proc = 2, 2
    env_base = {
        **os.environ,
        "JAX_PLATFORMS": "cpu",
        "XLA_FLAGS": f"--xla_force_host_platform_device_count={dev_per_proc}",
        "MULTIHOST_COORD": f"127.0.0.1:{port}",
        "MULTIHOST_N": str(n_proc),
    }
    worker = os.path.join(_REPO, "tools", "multihost_worker.py")
    procs = []
    for pid in range(n_proc):
        env = {**env_base, "MULTIHOST_ID": str(pid)}
        procs.append(
            subprocess.Popen(
                [sys.executable, worker],
                env=env,
                stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT,
                text=True,
                cwd=_REPO,
            )
        )
    outs = []
    for p in procs:
        out, _ = p.communicate(timeout=240)
        outs.append(out)
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {pid} failed:\n{out}"
    assert "MULTIHOST_OK procs=2 devices=4 local=2" in outs[0], outs[0]
    assert "MULTIHOST_CHANNELIZER_OK M=64 T=96 procs=2" in outs[0], outs[0]
    # the double-buffered pipelined stream (the structure the weak-scaling
    # claim rests on) across the real 2-process boundary, exact
    assert "MULTIHOST_PIPELINED_STREAM_OK B=3 M=64 T=96 procs=2" in outs[0], (
        outs[0]
    )
