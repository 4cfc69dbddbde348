"""ProcessGroupRing (parallel/mesh.py) over torch.distributed's gloo
backend, two processes on this host, against ThreadRing(2): the
distributed block dambreak at dx = 0.1 (parallel/run_ring.py), 3
advection steps in float64.  Both rings run the same per-rank body and
reduce only maxima and minima here, so each rank's rows, time and
sub-step count are equal bit for bit."""

import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from sphinxsys_tpu_torch.parallel import run_ring
from sphinxsys_tpu_torch.parallel.mesh import ThreadRing

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]
ARGS = dict(dx=0.1, steps=3)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_process_group_ring_equals_thread_ring(tmp_path):
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(k, None)
    procs = [subprocess.Popen(
        [sys.executable, "-m", "sphinxsys_tpu_torch.parallel.run_ring",
         "--ring", "process", "--rank", str(r), "--world-size", "2",
         "--port", str(port), "--device", "cpu", "--dx", str(ARGS["dx"]),
         "--steps", str(ARGS["steps"]), "--out", str(tmp_path / "pg")],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    outs = []
    for p in procs:
        try:
            outs.append(p.communicate(timeout=120)[0])
        finally:
            p.kill()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out

    ring = ThreadRing(2, "cpu")
    want = run_ring.run(ring, **ARGS)
    n = want["n_fluid"]
    got_ids = []
    for r in range(2):
        rec = np.load(tmp_path / f"pg_{r}.npz")
        assert int(rec["n_ac"]) == want["n_ac"]
        assert float(rec["time"]) == want["time"]
        assert not bool(rec["overflow"])
        got_ids.append(rec["ids"])
        rows = np.isin(want["ids"], rec["ids"])
        order = np.argsort(want["ids"][rows])
        ro = np.argsort(rec["ids"])
        np.testing.assert_array_equal(rec["Position"][ro],
                                      want["Position"][rows][order])
        np.testing.assert_array_equal(rec["Velocity"][ro],
                                      want["Velocity"][rows][order])
    assert sorted(np.concatenate(got_ids).tolist()) == list(range(n))
