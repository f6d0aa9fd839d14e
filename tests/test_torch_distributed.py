"""The port's fleet placed on torch ``DeviceMesh`` es, across 4 spawned gloo
ranks on the CPU (``tests/torch_dist_worker.py``, one thread a rank, a
``FileStore`` under the test's temporary directory).

Each rank checks every case itself: a T = 4 fleet (q = 0, D = 2, 40-60
points in capacity 64) placed by ``fleet_pspecs`` on a (4, 1) ("data",
"model") mesh and on a (2, 2, 1) ("pod", "data", "model") mesh (lane t on
rank t), each rank fitting and querying its lane, the gathered mean and
variance equal to the unsharded fleet's bit for bit; the replication
fallbacks (T = 6 on the 4-way axis, a ``T``-pinned leaf of another
length); ``ShardedBatches`` under ``batch_pspecs`` (rank r holds its rows
of the global batch); and after rank 3 is lost, ``elastic_mesh`` over
ranks 0-2 is (3, 1) and a checkpointed T = 6 fleet moved onto it by
``reshard_tree`` queries bit for bit.
"""
from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
WORLD = 4


def test_fleet_on_four_gloo_ranks(tmp_path):
    env = dict(os.environ, OMP_NUM_THREADS="1", GLOO_SOCKET_IFNAME="lo",
               PYTHONPATH=os.pathsep.join(
                   [str(ROOT / "src")]
                   + ([os.environ["PYTHONPATH"]]
                      if os.environ.get("PYTHONPATH") else [])))
    procs = [subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "torch_dist_worker.py"),
         str(r), str(WORLD), str(tmp_path / "store"), str(tmp_path / "ckpt")],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
        for r in range(WORLD)]
    try:
        outs = [p.communicate(timeout=150) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, (out, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and f"rank {r}: ok" in out, (
            f"rank {r} exited {p.returncode}:\n{out}\n{err[-4000:]}")
