"""``examples/streaming_bo_torch.py`` on the CPU at its small defaults (two
rounds, ``window=25`` so that the sliding window is reached): the
proposals are finite and inside the box, each probe query carries the
version of the posterior it was admitted at, and the engine holds the
window at a fixed capacity. Runs only the port."""
from __future__ import annotations

import importlib.util
from pathlib import Path

import numpy as np
import torch

torch.set_num_threads(2)

EXAMPLE = Path(__file__).resolve().parents[1] / "examples" / \
    "streaming_bo_torch.py"


def test_streaming_bo_example_runs_on_cpu():
    spec = importlib.util.spec_from_file_location("streaming_bo_torch",
                                                  EXAMPLE)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    engine, hist = mod.main(rounds=2, device="cpu", window=25)
    assert len(hist) == 2
    for h in hist:
        assert np.all(np.isfinite(h["x"])) and np.isfinite(h["y"])
        assert np.all(np.abs(h["x"]) <= 2.0)
        assert all(q.done and q.result["version"] == h["version"]
                   for q in h["probes"])
    # round 1 inserts (24 -> 25 points); round 2 evicts the oldest first
    assert [h["version"] for h in hist] == [0, 1]
    assert engine.num_points == 25 and engine.version == 3
    assert engine.capacity == 32
