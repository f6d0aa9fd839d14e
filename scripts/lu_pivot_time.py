"""Time the pivoted banded LU kernel (``csrc/banded_lu_pivot.cu``) on one
NVIDIA GPU: a solve and a factor-only call (the log-determinant) at the
shapes the pivoted LU path gives it, CUDA events over 5 calls after one
warm-up, beside the card's name and power limit.

    python scripts/lu_pivot_time.py [OUT.json]

Shapes (lo, hi, G, n, B): the path's SAPhi at q = 0 (1, 1, 10, 30000)
with B = 32 and 1, its kmg coarse level (n = 3750), a (2, 2) band with 16
columns (SAPhi at q = 1, the gradients' B at q = 0), an asymmetric (2, 1)
band (the instance that reads its widths at run time) and the q = 3
insert patch (8, 8, 20, 277, 53). Bands are seeded and diagonally
dominant; the timings do not depend on the values.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

SHAPES = ((1, 1, 10, 30000, 32), (1, 1, 10, 30000, 1), (1, 1, 10, 3750, 32),
          (2, 2, 10, 30000, 16), (2, 1, 10, 30000, 8), (8, 8, 20, 277, 53))


def _ms(fn, reps=5):
    fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def main(out=None):
    if not torch.cuda.is_available():
        sys.exit("lu_pivot_time: needs an NVIDIA GPU")
    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
    from repro_torch.kernels.banded_lu import banded_lu_pivot

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card, flush=True)
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    rows = []
    for lo, hi, G, n, B in SHAPES:
        data = rng.standard_normal((G, n, lo + hi + 1))
        data[..., lo] = np.abs(data).sum(-1) + 1.0
        bd = torch.as_tensor(data, device=dev)
        rhs = torch.as_tensor(rng.standard_normal((G, n, B)), device=dev)
        solve = _ms(lambda: banded_lu_pivot(bd, rhs, lo, hi))
        factor = _ms(lambda: banded_lu_pivot(bd, None, lo, hi, solve=False))
        rows.append(dict(lo=lo, hi=hi, G=G, n=n, B=B, solve_ms=solve,
                         factor_ms=factor))
        print(f"banded_lu_pivot lo={lo} hi={hi} G={G} n={n} B={B}: solve "
              f"{solve:.4f} ms, factor only {factor:.4f} ms", flush=True)
    if out:
        Path(out).write_text(json.dumps(dict(card=card, rows=rows),
                                        indent=1))


if __name__ == "__main__":
    main(*sys.argv[1:2])
