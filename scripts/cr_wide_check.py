"""Block-CR kernels on the card: same-operand bits across checkouts, and the
wide (w = 6-8) instances against their plain version.

    python scripts/cr_wide_check.py digest SRC OUT.json
        Loads the port from ``SRC`` (a checkout's ``src``), runs
        ``block_cr_factor`` + ``block_cr_apply`` (and the factor's
        log-determinant) at w = 1..5, pivoted and not, on operands made
        from a fixed seed, and writes the SHA-256 digest of every output.
        Run it on a parent's and a tree's ``src`` in one call and compare
        the two files: equal digests mean the w <= 5 kernels kept their
        bits.
    python scripts/cr_wide_check.py compare A.json B.json
        Prints, per case, whether the digests agree; exits 1 if any differ.
    python scripts/cr_wide_check.py wide OUT.json
        The wide instances at w = 6, 7, 8, pivoted and not, at the
        streaming Woodbury patch shape (2 D = 20 bands, the patch rows
        rounded up to whole blocks, 12 q + 17 columns): max |kernel -
        plain|, the factor and apply launch counts, and the time of one
        factor + apply (CUDA events over 20 calls).

Needs a CUDA card; prints the card's name and power limit first.
"""
from __future__ import annotations

import hashlib
import json
import subprocess
import sys

import numpy as np
import torch

NARROW = (1, 2, 3, 4, 5)
WIDE = (6, 7, 8)


def _smi() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()


def _operands(w: int, G: int, n: int, B: int, seed: int):
    """A diagonally weighted random band (G, npad, 2w+1) padded to whole
    blocks with identity rows, and a right-hand side (G, npad, B)."""
    rng = np.random.default_rng(seed)
    npad = -(-n // w) * w
    band = rng.standard_normal((G, npad, 2 * w + 1))
    band[:, :, w] += 2.0 * (2 * w + 1)
    band[:, n:] = 0.0
    band[:, n:, w] = 1.0
    i = np.arange(npad)[:, None] + np.arange(-w, w + 1)[None, :]
    band[:, (i < 0) | (i >= npad)] = 0.0
    rhs = rng.standard_normal((G, npad, B))
    rhs[:, n:] = 0.0
    dev = torch.device("cuda")
    return (torch.as_tensor(band, device=dev),
            torch.as_tensor(rhs, device=dev))


def _digest(t: torch.Tensor) -> str:
    return hashlib.sha256(t.detach().cpu().numpy().tobytes()).hexdigest()


def digest(src: str, out: str) -> None:
    sys.path.insert(0, src)
    from repro_torch.kernels import block_cr as bcr

    res = {"src": src, "card": _smi()}
    for w in NARROW:
        for pivot in (False, True):
            band, rhs = _operands(w, 20, 30000, 16, seed=w)
            fac, ld = bcr.block_cr_factor(band, w, pivot=pivot, logdet=True)
            x = bcr.block_cr_apply(fac, rhs, w, pivot=pivot)
            torch.cuda.synchronize()
            res[f"w={w} pivot={pivot}"] = dict(
                factor=_digest(fac), logdet=_digest(ld), x=_digest(x))
    print(json.dumps(res, indent=1))
    with open(out, "w") as f:
        json.dump(res, f, indent=1)


def compare(a: str, b: str) -> int:
    ra, rb = (json.load(open(p)) for p in (a, b))
    bad = 0
    for key in (k for k in ra if k.startswith("w=")):
        same = ra[key] == rb.get(key)
        bad += not same
        print(f"{key}: {'same bits' if same else 'DIFFERENT'}")
    return 1 if bad else 0


def wide(out: str) -> None:
    from repro_torch.core.gband_update import patch_size
    from repro_torch.kernels import _build
    from repro_torch.kernels import block_cr as bcr

    res = {"card": _smi()}
    for w in WIDE:
        q = (w - 1) // 2  # the q whose insert (2q+2) or evict (2q+1) is w
        n = patch_size(q, 1 << 20)
        B = 12 * q + 17
        for pivot in (False, True):
            band, rhs = _operands(w, 20, n, B, seed=10 + w)
            _build.reset_launch_counts()
            fac, ld = bcr.block_cr_factor(band, w, pivot=pivot, logdet=True)
            x = bcr.block_cr_apply(fac, rhs, w, pivot=pivot)
            torch.cuda.synchronize()
            counts = {k: v for k, v in _build.launch_counts().items() if v}
            fp, ldp = bcr.block_cr_factor_plain(band.cpu(), w, pivot=pivot,
                                                logdet=True)
            xp = bcr.block_cr_apply_plain(fp, rhs.cpu(), w, pivot=pivot)
            err = float((x.cpu() - xp).abs().max())
            err_ld = float((ld.cpu() - ldp).abs().max())
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
            for _ in range(20):
                bcr.block_cr_apply(bcr.block_cr_factor(band, w, pivot=pivot),
                                   rhs, w, pivot=pivot)
            end.record()
            torch.cuda.synchronize()
            row = dict(w=w, pivot=pivot, G=20, npad=band.shape[1], B=B,
                       max_abs_err=err, logdet_err=err_ld,
                       scale=float(xp.abs().max()), launches=counts,
                       ms=start.elapsed_time(end) / 20)
            res[f"w={w} pivot={pivot}"] = row
            print(json.dumps(row), flush=True)
    with open(out, "w") as f:
        json.dump(res, f, indent=1)


if __name__ == "__main__":
    cmd = sys.argv[1]
    if cmd == "digest":
        digest(sys.argv[2], sys.argv[3])
    elif cmd == "compare":
        sys.exit(compare(sys.argv[2], sys.argv[3]))
    elif cmd == "wide":
        sys.path.insert(0, "src")
        wide(sys.argv[2])
    else:
        sys.exit(f"unknown command {cmd!r}")
