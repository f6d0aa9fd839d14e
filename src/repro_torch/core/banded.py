"""Banded matrix algebra in PyTorch (counterpart of ``repro.core.banded``).

Storage convention (row-aligned bands):
    ``data[..., i, lo + m] = M[i, i + m]``  for ``m in [-lo, hi]``,
with out-of-range entries stored as exact zeros. ``lo``/``hi`` are static
ints (half-bandwidths).

The public ``matvec`` / ``solve`` / ``logdet`` / ``band_band_matmul`` entry
points dispatch through ``repro_torch.kernels.ops``: hand-written CUDA
kernels for CUDA tensors, the plain versions for CPU tensors.

Capacity padding: a ``Banded`` may carry ``n_active``, a 0-d int32 tensor on
the band's device, beside its static row count (the capacity). Rows
``>= n_active`` are padding; every dispatched op canonicalizes them to
decoupled identity rows (and the matching right-hand-side rows to zeros)
before computing (``repro_torch.masking``), so results are exact on the
active prefix whatever the padding holds.
"""
from __future__ import annotations

import dataclasses

import torch

from ..masking import canonical_band

__all__ = ["Banded", "from_dense", "to_dense", "matvec", "transpose",
           "band_band_matmul", "solve", "solve_nopivot", "logdet", "add",
           "scale", "mask_band"]


@dataclasses.dataclass(frozen=True)
class Banded:
    """Banded matrix; ``data`` has shape ``(..., n, lo + hi + 1)``.

    ``n_active`` (0-d int32 tensor, optional) marks the capacity-padded
    form: the matrix is ``n_active x n_active`` stored in ``n`` rows.
    ``None`` = fully active."""

    data: torch.Tensor
    lo: int
    hi: int
    n_active: torch.Tensor | None = None

    def __post_init__(self):
        if self.data.shape[-1] != self.lo + self.hi + 1:
            raise ValueError(
                f"band width {self.data.shape[-1]} != lo + hi + 1 for "
                f"lo={self.lo}, hi={self.hi}")

    @property
    def n(self) -> int:
        return self.data.shape[-2]

    @property
    def capacity(self) -> int:
        return self.data.shape[-2]

    @property
    def width(self) -> int:
        return self.lo + self.hi + 1

    def canonical(self) -> "Banded":
        """Identity-tail canonical form (the band itself when unpadded)."""
        if self.n_active is None:
            return self
        return Banded(canonical_band(self.data, self.lo, self.hi,
                                     self.n_active),
                      self.lo, self.hi, self.n_active)


def _join_active(a: Banded, b: Banded):
    """The shared ``n_active`` of two operands (either may be unpadded)."""
    return a.n_active if a.n_active is not None else b.n_active


def _band_mask(n: int, lo: int, hi: int, device=None) -> torch.Tensor:
    """Mask of in-range band entries, shape (n, lo+hi+1)."""
    i = torch.arange(n, device=device)[:, None]
    j = i + torch.arange(-lo, hi + 1, device=device)[None, :]
    return (j >= 0) & (j < n)


def mask_band(b: Banded) -> Banded:
    mask = _band_mask(b.n, b.lo, b.hi, device=b.data.device)
    return Banded(b.data * mask, b.lo, b.hi, b.n_active)


def from_dense(mat: torch.Tensor, lo: int, hi: int) -> Banded:
    n = mat.shape[-1]
    i = torch.arange(n, device=mat.device)[:, None]
    j = (i + torch.arange(-lo, hi + 1, device=mat.device)[None, :]).clamp(0, n - 1)
    idx = j.expand(mat.shape[:-2] + j.shape)
    data = torch.gather(mat, -1, idx) * _band_mask(n, lo, hi, mat.device)
    return Banded(data, lo, hi)


def to_dense(b: Banded) -> torch.Tensor:
    n = b.n
    out = b.data.new_zeros(b.data.shape[:-2] + (n, n))
    i = torch.arange(n, device=b.data.device)
    for m in range(-b.lo, b.hi + 1):
        j = i + m
        valid = (j >= 0) & (j < n)
        out[..., i[valid], j[valid]] += b.data[..., valid, b.lo + m]
    return out


def _shift(x: torch.Tensor, m: int, dim: int = -1) -> torch.Tensor:
    """shift(x, m)[..., i] = x[..., i+m] along ``dim``, zero fill."""
    if m == 0:
        return x
    n = x.shape[dim]
    k = max(n - abs(m), 0)
    out = torch.zeros_like(x)
    if m > 0:
        out.narrow(dim, 0, k).copy_(x.narrow(dim, n - k, k))
    else:
        out.narrow(dim, n - k, k).copy_(x.narrow(dim, 0, k))
    return out


def _matvec_scan(b: Banded, x: torch.Tensor) -> torch.Tensor:
    """Plain shift-multiply matvec; x (..., n) or (..., n, k)."""
    if x.ndim >= 2 and x.shape[-2] == b.n and x.ndim == b.data.ndim:
        y = None
        for m in range(-b.lo, b.hi + 1):
            term = b.data[..., :, b.lo + m][..., None] * _shift(x, m, dim=-2)
            y = term if y is None else y + term
        return y
    y = None
    for m in range(-b.lo, b.hi + 1):
        term = b.data[..., :, b.lo + m] * _shift(x, m)
        y = term if y is None else y + term
    return y


def matvec(b: Banded, x: torch.Tensor, *, backend: str | None = None):
    """y = M @ x; x (..., n) or (..., n, k). Dispatches through ``ops``."""
    from ..kernels import ops as _ops

    return _ops.banded_matvec(b.data, x, b.lo, b.hi, backend=backend,
                              n_active=b.n_active)


def transpose(b: Banded) -> Banded:
    """M^T in band form: loT = hi, hiT = lo."""
    cols = [_shift(b.data[..., :, b.lo - m], m) for m in range(-b.hi, b.lo + 1)]
    return mask_band(Banded(torch.stack(cols, dim=-1), b.hi, b.lo,
                            b.n_active))


def band_band_matmul(a: Banded, b: Banded, *, backend: str | None = None):
    """C = A @ B in band form; dispatches through ``ops``."""
    from ..kernels import ops as _ops

    n_active = _join_active(a, b)
    data = _ops.band_band_matmul(a.data, b.data, a.lo, a.hi, b.lo, b.hi,
                                 backend=backend, n_active=n_active)
    return Banded(data, a.lo + b.lo, a.hi + b.hi, n_active)


def add(a: Banded, b: Banded) -> Banded:
    """A + B in band form (result bandwidths are the max of the two).

    Identity tails of padded operands sum to ``2 I``; the result carries
    ``n_active``, so the next dispatched op canonicalizes the tail again."""
    lo, hi = max(a.lo, b.lo), max(a.hi, b.hi)
    batch = torch.broadcast_shapes(a.data.shape[:-2], b.data.shape[:-2])
    out = a.data.new_zeros(batch + (a.n, lo + hi + 1))
    out[..., :, lo - a.lo: lo + a.hi + 1] += a.data
    out[..., :, lo - b.lo: lo + b.hi + 1] += b.data
    return Banded(out, lo, hi, _join_active(a, b))


def scale(a: Banded, s) -> Banded:
    return Banded(a.data * s, a.lo, a.hi, a.n_active)


def solve(b: Banded, rhs: torch.Tensor, pivot: bool = True, *,
          backend: str | None = None, alg: str | None = None):
    """Solve M x = rhs; dispatches through ``ops``. Default uses partial
    pivoting (robust).

    ``pivot=True`` runs the pivoted block-CR mode where ``ops`` resolves the
    "cr" route (lo == hi >= 1), and the pivoted banded LU (the reference's
    gbsv-style scan, ``kernels.banded_lu.banded_lu_pivot``) on the "lu"
    route (lo != hi, or ``alg="lu"``), where lo >= 1.
    """
    from ..kernels import ops as _ops

    return _ops.banded_solve(b.data, rhs, b.lo, b.hi, pivot=pivot,
                             backend=backend, alg=alg, n_active=b.n_active)


def solve_nopivot(b: Banded, rhs: torch.Tensor, *,
                  backend: str | None = None):
    """Solve M x = rhs by LU without pivoting (fast; requires a stable LU):
    the LU kernel on any (lo, hi), as the reference's scan. A padded band
    is canonicalized first, so the active prefix is exact."""
    return solve(b, rhs, pivot=False, backend=backend, alg="lu")


def logdet(b: Banded, pivot: bool = True, *, backend: str | None = None,
           alg: str | None = None):
    """log |det M|; dispatches through ``ops``."""
    from ..kernels import ops as _ops

    return _ops.banded_logdet(b.data, b.lo, b.hi, pivot=pivot,
                              backend=backend, alg=alg, n_active=b.n_active)
