"""Identity-tail canonicalization and the fixed-association sum.

PyTorch counterpart of ``repro.masking``. Arrays are allocated at a static
row count ``n``; when ``n_active`` is given, rows ``>= n_active`` are
padding that every helper here turns into decoupled identity rows (bands),
zeros (states) or self-maps (permutations), so the padded system is exactly
``blockdiag(M_active, I)``. ``n_active=None`` means fully active and every
helper is the identity.

``n_active`` is a 0-d count, or a stack of counts (a fleet's (T,)) over
the leading axes of the tensor it masks: it broadcasts over the axes that
follow (``lead_count``).
"""
from __future__ import annotations

import torch

__all__ = ["canonical_band", "mask_rows", "canonical_perm", "tree_sum",
           "lead_count"]


def lead_count(n_active, ndim: int):
    """``n_active`` shaped to broadcast over a tensor of ``ndim`` axes whose
    leading axes it indexes (a 0-d count, or an int, as it is)."""
    if not torch.is_tensor(n_active) or n_active.ndim == 0:
        return n_active
    return n_active.reshape(n_active.shape + (1,) * (ndim - n_active.ndim))


def canonical_band(band: torch.Tensor, lo: int, hi: int, n_active):
    """Identity-tail canonical form of row-aligned band data (..., n, w)."""
    if n_active is None:
        return band
    n = band.shape[-2]
    na = lead_count(n_active, band.ndim)
    i = torch.arange(n, device=band.device)[:, None]
    j = i + torch.arange(-lo, hi + 1, device=band.device)[None, :]
    active = (i < na) & (j >= 0) & (j < na)
    ident = torch.zeros((n, lo + hi + 1), dtype=band.dtype, device=band.device)
    ident[:, lo] = 1.0
    return torch.where(active, band, ident)


def mask_rows(x: torch.Tensor, n_active, axis: int = -2):
    """Zero rows ``>= n_active`` along ``axis``."""
    if n_active is None:
        return x
    ax = axis % x.ndim
    shape = [1] * x.ndim
    shape[ax] = x.shape[ax]
    keep = (torch.arange(x.shape[ax], device=x.device).reshape(shape)
            < lead_count(n_active, x.ndim))
    return torch.where(keep, x, torch.zeros((), dtype=x.dtype, device=x.device))


def canonical_perm(idx: torch.Tensor, n_active):
    """Identity-tail canonical form of permutation indices (..., n)."""
    if n_active is None:
        return idx
    j = torch.arange(idx.shape[-1], dtype=idx.dtype, device=idx.device)
    return torch.where(j < lead_count(n_active, idx.ndim), idx, j)


def tree_sum(x: torch.Tensor, axis: int) -> torch.Tensor:
    """Sum along ``axis`` with a fixed halving-tree association.

    Pads to a power of two with zeros and adds the two halves until one
    slice is left: only elementwise adds, so the rounding does not depend
    on how the reduction is scheduled.
    """
    ax = axis % x.ndim
    n = x.shape[ax]
    if n == 0:
        return x.sum(dim=ax)
    p = 1 << (n - 1).bit_length()
    if p != n:
        pad_shape = list(x.shape)
        pad_shape[ax] = p - n
        x = torch.cat([x, x.new_zeros(pad_shape)], dim=ax)
    while p > 1:
        h = p // 2
        x = x.narrow(ax, 0, h) + x.narrow(ax, h, h)
        p = h
    return x.squeeze(ax)
