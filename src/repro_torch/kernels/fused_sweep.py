"""The padded operand stack of the whole-solve kernel, and its plain pieces.

Counterpart of the padding/layout contract of
``repro.kernels.fused_sweep`` (``_pad_len``, ``FusedSweep``) and of the
value-level building blocks the reference's fused kernels share (``_mv``,
``_gather``, ``_solve_sym``, ``_block_solve_dim``). The per-iteration
kernels themselves are not ported: every pcg solve takes the whole-solve
kernel (``mega_solve.py``).

Padding: rows are padded to ``npad`` (n rounded up to the lcm of the solved
half-bandwidths) so every block-CR solve sees whole ``w x w`` blocks. Band
tails are decoupled identity rows, state tails zero, permutation tails map
to themselves, so pad rows stay exactly zero through gathers, matvecs and
solves.
"""
from __future__ import annotations

import math

import torch

from .block_cr import cr_solve_values

__all__ = ["FusedSweep", "_pad_len", "_mv", "_gather", "_solve_sym",
           "_block_solve_dim"]


def _pad_len(n: int, widths) -> int:
    """n rounded up so every solved band's w x w block view tiles evenly."""
    L = 1
    for w in widths:
        if w > 0:
            L = L * w // math.gcd(L, w)
    return -(-n // L) * L


def _mv(band, x, w):
    """Banded matvec over rows, batched: band (..., npad, 2w+1), x (...,
    npad, B); the reference's shift-multiply order with zero fill."""
    npad = x.shape[-2]
    acc = torch.zeros_like(x)
    for m in range(-w, w + 1):
        sh = torch.zeros_like(x)
        k = max(npad - abs(m), 0)
        if m >= 0:
            sh[..., :k, :] = x[..., npad - k:, :]
        else:
            sh[..., npad - k:, :] = x[..., :k, :]
        acc = acc + band[..., :, w + m, None] * sh
    return acc


def _gather(x, idx):
    """x[..., idx[i], :] over rows: x (..., npad, B), idx (..., npad)."""
    return torch.gather(x, -2, idx.long()[..., :, None].expand(x.shape))


def _solve_sym(band, rhs, w):
    """Symmetric-bandwidth banded solve over a (G, npad, .) batch: block CR,
    or division when w == 0."""
    if w == 0:
        return rhs / band[..., :, :1]
    nb = band.shape[-2] // w
    x, _ = cr_solve_values(band, rhs, w=w, nb=nb,
                           steps=max(0, (nb - 1).bit_length()))
    return x


def _block_solve_dim(saphi, phi, sort_idx, rank_idx, s2, r, *, w_p, w_s):
    """(Khat^{-1} + s^{-2} I)^{-1} r = s^2 P^T SAPhi^{-1} Phi P r, for all
    dims at once (leading D axis)."""
    rs = _gather(r, sort_idx)
    y = _mv(phi, rs, w_p)
    xw = s2 * _solve_sym(saphi, y, w_s)
    return _gather(xw, rank_idx)


class FusedSweep:
    """Padded factor stack + static widths for the whole-solve kernel.

    ``phi``/``saphi``/``a`` are (D, n, 2w+1) band stacks with symmetric
    half-widths ``w_p``/``w_s``/``w_a``; ``sort_idx``/``rank_idx`` (D, n)
    permutations; ``sigma2`` the noise variance. Bands get identity tails,
    permutations self-mapping tails (int32, as the kernel reads them).
    """

    def __init__(self, phi, saphi, sort_idx, rank_idx, sigma2, *, w_p: int,
                 w_s: int, a=None, w_a: int = 0):
        D, n = sort_idx.shape
        self.D, self.n = D, n
        self.w_a, self.w_p, self.w_s = w_a, w_p, w_s
        self.npad = _pad_len(n, (w_p, w_s))
        self.dtype = saphi.dtype
        self.device = saphi.device
        self.phi = self._pad_band(phi, w_p)
        self.saphi = self._pad_band(saphi, w_s)
        self.a = None if a is None else self._pad_band(a, w_a)
        self.sort_idx = self._pad_idx(sort_idx)
        self.rank_idx = self._pad_idx(rank_idx)
        self.sigma2 = torch.as_tensor(sigma2, dtype=self.dtype,
                                      device=self.device).reshape(1)

    def _pad_band(self, data, w):
        out = torch.zeros((self.D, self.npad, 2 * w + 1), dtype=self.dtype,
                          device=self.device)
        out[:, :, w] = 1.0
        out[:, :self.n] = data.to(self.dtype)
        return out

    def _pad_idx(self, idx):
        tail = torch.arange(self.n, self.npad, dtype=torch.int32,
                            device=self.device).expand(self.D, -1)
        return torch.cat([idx.to(torch.int32), tail], dim=1).contiguous()

    def pad_state(self, u):
        """(D, n, B) -> (D, npad, B) with a zero tail."""
        out = torch.zeros((self.D, self.npad) + tuple(u.shape[2:]),
                          dtype=self.dtype, device=self.device)
        out[:, :self.n] = u.to(self.dtype)
        return out

    def unpad(self, u):
        return u[:, :self.n]
