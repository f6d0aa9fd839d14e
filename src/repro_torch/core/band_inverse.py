"""Central band of the inverse of a banded matrix (paper Algorithm 5).

Counterpart of ``repro.core.band_inverse``: the band of
``G = (A Phi^T)^{-1}`` for the posterior-variance middle term.
``H = A Phi^T`` has half-bandwidth 2q+1; with block size ``w >= 2q+1`` it
is block-tridiagonal, and the diagonal and first off-diagonal blocks of G
cover the 2q+1 band.

The block inverse runs in ``kernels.rgf``: the reference's RGF recurrences
for CPU tensors, the CUDA kernel (block cyclic reduction with selected
inversion) for CUDA tensors; the block partition and band extraction here
are plain gathers.
"""
from __future__ import annotations

import torch

from ..kernels.rgf import rgf_blocks_plain, rgf_inverse_band
from .banded import Banded, band_band_matmul, mask_band, transpose

__all__ = ["inverse_band", "variance_band"]

_rgf = rgf_blocks_plain


def _to_blocks(data, lo: int, hi: int, w: int):
    """(G, n, lo+hi+1) band -> block-tridiagonal (Dg, U, L), each (G, T, w, w).

    Pads n to a multiple of w with an identity tail.
    """
    G, n, width = data.shape
    T = -(-n // w)
    npad = T * w
    dev = data.device
    band = data.new_zeros((G, npad, width))
    band[:, :, lo] = 1.0
    band[:, :n] = data
    i = torch.arange(npad, device=dev)[:, None]
    j = i + torch.arange(-lo, hi + 1, device=dev)[None, :]
    valid = (j >= 0) & (j < npad)
    off = j.clamp(0, npad - 1) - (i // w) * w + w
    ok = valid & (off >= 0) & (off < 3 * w)
    strip = data.new_zeros((G, npad, 3 * w))
    src = torch.where(ok, band, torch.zeros((), dtype=data.dtype, device=dev))
    strip.scatter_add_(2, off.clamp(0, 3 * w - 1).expand(G, -1, -1), src)
    strip = strip.reshape(G, T, w, 3 * w)
    return strip[..., w:2 * w], strip[..., 2 * w:3 * w], strip[..., 0:w]


def _blocks_to_band(Gd, Gu, Gl, n: int, hw: int):
    """Band data (G, n, 2hw+1) (half-bw hw <= w) from the blocks of G."""
    _, T, w, _ = Gd.shape
    npad = T * w
    dev = Gd.device
    rows = torch.arange(npad, device=dev)
    blk = (rows // w)[:, None]
    r_in = (rows % w)[:, None]
    cols = rows[:, None] + torch.arange(-hw, hw + 1, device=dev)[None, :]
    cblk = torch.div(cols, w, rounding_mode="floor")
    cb = (cols % w).clamp(0, w - 1)
    zero = torch.zeros((), dtype=Gd.dtype, device=dev)
    vals = torch.where(
        cblk == blk, Gd[:, blk, r_in, cb],
        torch.where(cblk == blk + 1, Gu[:, blk.clamp(0, T - 1), r_in, cb],
                    torch.where(cblk == blk - 1,
                                Gl[:, (blk - 1).clamp(0, T - 1), r_in, cb],
                                zero)))
    vals = torch.where((cols >= 0) & (cols < n), vals, zero)
    return vals[:, :n]


def inverse_band(H: Banded, hw: int, backend: str | None = None) -> Banded:
    """Band of H^{-1}; batched over the leading dims of H.data.

    Capacity padding: ``H`` is canonicalized to ``blockdiag(H_active, I)``
    first, so the result is ``blockdiag(G_active, I)``: active rows match
    the unpadded inverse, tail rows are identity rows."""
    H = H.canonical()
    return Banded(rgf_inverse_band(H.data, H.lo, H.hi, hw, backend=backend),
                  hw, hw, H.n_active)


def variance_band(A: Banded, Phi: Banded, backend: str | None = None, *,
                  return_h: bool = False):
    """The 2q+1 band of (A Phi^T)^{-1}; ``return_h`` also returns the
    canonical band of H = A Phi^T (the cache the windowed streaming updates
    of ``core.gband_update`` carry)."""
    H = mask_band(band_band_matmul(A, transpose(Phi), backend=backend))
    G = inverse_band(H, A.lo + Phi.lo, backend=backend)
    return (G, H.canonical()) if return_h else G
