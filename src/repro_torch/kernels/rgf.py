"""RGF block-tridiagonal inverse recurrences: CUDA kernel and plain version.

Counterpart of ``repro.kernels.rgf.rgf_blocks_pallas``: the forward Schur
recurrence ``F_j = D_j - L_j F_{j-1}^{-1} U_{j-1}``, the backward one
``W_j = D_j - U_j W_{j+1}^{-1} L_{j+1}``, then ``G_jj = (F_j + W_j -
D_j)^{-1}``, ``G_{j,j+1} = -F_j^{-1} U_j G_{j+1,j+1}`` and ``G_{j+1,j} =
-W_{j+1}^{-1} L_{j+1} G_jj``. The block partition and band extraction
around it (``core.band_inverse._to_blocks`` / ``_blocks_to_band``) stay
plain torch, as in the reference.
"""
from __future__ import annotations

import torch

from . import _build
from .ops import resolve_backend

__all__ = ["rgf_blocks", "rgf_blocks_plain", "rgf_inverse_band"]

BLOCKS = (1, 2, 3, 4, 5, 7)  # the kernel's block sizes (csrc/rgf.cu)


def _mm(a, b):
    """(..., w, w) @ (..., w, w) with a fixed-association k loop."""
    out = a[..., :, 0:1] * b[..., 0:1, :]
    for k in range(1, a.shape[-1]):
        out = out + a[..., :, k:k + 1] * b[..., k:k + 1, :]
    return out


def rgf_blocks_plain(Dg, U, L):
    """(G, T, w, w) x3 -> (Gd, Gu, Gl); Gu[j] = G_{j,j+1}, Gl[j] = G_{j+1,j}
    (last entries zero). Sequential loops in T over batched w x w blocks."""
    G, T, w, _ = Dg.shape
    F = torch.empty_like(Dg)
    W = torch.empty_like(Dg)
    F[:, 0] = Dg[:, 0]
    for j in range(1, T):
        F[:, j] = Dg[:, j] - _mm(L[:, j], torch.linalg.solve(F[:, j - 1],
                                                             U[:, j - 1]))
    W[:, T - 1] = Dg[:, T - 1]
    for j in range(T - 2, -1, -1):
        W[:, j] = Dg[:, j] - _mm(U[:, j], torch.linalg.solve(W[:, j + 1],
                                                             L[:, j + 1]))
    eye = torch.eye(w, dtype=Dg.dtype, device=Dg.device).expand_as(Dg)
    Gd = torch.linalg.solve(F + W - Dg, eye)
    Gu = torch.zeros_like(Dg)
    Gl = torch.zeros_like(Dg)
    if T > 1:
        Gu[:, :-1] = -torch.linalg.solve(F[:, :-1], _mm(U[:, :-1], Gd[:, 1:]))
        Gl[:, :-1] = -torch.linalg.solve(W[:, 1:], _mm(L[:, 1:], Gd[:, :-1]))
    return Gd, Gu, Gl


def rgf_blocks(Dg, U, L, backend: str | None = None):
    """(G, T, w, w) float64 block stacks -> (Gd, Gu, Gl) of the inverse.
    CUDA tensors launch ``csrc/rgf.cu``."""
    if resolve_backend(backend, Dg.device) == "plain":
        return rgf_blocks_plain(Dg, U, L)
    G, T, w, _ = Dg.shape
    if w not in BLOCKS:
        raise ValueError(f"rgf kernel takes block sizes {BLOCKS}, got {w}")
    dev = Dg.device
    for t, name in ((Dg, "Dg"), (U, "U"), (L, "L")):
        _build.expect(t, name, torch.float64, (G, T, w, w), dev)
    Gd, Gu, Gl, F, W = (torch.empty_like(Dg) for _ in range(5))
    lib = _build.load_library()
    err = lib.repro_rgf_blocks_f64(
        Dg.data_ptr(), U.data_ptr(), L.data_ptr(), Gd.data_ptr(),
        Gu.data_ptr(), Gl.data_ptr(), F.data_ptr(), W.data_ptr(), G, T, w,
        _build.stream_handle(dev))
    _build.check(err, "rgf_blocks")
    _build.count_launch("rgf_blocks")
    return Gd, Gu, Gl


def rgf_inverse_band(data, lo: int, hi: int, hw: int,
                     backend: str | None = None):
    """Band (half-bw ``hw``) of H^{-1}; ``data`` (..., n, lo+hi+1)."""
    from ..core.band_inverse import _blocks_to_band, _to_blocks

    n = data.shape[-2]
    w = max(lo, hi, hw, 1)
    batch = data.shape[:-2]
    flat = data.reshape((-1,) + data.shape[-2:])
    Dg, U, L = _to_blocks(flat, lo, hi, w)
    Gd, Gu, Gl = rgf_blocks(Dg.contiguous(), U.contiguous(), L.contiguous(),
                            backend=backend)
    band = _blocks_to_band(Gd, Gu, Gl, n, hw)
    return band.reshape(batch + band.shape[-2:])
