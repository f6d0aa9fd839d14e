"""Block-tridiagonal band inverse (paper Algorithm 5): CUDA kernel and plain
versions.

Counterpart of ``repro.kernels.rgf.rgf_blocks_pallas``: from the blocks
(D, U, L) of H (``U_j = H_{j,j+1}``, ``L_j = H_{j,j-1}``) the diagonal
blocks ``Gd`` and first off-diagonal blocks ``Gu[j] = G_{j,j+1}``,
``Gl[j] = G_{j+1,j}`` of G = H^{-1} (last entries zero).

Two orders of the same elimination:

* ``rgf_blocks_plain`` — RGF, the reference's order: the forward Schur
  recurrence ``F_j = D_j - L_j F_{j-1}^{-1} U_{j-1}``, the backward one
  ``W_j = D_j - U_j W_{j+1}^{-1} L_{j+1}``, then ``G_jj = (F_j + W_j -
  D_j)^{-1}``, ``G_{j,j+1} = -F_j^{-1} U_j G_{j+1,j+1}`` and ``G_{j+1,j} =
  -W_{j+1}^{-1} L_{j+1} G_jj``. CPU tensors run it: every CPU result and
  every parity test against the JAX package rests on it.
* ``rgf_blocks_cr_plain`` — block cyclic reduction with selected
  inversion, the order ``csrc/rgf.cu`` runs on the card (2 ceil(log2 T)
  levels instead of two chains of T steps), replayed in plain torch for
  the tests and ``chip_smoke.py``; the main path does not call it.

The block partition and band extraction around it
(``core.band_inverse._to_blocks`` / ``_blocks_to_band``) stay plain torch,
as in the reference.
"""
from __future__ import annotations

import torch

from . import _build
from .ops import resolve_backend

__all__ = ["rgf_blocks", "rgf_blocks_plain", "rgf_blocks_cr_plain",
           "rgf_tile_rows", "rgf_inverse_band"]

BLOCKS = (1, 2, 3, 4, 5, 7)  # the kernel's block sizes (csrc/rgf.cu)
# (node, lane) items of a tile's first level, one thread each
# (csrc/rgf.cu TILE_THREADS)
TILE_ITEMS = 128


def rgf_tile_rows(w: int) -> int:
    """Rows P of a tile of the kernel's low levels: the largest power of
    two with (P / 2) w <= TILE_ITEMS, so a tile's first level gives each
    (node, lane) item a thread."""
    p = 2
    while p * w <= TILE_ITEMS:
        p *= 2
    return p


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


def _levels(T: int) -> int:
    """Levels of the reduction: ceil(log2 T)."""
    return max(T - 1, 0).bit_length()


def rgf_blocks_cr_plain(Dg, U, L):
    """(G, T, w, w) x3 -> (Gd, Gu, Gl), as ``rgf_blocks_plain``, in the
    kernel's order: block cyclic reduction of H, then its selected
    inversion top down.

    Level k (stride s = 2^k) eliminates the odd nodes e = s (mod 2s) of the
    nodes still alive (multiples of s): each even node i folds
    ``alpha = -A_i B_{i-s}^{-1}`` and ``beta = -C_i B_{i+s}^{-1}`` in,
    ``B_i += alpha C_{i-s} + beta A_{i+s}``, ``A_i = alpha A_{i-s}``,
    ``C_i = beta C_{i+s}`` (A, B, C start as L, D, U). The odd node keeps
    its blocks and B_e^{-1}, and the couplings of its neighbours to it
    (``Ua_e = C_{e-s}``, ``Lb_e = A_{e+s}``) are saved before they fold.
    The kernel runs levels below log2 P (P = ``rgf_tile_rows(w)``) in
    tiles of P rows: a node on a tile edge (a multiple of P) sums its
    left and its right folds apart and adds both to D at the top, so
    ``B = (D + dL) + dR`` there. With B_0^{-1} = G_00 at the top, each
    level back down gives, from a = e - s and b = e + s (G_ab, G_ba from
    the level above):

        G_ea = -B_e^{-1} (A_e G_aa + C_e G_ba)
        G_eb = -B_e^{-1} (A_e G_ab + C_e G_bb)
        G_ae = -(G_aa Ua_e + G_ab Lb_e) B_e^{-1}
        G_be = -(G_ba Ua_e + G_bb Lb_e) B_e^{-1}
        G_ee = B_e^{-1} - (G_ea Ua_e + G_eb Lb_e) B_e^{-1}

    and at level 0 the G_ea, G_eb, G_ae, G_be are the first off-diagonal
    blocks. Each w x w product has the kernel's fixed k order.
    """
    G, T, w, _ = Dg.shape
    P = rgf_tile_rows(w)
    steps = _levels(T)
    k_tile = min(P.bit_length() - 1, steps)
    dev = Dg.device
    eye = torch.eye(w, dtype=Dg.dtype, device=dev)
    A, B, C = L.clone(), Dg.clone(), U.clone()
    Binv, Ua, Lb, dL, dR = (torch.zeros_like(Dg) for _ in range(5))
    Gd = torch.zeros_like(Dg)
    X = {k: torch.zeros_like(Dg) for k in ("ea", "eb", "ae", "be")}
    ar = lambda *a: torch.arange(*a, device=dev)  # noqa: E731

    def inv(M):
        return torch.linalg.solve(M, eye.expand_as(M))

    def fold(k, tiled):
        s = 1 << k
        odd = ar(s, T, 2 * s)
        Binv[:, odd] = inv(B[:, odd])
        ev = ar(0, T, 2 * s)
        has_l, has_r = ev - s >= 0, ev + s < T
        lft, rgt = ev[has_l], ev[has_r]
        t1, t2 = torch.zeros_like(B[:, ev]), torch.zeros_like(B[:, ev])
        alpha = -_mm(A[:, lft], Binv[:, lft - s])
        beta = -_mm(C[:, rgt], Binv[:, rgt + s])
        t1[:, has_l] = _mm(alpha, C[:, lft - s])
        t2[:, has_r] = _mm(beta, A[:, rgt + s])
        Lb[:, lft - s] = A[:, lft]
        Ua[:, rgt + s] = C[:, rgt]
        A[:, lft] = _mm(alpha, A[:, lft - s])
        C[:, rgt] = _mm(beta, C[:, rgt + s])
        edge = (ev % P == 0) if tiled else torch.zeros_like(has_l)
        Be = B[:, ev] + t1 + t2
        B[:, ev] = torch.where(edge[None, :, None, None], B[:, ev], Be)
        dL[:, ev[edge]] = dL[:, ev[edge]] + t1[:, edge]
        dR[:, ev[edge]] = dR[:, ev[edge]] + t2[:, edge]

    for k in range(k_tile):
        fold(k, True)
    edges = ar(0, T, P)
    B[:, edges] = (Dg[:, edges] + dL[:, edges]) + dR[:, edges]
    for k in range(k_tile, steps):
        fold(k, False)
    Gd[:, 0] = inv(B[:, 0])
    zero = torch.zeros_like(Dg[:, :1])
    for k in range(steps - 1, -1, -1):
        s = 1 << k
        e = ar(s, T, 2 * s)
        a, b = e - s, e + s
        hb = (b < T)[None, :, None, None]
        bc = b.clamp(max=T - 1)
        # G_ab, G_ba: from the odd node of the pair one level up
        a_odd = (a % (4 * s) == 2 * s)[None, :, None, None]
        Gab = torch.where(a_odd, X["eb"][:, a], X["ae"][:, bc])
        Gba = torch.where(a_odd, X["be"][:, a], X["ea"][:, bc])
        Gab, Gba = (torch.where(hb, t, zero) for t in (Gab, Gba))
        Gaa, Gbb = Gd[:, a], torch.where(hb, Gd[:, bc], zero)
        Ae, Ce, Bi, Ue, Le = A[:, e], C[:, e], Binv[:, e], Ua[:, e], Lb[:, e]
        gea = -_mm(Bi, _mm(Ae, Gaa) + _mm(Ce, Gba))
        geb = -_mm(Bi, _mm(Ae, Gab) + _mm(Ce, Gbb))
        gae = -_mm(_mm(Gaa, Ue) + _mm(Gab, Le), Bi)
        gbe = -_mm(_mm(Gba, Ue) + _mm(Gbb, Le), Bi)
        Gd[:, e] = Bi - _mm(_mm(gea, Ue) + _mm(geb, Le), Bi)
        for key, val in (("ea", gea), ("eb", geb), ("ae", gae), ("be", gbe)):
            X[key][:, e] = val
    Gu, Gl = torch.zeros_like(Dg), torch.zeros_like(Dg)
    e = ar(1, T, 2)
    Gl[:, e - 1], Gu[:, e - 1] = X["ea"][:, e], X["ae"][:, e]
    Gu[:, e], Gl[:, e] = X["eb"][:, e], X["be"][:, e]
    return Gd, Gu, Gl


def rgf_blocks(Dg, U, L, backend: str | None = None):
    """(G, T, w, w) float64 block stacks -> (Gd, Gu, Gl) of the inverse.
    CUDA tensors launch ``csrc/rgf.cu`` (the order of
    ``rgf_blocks_cr_plain``: three launches from one call); CPU tensors run
    ``rgf_blocks_plain``."""
    if resolve_backend(backend, Dg.device) == "plain":
        return rgf_blocks_plain(Dg, U, L)
    G, T, w, _ = Dg.shape
    if w not in BLOCKS:
        raise ValueError(f"rgf kernel takes block sizes {BLOCKS}, got {w}")
    dev = Dg.device
    for t, name in ((Dg, "Dg"), (U, "U"), (L, "L")):
        _build.expect(t, name, torch.float64, (G, T, w, w), dev)
    lib = _build.load_library()
    out = torch.empty((3,) + tuple(Dg.shape), dtype=torch.float64,
                      device=dev)
    scratch = torch.empty((lib.repro_rgf_workspace(G, T, w),),
                          dtype=torch.float64, device=dev)
    Gd, Gu, Gl = out.unbind(0)
    err = lib.repro_rgf_blocks_f64(
        Dg.data_ptr(), U.data_ptr(), L.data_ptr(), Gd.data_ptr(),
        Gu.data_ptr(), Gl.data_ptr(), scratch.data_ptr(), G, T, w,
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
