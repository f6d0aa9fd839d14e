"""Backend resolution and dispatch for the banded algebra of the port.

Counterpart of ``repro.kernels.ops``. Backends resolve by the device of the
tensors an op is given:

  * ``"auto"`` (the default) — the hand-written CUDA kernels for CUDA
    tensors, the plain PyTorch versions for CPU tensors;
  * ``"cuda"`` — the CUDA kernels; CPU tensors raise.

A CUDA tensor never reaches a plain version. There are no environment
knobs.

Solve algorithms follow the reference's rule (``resolve_solve_alg``):
block cyclic reduction ("cr") when ``lo == hi >= 1``, the LU kernel ("lu")
otherwise. ``pivot=True`` runs the pivoted block-CR mode on the "cr" route
and the pivoted banded LU (``banded_lu_pivot``, the reference's gbsv-style
scan) on the "lu" route where ``lo >= 1``; with ``lo == 0`` nothing can
pivot and the LU kernel runs.

A band solved many times keeps its block-CR factor: ``banded_factor``
makes it once (one factor launch on CUDA tensors) where the route is "cr",
and ``factor_solve`` solves from it (one apply launch), with the bits of
``banded_solve``.

How a backfitting solve fuses (``resolve_fused``) follows the reference's
rules without its VMEM model: the per-iteration kernels ("on") or the
whole-solve kernels ("whole") need symmetric bands of half-width at most
the kernels' ``MAX_WIDTH`` (4, so every q), block CR and the block
preconditioner; "off" runs the unfused host loops. ``kp_gram`` assembles the Kernel Packet
Gram band (Algorithm 2) without forming K.

Capacity padding: every op takes ``n_active`` (a 0-d int32 tensor on the
operands' device, or None when fully active). As the reference's wrappers
do, the band is canonicalized (identity tail) and the right-hand side
masked (zero tail) *before* the launch, so the kernels see a decoupled
identity tail and take no new argument.
"""
from __future__ import annotations

import dataclasses

import torch

from ..masking import canonical_band, mask_rows

__all__ = ["BACKENDS", "SOLVE_ALGS", "PRECOND_MODES", "FUSED_MODES",
           "KMG_AUTO_MIN_N", "resolve_backend", "resolve_solve_alg",
           "resolve_precond", "resolve_fused",
           "banded_matvec", "banded_solve", "banded_logdet",
           "BandFactor", "banded_factor", "factor_solve",
           "band_band_matmul", "kp_gram"]

BACKENDS = ("auto", "cuda")
SOLVE_ALGS = ("auto", "lu", "cr")
PRECOND_MODES = ("auto", "none", "kmg")
FUSED_MODES = ("auto", "on", "whole", "off")

# the reference's "auto" precond gate: kernel multigrid at q == 0 from this n
KMG_AUTO_MIN_N = 4096


def resolve_backend(backend: str | None, device) -> str:
    """"cuda" (launch the kernel) or "plain" (run the plain version) for an
    op on tensors that live on ``device``."""
    b = "auto" if backend is None else backend
    if b not in BACKENDS:
        raise ValueError(f"unknown backend {b!r}; expected one of {BACKENDS}")
    kind = (device if isinstance(device, torch.device)
            else torch.device(device)).type
    if kind == "cuda":
        return "cuda"
    if kind != "cpu":
        raise ValueError(f"unsupported device {device!r}")
    if b == "cuda":
        raise ValueError("backend='cuda' needs CUDA tensors; got CPU tensors")
    return "plain"


def resolve_solve_alg(alg: str | None, lo: int, hi: int) -> str:
    """"cr" (block cyclic reduction) or "lu" for a (lo, hi) band."""
    a = "auto" if alg is None else alg
    if a not in SOLVE_ALGS:
        raise ValueError(
            f"unknown solve alg {a!r}; expected one of {SOLVE_ALGS}")
    if a == "auto":
        return "cr" if lo == hi and lo > 0 else "lu"
    if a == "cr" and lo == hi == 0:
        return "lu"  # diagonal: the LU kernel is loop-free there
    if a == "cr" and lo != hi:
        raise ValueError(
            f"solve alg 'cr' requires a symmetric bandwidth (lo == hi); "
            f"got lo={lo}, hi={hi}")
    return a


def resolve_precond(precond: str | None, *, q: int, n: int) -> str:
    """"none" | "kmg"; "auto" enables kmg at q == 0 and n >= KMG_AUTO_MIN_N."""
    p = "auto" if precond is None else precond
    if p not in PRECOND_MODES:
        raise ValueError(
            f"unknown precond mode {p!r}; expected one of {PRECOND_MODES}")
    if p == "auto":
        return "kmg" if q == 0 and n >= KMG_AUTO_MIN_N else "none"
    return p


def resolve_fused(fused: str | None, *, widths, cr_ok: bool = True,
                  precond: str = "none") -> str:
    """How a backfitting solve fuses: "whole" | "on" | "off".

    ``widths``: the (lo, hi) pairs of every band the sweep touches; ``cr_ok``
    is False when the solve alg forbids block CR (the only solve the fused
    kernels run). An explicit "on"/"whole" raises ``ValueError`` on
    asymmetric bands, a half-width above the fused kernels' ``MAX_WIDTH``,
    a CR conflict or ``precond="kmg"``. "auto" takes "whole" when the bands
    are symmetric and narrow enough, CR is allowed and the preconditioner
    is not kmg, and "off" otherwise (as the reference's "auto" runs
    unfused where its fused kernels cannot take the shape).
    """
    from .fused_sweep import MAX_WIDTH

    f = "auto" if fused is None else fused
    if f not in FUSED_MODES:
        raise ValueError(
            f"unknown fused mode {f!r}; expected one of {FUSED_MODES}")
    if f == "off":
        return "off"
    symmetric = all(lo == hi for lo, hi in widths)
    narrow = all(max(lo, hi) <= MAX_WIDTH for lo, hi in widths)
    if f in ("on", "whole"):
        if not symmetric:
            raise ValueError(
                f"fused={f!r} requires symmetric bandwidths (lo == hi) on "
                f"every factor; got {tuple(widths)}")
        if not narrow:
            raise ValueError(
                f"fused={f!r} takes half-widths <= {MAX_WIDTH} (the fused "
                f"kernels' widths); got {tuple(widths)}: use fused='off' "
                "or 'auto'")
        if not cr_ok:
            raise ValueError(
                f"fused={f!r} conflicts with solve alg 'lu': the fused "
                "kernels solve via block cyclic reduction only")
        if precond == "kmg":
            raise ValueError(
                f"fused={f!r} is incompatible with precond='kmg': the fused "
                "pcg kernels hard-code the block preconditioner")
        return f
    if not symmetric or not narrow or not cr_ok or precond == "kmg":
        return "off"
    return "whole"


def _flatten_batch(arrs, core_dims):
    """Broadcast leading batch dims and flatten them to one G axis."""
    batch = torch.broadcast_shapes(
        *[a.shape[:-d] for a, d in zip(arrs, core_dims)])
    flats = [a.expand(batch + a.shape[-d:]).reshape((-1,) + a.shape[-d:])
             .contiguous() for a, d in zip(arrs, core_dims)]
    return batch, flats


def _route(alg: str | None, lo: int, hi: int, pivot: bool) -> str:
    """"cr", "lu_pivot" (the pivoted banded LU) or "lu" for a solve or
    log-determinant of a (lo, hi) band."""
    if resolve_solve_alg(alg, lo, hi) == "cr":
        return "cr"
    return "lu_pivot" if pivot and lo > 0 else "lu"


def banded_matvec(band, x, lo: int, hi: int, backend: str | None = None,
                  n_active=None):
    """y = M x. band (..., n, lo+hi+1); x (..., n) or (..., n, k)."""
    from .banded_matvec import banded_matvec as matvec_kernel

    n = band.shape[-2]
    mat_form = x.ndim >= 2 and x.shape[-2] == n and x.ndim == band.ndim
    if n_active is not None:
        band = canonical_band(band, lo, hi, n_active)
        x = mask_rows(x, n_active, axis=-2 if mat_form else -1)
    xb = x if mat_form else x[..., None]
    batch, (bf, xf) = _flatten_batch((band, xb), (2, 2))
    out = matvec_kernel(bf, xf, lo, hi, backend=backend)
    out = out.reshape(batch + out.shape[-2:])
    return out if mat_form else out[..., 0]


def banded_solve(band, rhs, lo: int, hi: int, pivot: bool = False,
                 backend: str | None = None, alg: str | None = None,
                 n_active=None):
    """Solve M x = rhs. band (..., n, w); rhs (..., n) or (..., n, k)."""
    from .banded_lu import banded_lu, banded_lu_pivot
    from .block_cr import block_cr_solve

    route = _route(alg, lo, hi, pivot)
    n = band.shape[-2]
    vec_in = rhs.shape[-1] == n and rhs.ndim == band.ndim - 1
    if n_active is not None:
        band = canonical_band(band, lo, hi, n_active)
        rhs = mask_rows(rhs, n_active, axis=-1 if vec_in else -2)
    rb = rhs[..., None] if vec_in else rhs
    batch, (bf, rf) = _flatten_batch((band, rb), (2, 2))
    if route == "cr":
        x = block_cr_solve(bf, rf, lo, pivot=pivot, backend=backend)
    elif route == "lu_pivot":
        x, _ = banded_lu_pivot(bf, rf, lo, hi, backend=backend, logdet=False)
    else:
        x, _ = banded_lu(bf, rf, lo, hi, backend=backend, logdet=False)
    out = x.reshape(batch + x.shape[-2:])
    return out[..., 0] if vec_in else out


def banded_logdet(band, lo: int, hi: int, pivot: bool = False,
                  backend: str | None = None, alg: str | None = None,
                  n_active=None):
    """log |det M|, batched over the leading dims of band; a canonical
    padding tail adds exactly log|I| = 0."""
    from .banded_lu import banded_lu, banded_lu_pivot
    from .block_cr import block_cr_logdet

    band = canonical_band(band, lo, hi, n_active)
    route = _route(alg, lo, hi, pivot)
    batch, (bf,) = _flatten_batch((band,), (2,))
    if route == "cr":
        ld = block_cr_logdet(bf, lo, pivot=pivot, backend=backend)
    elif route == "lu_pivot":
        _, ld = banded_lu_pivot(bf, None, lo, hi, backend=backend,
                                solve=False)
    else:
        _, ld = banded_lu(bf, None, lo, hi, backend=backend, solve=False)
    return ld.reshape(batch)


@dataclasses.dataclass(frozen=True)
class BandFactor:
    """The block-CR factor of a stack of symmetric bands (``kernels.block_cr``
    layout, of the bands identity-padded to whole w x w blocks): ``data``
    (G, cr_factor_size(nb, w)) over the flattened ``batch``, the bands' n,
    half-width w and the pivot mode it was made for; ``n_active`` the
    padded bands' active count (their canonical form was factored), by
    which :func:`factor_solve` masks the right-hand side."""

    data: torch.Tensor
    batch: tuple
    n: int
    w: int
    pivot: bool
    n_active: torch.Tensor | None = None


def banded_factor(band, lo: int, hi: int, pivot: bool = False,
                  backend: str | None = None, alg: str | None = None,
                  n_active=None):
    """The block-CR factor of band (..., n, lo+hi+1) (canonicalized by
    ``n_active``) where the solve route is "cr" (lo == hi >= 1, ``alg``
    permitting), else None: a diagonal band divides and the LU route keeps
    no factor."""
    from .block_cr import block_cr_factor, pad_band

    if resolve_solve_alg(alg, lo, hi) != "cr":
        return None
    band = canonical_band(band, lo, hi, n_active)
    batch, (bf,) = _flatten_batch((band,), (2,))
    data = block_cr_factor(pad_band(bf, lo), lo, pivot=pivot,
                           backend=backend)
    return BandFactor(data, tuple(batch), band.shape[-2], lo, pivot,
                      n_active)


def factor_solve(factor: BandFactor, rhs, backend: str | None = None):
    """Solve with the bands of a :class:`BandFactor`; rhs (..., n) or
    (..., n, k) over the factor's batch, as :func:`banded_solve` takes it,
    with its bits."""
    from .block_cr import block_cr_apply, pad_rows

    n = factor.n
    vec_in = rhs.ndim == len(factor.batch) + 1 and rhs.shape[-1] == n
    rb = rhs[..., None] if vec_in else rhs
    rb = mask_rows(rb, factor.n_active, axis=-2)
    rf = rb.expand(factor.batch + rb.shape[-2:]).reshape(
        (-1,) + rb.shape[-2:]).contiguous()
    npad = -(-n // factor.w) * factor.w
    x = block_cr_apply(factor.data, pad_rows(rf, npad), factor.w,
                       pivot=factor.pivot, backend=backend)[:, :n]
    out = x.reshape(factor.batch + x.shape[-2:])
    return out[..., 0] if vec_in else out


def band_band_matmul(a_band, b_band, a_lo: int, a_hi: int, b_lo: int,
                     b_hi: int, backend: str | None = None, n_active=None):
    """C = A @ B in band form; returns band data (..., n, wa + wb - 1),
    masked to in-range entries. Canonical padded operands multiply to
    ``blockdiag(C_active, I)``."""
    from ..core.banded import _band_mask
    from .band_matmul import band_matmul

    a_band = canonical_band(a_band, a_lo, a_hi, n_active)
    b_band = canonical_band(b_band, b_lo, b_hi, n_active)
    batch, (af, bf) = _flatten_batch((a_band, b_band), (2, 2))
    out = band_matmul(af, bf, a_lo, a_hi, b_lo, b_hi, backend=backend)
    out = out.reshape(batch + out.shape[-2:])
    n = a_band.shape[-2]
    return out * _band_mask(n, a_lo + b_lo, a_hi + b_hi, device=out.device)


def kp_gram(q: int, omega, xs, a_band, block: int = 512,
            backend: str | None = None):
    """Fused Phi = A K band assembly (Algorithm 2): xs (n,) sorted, a_band
    (n, 2q+3) -> Phi band (n, 2q+1). ``block`` is the reference's TPU row
    tile; it is accepted for the reference's signature and ignored (the
    CUDA kernel tiles by its own thread block)."""
    from .kp_gram import kp_gram as kp_gram_kernel

    del block
    return kp_gram_kernel(q, omega, xs, a_band, backend=backend)
