"""Multi-tenant posterior fleet: T independent GPs served as one stack.

Counterpart of ``repro.core.fleet``. A :class:`GPFleet` stacks ``T``
capacity-padded :class:`AdditiveGP` s along a leading *tenant* axis: every
tensor gains a ``(T, ...)`` axis (``n_active`` becomes the ``(T,)``
per-tenant active count, ``sigma`` ``(T,)``), while the ``GPConfig``, D and
the capacity are shared. The core ops take that axis as a batch:

  * plain-torch glue (sorting, the KP window SVDs, splices, gathers,
    masks) runs over ``(T, D, ...)`` tensors at once, with every reduction
    inside a tenant;
  * the banded kernels fold the tenants into their batch (``T x D`` bands
    in one launch: ``banded_lu``, ``band_matmul``, ``rgf_blocks``, the
    block-CR factor and apply);
  * a fused backfitting solve ("whole" or "on") is one launch for the
    whole fleet: ``csrc/mega_pcg.cu``, ``jacobi.cu`` or ``gauss_seidel.cu``
    over the tenant axis (the single GP's kernel, counted as
    ``mega_pcg_fleet``, ``mega_jacobi_fleet``, ... when T > 1), with
    per-tenant sigma^2, cross-dimension totals, inner products and
    (tol > 0) exits; an unfused one ("off", and kmg, the "auto" choice at
    q = 0 and n >= 4096) is the host loop over the stack, the kmg
    hierarchy built once for the fleet (``precond.coarse``).

So the launches and host syncs of a fleet op do not grow with T. Each
tenant's result equals the same call on its unstacked GP: bit for bit on
the CPU (the plain versions run tenant by tenant), and on the card to the
rounding of batched library calls (``PERF.md``). A one-tenant stack
makes the single GP's launches, with its bits. Fleets take every solver,
fused mode and preconditioner that a single GP takes.

The per-tenant mutations (``fleet_insert``, ``fleet_evict``,
``fleet_resync``) live in ``repro_torch.streaming.updates`` and the
tiered multi-tenant server in ``repro_torch.streaming.fleet_engine``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..health.verdict import HealthState
from ..kernels.ops import BandFactor
from ..masking import lead_count
from ..precond.coarse import CoarseLevel, pad_restriction
from .additive_gp import (AdditiveGP, GPConfig, _as_f64, _fit_core,
                          posterior_mean, posterior_var, resolve_config,
                          resolve_device, with_capacity)
from .backfitting import DimOps
from .banded import Banded
from .bayesopt import acquisition_stats

__all__ = ["GPFleet", "stack_gps", "fleet_fit", "fleet_posterior_mean",
           "fleet_posterior_var", "fleet_acquisition_stats", "tenant_gp",
           "set_tenant_gp", "select_tenants", "replicate_gp", "tree_map"]


def _lead_view(f: BandFactor):
    """A factor's data viewed ``batch + (size,)``, its tenant axis first
    (data that is not a tensor, or is so viewed already, as it is)."""
    d = f.data
    if torch.is_tensor(d) and tuple(d.shape[:-1]) != f.batch:
        return d.reshape(f.batch + d.shape[-1:])
    return d


def tree_map(fn, *objs):
    """``fn`` over the tensors of one or more GPs of one structure (the
    same fields set), rebuilding the GP: ``GPFleet``, ``AdditiveGP``, its
    ``DimOps`` (its block-CR factors mapped over their (tenant, dimension)
    batch, no new factor made), its kmg hierarchy (a tuple of
    ``CoarseLevel``, whose restriction maps are first widened to their
    common width, ``pad_restriction``), ``Banded``, ``HealthState``, dicts,
    lists, tuples, tensors; configs, widths and flags pass through from the
    first. Every tensor ``fn`` sees is tenant-first. The dataclasses are
    rebuilt field by field, not through their constructors, so ``fn`` may
    return what is not a plain tensor (a ``distributed.sharding.Sharding``,
    an axes tuple, a ``DTensor``); a factor whose mapped data is not a plain
    tensor keeps it in the tenant-first view."""
    o = objs[0]
    if o is None:
        return None
    if torch.is_tensor(o):
        return fn(*objs)
    if isinstance(o, BandFactor):
        data = fn(*(_lead_view(f) for f in objs))
        batch = tuple(data.shape[:-1]) if torch.is_tensor(data) else o.batch
        if type(data) is torch.Tensor:
            data = data.reshape((-1,) + data.shape[-1:])
        return BandFactor(data, batch, o.n, o.w, o.pivot,
                          tree_map(fn, *(f.n_active for f in objs)))
    if isinstance(o, CoarseLevel) and all(torch.is_tensor(x.r_idx)
                                          for x in objs):
        K = max(x.r_idx.shape[-1] for x in objs)
        objs = [pad_restriction(x, K) for x in objs]
        o = objs[0]
    if isinstance(o, (GPFleet, AdditiveGP, DimOps, Banded, HealthState,
                      CoarseLevel)):
        new = object.__new__(type(o))
        for f in dataclasses.fields(o):
            object.__setattr__(new, f.name, tree_map(
                fn, *(getattr(x, f.name) for x in objs)))
        if isinstance(o, DimOps):
            # a factor made for the DimOps' own count keeps that one object,
            # as DimOps makes it (FusedSweep takes a factor whose count it is)
            for name in ("phi_factor", "saphi_factor"):
                f_old, f_new = getattr(o, name), getattr(new, name)
                if f_old is not None and f_old.n_active is o.n_active:
                    object.__setattr__(new, name, dataclasses.replace(
                        f_new, n_active=new.n_active))
        return new
    if isinstance(o, dict):
        return {k: tree_map(fn, *(x[k] for x in objs)) for k in o}
    if isinstance(o, tuple):
        return tuple(tree_map(fn, *parts) for parts in zip(*objs))
    if isinstance(o, list):
        return [tree_map(fn, *parts) for parts in zip(*objs)]
    return o


@dataclasses.dataclass(frozen=True)
class GPFleet:
    """Stacked fleet: an ``AdditiveGP`` whose every tensor carries a leading
    ``(T,)`` tenant axis (``n_active``: the ``(T,)`` per-tenant counts)."""

    gp: AdditiveGP

    @property
    def T(self) -> int:
        return self.gp.X.shape[0]

    @property
    def capacity(self) -> int:
        return self.gp.X.shape[1]

    @property
    def D(self) -> int:
        return self.gp.X.shape[2]

    @property
    def config(self) -> GPConfig:
        return self.gp.config

    def counts(self) -> np.ndarray:
        """Per-tenant active observation counts (one device read)."""
        return self.gp.n_active.cpu().numpy()

    def tenant(self, i: int) -> AdditiveGP:
        """Tenant ``i`` as a standalone capacity-padded GP."""
        return tenant_gp(self.gp, i)


def tenant_gp(stack: AdditiveGP, lane: int) -> AdditiveGP:
    """One tenant's GP out of a stacked fleet (views of the stack)."""
    return tree_map(lambda a: a[lane], stack)


def set_tenant_gp(stack: AdditiveGP, gp: AdditiveGP,
                  lane: int) -> AdditiveGP:
    """A copy of the stack with ``gp`` (of the stack's capacity) written
    into lane ``lane``."""
    def put(a, b):
        out = a.clone()
        out[lane] = b
        return out

    return tree_map(put, stack, gp)


def replicate_gp(gp: AdditiveGP, T: int) -> AdditiveGP:
    """One capacity-padded GP broadcast into a ``T``-lane stack."""
    if gp.n_active is None:
        gp = with_capacity(gp, gp.n)
    return tree_map(lambda a: a[None].expand((T,) + a.shape).contiguous(),
                    gp)


def select_tenants(do, new_stack: AdditiveGP, old_stack: AdditiveGP):
    """Per-lane select: lane t takes ``new`` where ``do[t]``. A
    ``torch.where`` (a select, not arithmetic), so nothing computed in a
    discarded lane, NaN included, reaches a kept one."""
    do = torch.as_tensor(do, dtype=torch.bool,
                         device=old_stack.device)
    return tree_map(lambda a, b: torch.where(lead_count(do, a.ndim), a, b),
                    new_stack, old_stack)


def stack_gps(gps, capacity: int | None = None) -> GPFleet:
    """Stack fitted GPs into one fleet. All tenants share D, the device
    and the (resolved) ``GPConfig``; they are re-homed to a common capacity
    first (the largest, or ``capacity``): pure padding, so each tenant's
    stacked state equals its standalone state bit for bit on the active
    prefix."""
    gps = list(gps)
    if not gps:
        raise ValueError("stack_gps needs at least one GP")
    cap = max(g.n for g in gps)
    if capacity is not None:
        if capacity < cap:
            raise ValueError(
                f"capacity {capacity} < largest tenant allocation {cap}")
        cap = capacity
    cfg0 = gps[0].config
    for g in gps:
        if g.config != cfg0:
            raise ValueError("all fleet tenants must share one GPConfig; "
                             f"got {g.config} vs {cfg0}")
        if g.D != gps[0].D or g.device != gps[0].device:
            raise ValueError("all fleet tenants must share D and device")
    padded = [with_capacity(g, cap) for g in gps]
    return GPFleet(gp=tree_map(lambda *ts: torch.stack(ts), *padded))


def fleet_fit(config: GPConfig, X, Y, omega, sigma, capacity: int,
              device=None) -> GPFleet:
    """Fit ``T`` tenants at once: X (T, n, D), Y (T, n), omega (T, D) (or
    (D,), broadcast), sigma (T,) or a scalar. Each tenant's fit equals
    ``fit(config, X[t], Y[t], omega[t], sigma[t], capacity=capacity)``;
    the config is resolved once, as ``fit`` resolves it. Runs on CUDA
    unless ``device`` says otherwise (``fit``'s device rule)."""
    device = resolve_device(device)
    X = _as_f64(X, device)
    T, n, D = X.shape
    if capacity < n:
        raise ValueError(f"capacity {capacity} < n {n}")
    config = resolve_config(config, n, device)
    Y = _as_f64(Y, device).reshape(T, n)
    omega = _as_f64(omega, device).expand(T, D).contiguous()
    sigma = _as_f64(sigma, device).reshape(-1).expand(T).contiguous()
    return GPFleet(gp=with_capacity(_fit_core(config, X, Y, omega, sigma),
                                    int(capacity)))


def fleet_posterior_mean(fleet: GPFleet, Xq, device=None):
    """Per-tenant posterior means: Xq (T, m, D) -> (T, m)."""
    return posterior_mean(fleet.gp, Xq, device=device)


def fleet_posterior_var(fleet: GPFleet, Xq, device=None):
    """Per-tenant posterior variances: Xq (T, m, D) -> (T, m)."""
    return posterior_var(fleet.gp, Xq, device=device)


def fleet_acquisition_stats(fleet: GPFleet, Xq, beta, best_y,
                            kind: str = "ucb", device=None):
    """Per-tenant ``(value, grad, mean, variance)``: Xq (T, m, D); ``beta``
    and ``best_y`` scalars, (T,) per tenant, or (T, m) per query."""
    dev = fleet.gp.device

    def per(v):
        v = torch.as_tensor(v, dtype=torch.float64, device=dev)
        return v[..., None] if v.ndim == 1 else v

    return acquisition_stats(fleet.gp, Xq, per(beta), per(best_y), kind=kind,
                             device=device)
