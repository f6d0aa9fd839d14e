"""Build the port's ``AdditiveGP`` from a fitted GP's arrays.

``gp_from_arrays`` takes the fields of a GP fitted elsewhere (for example by
the JAX package) as numpy arrays, so that queries can be compared on
identical factors. Keys:

  * ``X`` (n, D), ``Y`` (n,), ``omega`` (D,), ``sigma`` (), ``xs`` (D, n),
    ``sort_idx`` / ``rank_idx`` (D, n), ``bY`` / ``u_sy`` (D, n);
  * for each band ``N`` in ``A, Phi, SAPhi, B, Psi, Gband, Hband``: the data
    ``N`` (D, n, lo+hi+1) with its half-widths ``N_lo`` and ``N_hi``;
  * optionally ``n_active`` (): a capacity-padded GP, whose arrays are taken
    as they are (n is then the capacity).

The GP carries no health state (no solve ran here). When the config
resolves to ``precond="kmg"`` the coarse hierarchy is rebuilt from the
carried factors (``build_gp_hier``: band assembly, no solve).

``fleet_from_arrays`` takes the same keys with a leading tenant axis on
every array (a JAX ``GPFleet``'s stacked leaves, ``n_active`` (T,)) and
returns the port's ``GPFleet``, with zeroed health scalars.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..health.verdict import HealthState
from .additive_gp import AdditiveGP, GPConfig, build_gp_hier, resolve_config
from .backfitting import DimOps
from .banded import Banded

__all__ = ["gp_from_arrays", "fleet_from_arrays", "BAND_KEYS"]

BAND_KEYS = ("A", "Phi", "SAPhi", "B", "Psi", "Gband", "Hband")


def gp_from_arrays(arrays: dict[str, np.ndarray], config: GPConfig,
                   device) -> AdditiveGP:
    device = torch.device(device)

    def t(key, dtype=torch.float64):
        return torch.as_tensor(np.array(arrays[key])).to(device=device,
                                                           dtype=dtype)

    X = t("X")
    lead = tuple(X.shape[:-2])
    na = (t("n_active", torch.int32).reshape(lead)
          if arrays.get("n_active") is not None else None)

    def band(key):
        return Banded(t(key), int(arrays[f"{key}_lo"]),
                      int(arrays[f"{key}_hi"]), na)

    # the precond rule reads the point count the GP was fitted at
    config = resolve_config(
        config, X.shape[-2] if na is None else int(np.max(
            arrays["n_active"])), device)
    sigma = t("sigma").reshape(lead)
    ops = DimOps(A=band("A"), Phi=band("Phi"), SAPhi=band("SAPhi"),
                 sort_idx=t("sort_idx", torch.int64),
                 rank_idx=t("rank_idx", torch.int64), sigma2=sigma ** 2,
                 pivot=config.pivot, alg=config.solve_alg, n_active=na)
    omega, xs = t("omega"), t("xs")
    return AdditiveGP(X=X, Y=t("Y"), omega=omega, sigma=sigma, xs=xs,
                      ops=ops, B=band("B"), Psi=band("Psi"), bY=t("bY"),
                      u_sy=t("u_sy"), Gband=band("Gband"), config=config,
                      Hband=band("Hband"), health=None,
                      hier=build_gp_hier(config, omega, sigma, X, xs, ops),
                      n_active=na)


def fleet_from_arrays(arrays: dict[str, np.ndarray], config: GPConfig,
                      device):
    """A ``GPFleet`` from a fleet's stacked arrays (:func:`gp_from_arrays`'
    keys, each with a leading tenant axis; ``n_active`` (T,) required)."""
    from .fleet import GPFleet

    if arrays.get("n_active") is None:
        raise ValueError("a fleet's arrays carry n_active (T,)")
    gp = gp_from_arrays(arrays, config, device)
    if gp.config.health == "on":
        # zeroed per-tenant scalars, the state a mutation of a health-less
        # GP starts from, so masked rounds have a state to keep
        gp = dataclasses.replace(gp, health=HealthState.fresh(
            gp.Y.dtype, gp.device, gp.lead))
    return GPFleet(gp=gp)
