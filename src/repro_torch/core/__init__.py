"""Additive-GP core: the serving path and hyperparameter learning of the
paper's Sec. 5 (``fit(capacity=)`` / ``with_capacity`` for the
capacity-padded form); Bayesian optimisation (Sec. 6) in
``core.bayesopt``, the streaming updates in ``repro_torch.streaming``; the
multi-tenant fleet (T GPs stacked on a leading tenant axis) in
``core.fleet``."""
from .additive_gp import (GPConfig, AdditiveGP, fit, fit_hyperparams,
                          log_likelihood, mll_gradients, posterior_mean,
                          posterior_mean_grad, posterior_var, prior_var,
                          with_capacity)
from .convert import fleet_from_arrays, gp_from_arrays
from .fleet import (GPFleet, fleet_acquisition_stats, fleet_fit,
                    fleet_posterior_mean, fleet_posterior_var, stack_gps)

__all__ = ["GPConfig", "AdditiveGP", "fit", "posterior_mean", "posterior_var",
           "posterior_mean_grad", "prior_var", "log_likelihood",
           "mll_gradients", "fit_hyperparams", "gp_from_arrays",
           "with_capacity", "GPFleet", "fleet_fit", "fleet_posterior_mean",
           "fleet_posterior_var", "fleet_acquisition_stats", "stack_gps",
           "fleet_from_arrays"]
