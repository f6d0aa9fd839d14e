"""Additive-GP core: the serving path and hyperparameter learning of the
paper's Sec. 5 (``fit(capacity=)`` / ``with_capacity`` for the
capacity-padded form); Bayesian optimisation (Sec. 6) in
``core.bayesopt``, the streaming updates in ``repro_torch.streaming``."""
from .additive_gp import (GPConfig, AdditiveGP, fit, fit_hyperparams,
                          log_likelihood, mll_gradients, posterior_mean,
                          posterior_mean_grad, posterior_var, prior_var,
                          with_capacity)
from .convert import gp_from_arrays

__all__ = ["GPConfig", "AdditiveGP", "fit", "posterior_mean", "posterior_var",
           "posterior_mean_grad", "prior_var", "log_likelihood",
           "mll_gradients", "fit_hyperparams", "gp_from_arrays",
           "with_capacity"]
