"""Additive-GP core: the serving path of the paper's Sec. 5."""
from .additive_gp import (GPConfig, AdditiveGP, fit, posterior_mean,
                          posterior_var, prior_var)
from .convert import gp_from_arrays

__all__ = ["GPConfig", "AdditiveGP", "fit", "posterior_mean", "posterior_var",
           "prior_var", "gp_from_arrays"]
