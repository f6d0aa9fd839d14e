"""PyTorch + CUDA port of the additive-GP package ``repro``.

Mirrors ``repro``'s layout module for module and imports nothing of it, nor
JAX. The serving path (``core.fit`` -> ``core.posterior_mean`` ->
``core.posterior_var``) and hyperparameter learning (``core.log_likelihood``
-> ``core.mll_gradients`` -> ``core.fit_hyperparams``), with every
backfitting solver and the kernel-multigrid preconditioner (``precond``),
Bayesian optimisation (``core.bayesopt``) and the streaming updates of a
capacity-padded GP with their serving engine (``streaming``) run on an
NVIDIA GPU through hand-written CUDA kernels (``csrc/``), built
at first use; on CPU tensors the plain PyTorch versions of the same
kernels run.
"""
