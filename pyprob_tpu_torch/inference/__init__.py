"""Inference engines beyond importance sampling (counterpart of
``pyprob_tpu/inference``).  So far: the batched single-site
Metropolis-Hastings chains (``mcmc``) with their resumable ``ChainState``,
and SMC on both tiers (``smc``)."""

from .mcmc import ChainState, ReplayHandler, vectorized_mcmc_posterior
from .smc import interpreter_smc_posterior, vectorized_smc_posterior

__all__ = [
    "ChainState",
    "ReplayHandler",
    "vectorized_mcmc_posterior",
    "vectorized_smc_posterior",
    "interpreter_smc_posterior",
]
