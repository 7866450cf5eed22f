"""Inference engines beyond importance sampling (counterpart of
``pyprob_tpu/inference``).  So far: the batched single-site
Metropolis-Hastings chains (``mcmc``) with their resumable ``ChainState``."""

from .mcmc import ChainState, ReplayHandler, vectorized_mcmc_posterior

__all__ = ["ChainState", "ReplayHandler", "vectorized_mcmc_posterior"]
