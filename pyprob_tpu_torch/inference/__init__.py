"""Inference engines beyond importance sampling (counterpart of
``pyprob_tpu/inference``).  So far: the batched single-site
Metropolis-Hastings chains (``mcmc``) with their resumable ``ChainState``,
SMC on both tiers (``smc``), and the gradient engines on the batched tier:
HMC (``hmc``, whose base the others share), NUTS (``nuts``) and
Laplace/MAP (``laplace``), resumable from a ``GradientChainState``."""

from .hmc import GradientChainState, vectorized_hmc_posterior
from .laplace import MAPResult, map_estimate, vectorized_laplace_posterior
from .mcmc import ChainState, ReplayHandler, vectorized_mcmc_posterior
from .nuts import vectorized_nuts_posterior
from .smc import interpreter_smc_posterior, vectorized_smc_posterior

__all__ = [
    "ChainState",
    "GradientChainState",
    "MAPResult",
    "ReplayHandler",
    "map_estimate",
    "vectorized_hmc_posterior",
    "vectorized_laplace_posterior",
    "vectorized_mcmc_posterior",
    "vectorized_nuts_posterior",
    "vectorized_smc_posterior",
    "interpreter_smc_posterior",
]
