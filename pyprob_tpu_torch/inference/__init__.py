"""Inference engines beyond importance sampling (counterpart of
``pyprob_tpu/inference``).  So far: the batched single-site
Metropolis-Hastings chains (``mcmc``) with their resumable ``ChainState``,
SMC on both tiers (``smc``), and the gradient engines on the batched tier:
HMC (``hmc``, whose base the others share), NUTS (``nuts``), parallel
tempering (``pt``), resumable from a ``GradientChainState``, tempered SMC
(``tempered_smc``), VI (``vi``), SVGD (``svgd``) and Laplace/MAP
(``laplace``)."""

from .hmc import GradientChainState, vectorized_hmc_posterior
from .laplace import MAPResult, map_estimate, vectorized_laplace_posterior
from .mcmc import ChainState, ReplayHandler, vectorized_mcmc_posterior
from .nuts import vectorized_nuts_posterior
from .pt import vectorized_pt_posterior
from .smc import interpreter_smc_posterior, vectorized_smc_posterior
from .svgd import vectorized_svgd_posterior
from .tempered_smc import vectorized_tempered_smc_posterior
from .vi import vectorized_vi_posterior

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
    "vectorized_pt_posterior",
    "vectorized_smc_posterior",
    "vectorized_svgd_posterior",
    "vectorized_tempered_smc_posterior",
    "vectorized_vi_posterior",
    "interpreter_smc_posterior",
]
