"""pyprob_tpu_torch: the PyTorch and CUDA port of pyprob_tpu, a trace-based
universal probabilistic programming framework.

Models are ordinary Python programs calling ``sample`` / ``observe``.  This
port runs on an NVIDIA GPU (``cuda``) unless ``set_device('cpu')`` asks for
the CPU.  So far it trains a feedforward or an LSTM inference network
online (``Model.learn_inference_network``), saves and loads it
(``Model.save_inference_network``, ``load_inference_network``), and
serves importance sampling, from the prior and guided by that network, on
its batched tier, for models
with fixed structure and for rejection loops written with
``rejection_sample``; on its interpreter tier (one trace at a time on the
host, lockstep guided IS) for models that branch on sampled values,
trained through the gather-table loss; and prior IS of GP regression
(``models.GaussianProcessRegression``), whose MultivariateNormal factors
one kernel matrix per particle by a panel Cholesky.  Its distributions
(``pyprob_tpu_torch.distributions``) are every distribution of the JAX
package, the event-shaped MultivariateNormal, Dirichlet, Multinomial and
LKJCholesky among them, and its results are ``Empirical``s with the JAX
package's memory-mode surface (transforms, ``reobserve``, mode, median,
quantiles, HPD intervals, density estimates).  Its model zoo
(``pyprob_tpu_torch.models``) adds EightSchools, the Bayesian linear and
logistic regressions, GaussianMixture and LinearGaussianStateSpace to the
GUM, Marsaglia, HMM, Branching and GP families.  The mixture-of-Normals
and mixture-of-truncated-Normals log-densities (forward and backward), the
log-weight statistics, the panel Cholesky's diagonal-tile factor and
inverse, and the fused MVN quadratic form and log-determinant
(``ops.mvn_quad_logdet``) are hand-written CUDA kernels
(``pyprob_tpu_torch.ops``).  Its MCMC engines, LMH and RMH, run as
parallel chains on the batched tier (resumable from a ``ChainState``) and
as one sequential chain on the interpreter tier, and SMC (a staged-replay
particle filter with systematic, stratified, residual or multinomial
resampling, ``pyprob_tpu_torch.parallel``) on both tiers, guided by a
trained network on the batched tier; the gradient engines, HMC, NUTS and
parallel tempering (parallel chains resumable from a
``GradientChainState``), tempered SMC, VI (meanfield, fullrank and flow
guides), SVGD and LAPLACE with ``Model.map_estimate``, differentiate one
batched replay of ``forward`` over the chains (``pyprob_tpu_torch.
inference``); ``Model`` also gives
posterior-predictive draws, ``ConditionalModel`` (``Model.condition``) and
``ParallelModel`` (``Model.parallel``: trace generation over spawned
processes).
"""

from .util import (
    __version__,
    TraceMode,
    PriorInflation,
    InferenceEngine,
    InferenceNetwork,
    ObserveEmbedding,
    Optimizer,
    LearningRateScheduler,
    seed,
    set_verbosity,
    set_device,
)
from .state import sample, observe, factor, tag, rejection_sample
from .address import AddressDictionary
from .model import ConditionalModel, Model, ParallelModel
from .inference import ChainState
from . import distributions
from . import inference
from . import models
from . import ops
from . import parallel
from . import util

__all__ = [
    "__version__",
    "TraceMode",
    "PriorInflation",
    "InferenceEngine",
    "InferenceNetwork",
    "ObserveEmbedding",
    "Optimizer",
    "LearningRateScheduler",
    "seed",
    "set_verbosity",
    "set_device",
    "sample",
    "observe",
    "factor",
    "tag",
    "rejection_sample",
    "Model",
    "ConditionalModel",
    "ParallelModel",
    "ChainState",
    "AddressDictionary",
    "distributions",
    "inference",
    "models",
    "ops",
    "parallel",
    "util",
]
