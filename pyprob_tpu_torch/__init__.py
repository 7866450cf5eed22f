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
one kernel matrix per particle by a panel Cholesky.  The mixture-of-Normals
and mixture-of-truncated-Normals log-densities (forward and backward), the
log-weight statistics, the panel Cholesky's diagonal-tile factor and
inverse, and the fused MVN quadratic form and log-determinant
(``ops.mvn_quad_logdet``) are hand-written CUDA kernels
(``pyprob_tpu_torch.ops``).
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
from .model import Model
from . import distributions
from . import models
from . import ops
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
    "distributions",
    "models",
    "ops",
    "util",
]
