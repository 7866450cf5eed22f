from .distribution import Distribution
from .normal import Normal
from .uniform import Uniform
from .truncated_normal import TruncatedNormal
from .categorical import Categorical
from .mixture import Mixture
from .multivariate_normal import MultivariateNormal
from .empirical import Empirical

__all__ = [
    "Distribution",
    "Normal",
    "Uniform",
    "TruncatedNormal",
    "Categorical",
    "Mixture",
    "MultivariateNormal",
    "Empirical",
]
