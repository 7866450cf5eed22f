from .distribution import Distribution
from .normal import Normal
from .uniform import Uniform
from .categorical import Categorical
from .bernoulli import Bernoulli
from .binomial import Binomial
from .poisson import Poisson
from .exponential import Exponential
from .gamma import Gamma
from .beta import Beta
from .log_normal import LogNormal
from .von_mises import VonMises
from .weibull import Weibull
from .truncated_normal import TruncatedNormal
from .multivariate_normal import MultivariateNormal
from .half_cauchy import HalfCauchy
from .half_normal import HalfNormal
from .chi2 import Chi2
from .inverse_gamma import InverseGamma
from .pareto import Pareto
from .mixture import Mixture
from .factor import Factor
from .empirical import Empirical

__all__ = [
    "Distribution",
    "Normal",
    "Uniform",
    "Categorical",
    "Bernoulli",
    "Binomial",
    "Poisson",
    "Exponential",
    "Gamma",
    "Beta",
    "LogNormal",
    "VonMises",
    "Weibull",
    "TruncatedNormal",
    "MultivariateNormal",
    "HalfCauchy",
    "HalfNormal",
    "Chi2",
    "InverseGamma",
    "Pareto",
    "Mixture",
    "Factor",
    "Empirical",
]
