"""The port's distributions (counterpart of ``pyprob_tpu/distributions``):
Normal, Uniform, Categorical, Bernoulli, Binomial, Poisson, the
positive-support family, Beta, VonMises, TruncatedNormal, the heavy-tailed
family (StudentT, Laplace, Cauchy, Logistic, Gumbel), Geometric,
NegativeBinomial, the Censored and ZeroInflated observation wrappers, the
event-shaped MultivariateNormal, Dirichlet, Multinomial, LKJCholesky and
LKJCholeskyCPCNormal, Mixture, Factor, and Empirical (memory mode) with
EmpiricalType.
"""

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
from .dirichlet import Dirichlet
from .multinomial import Multinomial
from .lkj import LKJCholesky, LKJCholeskyCPCNormal
from .half_cauchy import HalfCauchy
from .half_normal import HalfNormal
from .chi2 import Chi2
from .inverse_gamma import InverseGamma
from .pareto import Pareto
from .student_t import StudentT
from .laplace import Laplace
from .cauchy import Cauchy
from .logistic import Logistic
from .gumbel import Gumbel
from .geometric import Geometric
from .negative_binomial import NegativeBinomial
from .censored import Censored
from .zero_inflated import ZeroInflated
from .mixture import Mixture
from .factor import Factor
from .empirical import Empirical, EmpiricalType

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
    "Dirichlet",
    "Multinomial",
    "LKJCholesky",
    "LKJCholeskyCPCNormal",
    "HalfCauchy",
    "HalfNormal",
    "Chi2",
    "InverseGamma",
    "Pareto",
    "StudentT",
    "Laplace",
    "Cauchy",
    "Logistic",
    "Gumbel",
    "Geometric",
    "NegativeBinomial",
    "Censored",
    "ZeroInflated",
    "Mixture",
    "Factor",
    "Empirical",
    "EmpiricalType",
]
