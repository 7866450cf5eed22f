from .distribution import Distribution
from .normal import Normal
from .categorical import Categorical
from .mixture import Mixture
from .empirical import Empirical

__all__ = ["Distribution", "Normal", "Categorical", "Mixture", "Empirical"]
