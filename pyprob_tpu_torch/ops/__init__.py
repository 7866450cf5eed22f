from . import kernels
from .kernels import log_weight_stats, mixture_normal_log_prob

__all__ = ["kernels", "log_weight_stats", "mixture_normal_log_prob"]
