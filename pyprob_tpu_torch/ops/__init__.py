from . import blocked_linalg, kernels, mvn_logpdf, tile_chol
from .blocked_linalg import chol_panels, panel_cholesky
from .kernels import log_weight_stats, mixture_normal_log_prob
from .mvn_logpdf import mvn_quad_logdet
from .tile_chol import chol_inv_tile

__all__ = [
    "blocked_linalg",
    "chol_inv_tile",
    "chol_panels",
    "kernels",
    "log_weight_stats",
    "mixture_normal_log_prob",
    "mvn_logpdf",
    "mvn_quad_logdet",
    "panel_cholesky",
    "tile_chol",
]
