from . import blocked_linalg, kernels, mvn_logpdf, tile_chol
from .blocked_linalg import chol_panels, panel_cholesky
from .kernels import log_weight_stats, mixture_normal_log_prob
from .mvn_logpdf import mvn_quad_logdet
from .tile_chol import chol_inv_tile


def counted_kernels():
    """Every hand-written kernel's wrapper by name, in the order of the
    kernel table (1, 1b, 2, 2b, 3, 4, 5, 6).  Each wrapper adds one to its
    ``.launches`` where it launches its kernel on the card, and nowhere
    else: the one list of what the launch counts see."""
    return {
        "mixture_normal_log_prob": kernels.mixture_normal_log_prob,
        "mixture_normal_log_prob_backward": kernels.mixture_normal_log_prob_backward,
        "mixture_truncated_normal_log_prob": kernels.mixture_truncated_normal_log_prob,
        "mixture_truncated_normal_log_prob_backward": kernels.mixture_truncated_normal_log_prob_backward,
        "log_weight_stats": kernels.log_weight_stats,
        "chol_inv_tile": tile_chol.chol_inv_tile,
        "mvn_quad_logdet": mvn_logpdf._quad_logdet_stacked,
        "mvn_quad_logdet_single": mvn_logpdf._quad_logdet_single,
    }


__all__ = [
    "blocked_linalg",
    "chol_inv_tile",
    "chol_panels",
    "counted_kernels",
    "kernels",
    "log_weight_stats",
    "mixture_normal_log_prob",
    "mvn_logpdf",
    "mvn_quad_logdet",
    "panel_cholesky",
    "tile_chol",
]
