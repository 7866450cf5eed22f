"""Weight statistics and resampling over the particle axis (counterpart of
``pyprob_tpu/parallel``).  One card so far: the mesh, the distributed
helpers and the jit introspection come with the distributed slice."""

from .collectives import (
    RESAMPLING_SCHEMES,
    draw_uniforms,
    indices_from_uniforms,
    multinomial_resample_indices,
    pooled_log_weight_stats,
    resample_indices,
    residual_resample_indices,
    sharded_effective_sample_size,
    stratified_resample_indices,
    systematic_resample_indices,
)

__all__ = [
    "pooled_log_weight_stats",
    "sharded_effective_sample_size",
    "systematic_resample_indices",
    "stratified_resample_indices",
    "residual_resample_indices",
    "multinomial_resample_indices",
    "resample_indices",
    "RESAMPLING_SCHEMES",
    "draw_uniforms",
    "indices_from_uniforms",
]
