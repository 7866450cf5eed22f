"""Importance-weight statistics and resampling over the particle axis
(counterpart of ``pyprob_tpu/parallel/collectives.py``).

The JAX package computes these as ``psum``-based reductions over a
sharded log-weight vector.  Here the particles live on one card: the
weight statistics are one launch of kernel 3 (``ops.kernels.
log_weight_stats_packed``, the port's kernel for exactly these three
sums), and resampling is a CDF search (``torch.cumsum``,
``torch.searchsorted``) computed, as in the JAX package, outside any
kernel.  Each scheme is split in two: drawing its uniforms from an
explicit ``torch.Generator`` (``draw_uniforms``) and mapping them to
ancestor indices (``indices_from_uniforms``), so given the same uniforms
the indices are the JAX package's.  Sharding over several cards comes
with the distributed slice.
"""

from __future__ import annotations

import math

import torch

from ..ops import kernels


def pooled_log_weight_stats(log_weights):
    """(log Σw, log Σw², n) over the ``[N]`` log-weights as 0-d tensors on
    their device, from one launch of kernel 3: m = max, s1 = Σe^(w−m),
    s2 = Σe^2(w−m) give log Σw = m + log s1 and log Σw² = 2m + log s2.
    Every weight −inf gives (−inf, −inf, n); a NaN weight gives NaN."""
    lw = log_weights.reshape(-1)
    m, s1, s2 = kernels.log_weight_stats_packed(lw).unbind()
    empty = m == -math.inf  # s1 and s2 are NaN there
    log_z = torch.where(empty, m, m + torch.log(s1))
    log_z2 = torch.where(empty, m, 2.0 * m + torch.log(s2))
    return log_z, log_z2, torch.tensor(float(lw.numel()), dtype=torch.float32, device=lw.device)


def sharded_effective_sample_size(log_weights):
    """ESS = (Σw)² / Σw² from kernel 3's one launch; 0 when every weight
    is −inf, NaN when a weight is NaN."""
    log_z, log_z2, _ = pooled_log_weight_stats(log_weights)
    ess = torch.exp(2.0 * log_z - log_z2)
    return torch.where(log_z == -math.inf, torch.zeros_like(ess), ess)


def log_weight_stats_host(log_weights):
    """(ESS, log Σw) of the ``[N]`` log-weights as Python floats, from one
    launch of kernel 3 and one copy to the host, in float64 there: s1²/s2
    and m + log s1.  Every weight −inf gives (0, −inf); a NaN weight gives
    NaN for both."""
    m, s1, s2 = kernels.log_weight_stats_packed(log_weights.reshape(-1)).tolist()
    if m == -math.inf:
        return 0.0, -math.inf
    return s1 * s1 / s2, m + math.log(s1)


def _normalized_weights(log_weights):
    lw = log_weights.reshape(-1)
    w = torch.exp(lw - lw.max())
    return w / w.sum()


def _search(cdf, points, size):
    # a float32 cumsum can leave cdf[-1] < 1: clamp so no index is == size
    return torch.clamp(torch.searchsorted(cdf, points), max=size - 1)


def systematic_indices_from_uniforms(log_weights, uniforms, num_samples):
    """Systematic (low-variance) resampling from one uniform ``uniforms``
    (0-d): points (u + i) / N over equally spaced strata."""
    cdf = torch.cumsum(_normalized_weights(log_weights), 0)
    steps = torch.arange(num_samples, dtype=cdf.dtype, device=cdf.device) / num_samples
    return _search(cdf, uniforms.to(cdf.dtype) / num_samples + steps, log_weights.numel())


def stratified_indices_from_uniforms(log_weights, uniforms, num_samples):
    """Stratified resampling: one uniform of ``uniforms`` ([N]) a stratum
    [i/N, (i+1)/N) (Douc et al. 2005)."""
    cdf = torch.cumsum(_normalized_weights(log_weights), 0)
    steps = torch.arange(num_samples, dtype=cdf.dtype, device=cdf.device)
    return _search(cdf, (uniforms.to(cdf.dtype) + steps) / num_samples, log_weights.numel())


def multinomial_indices_from_uniforms(log_weights, uniforms, num_samples):
    """Multinomial (iid) resampling: the CDF at each of ``uniforms`` ([N])."""
    cdf = torch.cumsum(_normalized_weights(log_weights), 0)
    return _search(cdf, uniforms.to(cdf.dtype), log_weights.numel())


def residual_indices_from_uniforms(log_weights, uniforms, num_samples):
    """Residual resampling: floor(N w_i) copies of particle i, then the
    remaining positions drawn from the normalized residuals at
    ``uniforms`` ([N]; position j reads the j-th).  Fixed shape: position
    j takes the deterministic copy while j < Σ floor counts.  The counts
    are int64: float32 cumsums lose exactness past 2^24 particles."""
    w = _normalized_weights(log_weights)
    n = w.numel()
    nw = num_samples * w
    counts = torch.floor(nw).to(torch.int64)
    det_total = counts.sum()
    det_cum = torch.cumsum(counts, 0)
    j = torch.arange(num_samples, dtype=torch.int64, device=w.device)
    det_idx = torch.clamp(torch.searchsorted(det_cum, j, right=True), max=n - 1)
    resid = nw - counts.to(nw.dtype)
    resid = resid / torch.clamp(resid.sum(), min=1e-30)
    resid_idx = _search(torch.cumsum(resid, 0), uniforms.to(w.dtype), n)
    return torch.where(j < det_total, det_idx, resid_idx)


_FROM_UNIFORMS = {
    "systematic": systematic_indices_from_uniforms,
    "stratified": stratified_indices_from_uniforms,
    "residual": residual_indices_from_uniforms,
    "multinomial": multinomial_indices_from_uniforms,
}


def _scheme(scheme):
    if scheme not in _FROM_UNIFORMS:
        raise ValueError(
            f"Unknown resampling scheme {scheme!r}; choose one of {sorted(_FROM_UNIFORMS)}"
        )
    return _FROM_UNIFORMS[scheme]


def draw_uniforms(generator, num_samples, scheme="systematic", device=None):
    """The uniforms a scheme reads, drawn from ``generator``: one (0-d) for
    systematic resampling, ``[num_samples]`` for the other three."""
    _scheme(scheme)
    shape = () if scheme == "systematic" else (num_samples,)
    return torch.rand(shape, generator=generator, dtype=torch.float32,
                      device=generator.device if device is None else device)


def indices_from_uniforms(log_weights, uniforms, num_samples, scheme="systematic"):
    """Ancestor indices (int64, ``[num_samples]``) of ``scheme`` from its
    uniforms (``draw_uniforms``'s shape)."""
    return _scheme(scheme)(log_weights, uniforms, num_samples)


def systematic_resample_indices(generator, log_weights, num_samples):
    """Systematic resampling, its one uniform drawn from ``generator``."""
    u = draw_uniforms(generator, num_samples, "systematic", log_weights.device)
    return systematic_indices_from_uniforms(log_weights, u, num_samples)


def stratified_resample_indices(generator, log_weights, num_samples):
    """Stratified resampling, its uniforms drawn from ``generator``."""
    u = draw_uniforms(generator, num_samples, "stratified", log_weights.device)
    return stratified_indices_from_uniforms(log_weights, u, num_samples)


def residual_resample_indices(generator, log_weights, num_samples):
    """Residual resampling, its uniforms drawn from ``generator``."""
    u = draw_uniforms(generator, num_samples, "residual", log_weights.device)
    return residual_indices_from_uniforms(log_weights, u, num_samples)


def multinomial_resample_indices(generator, log_weights, num_samples):
    """Multinomial resampling, its uniforms drawn from ``generator``."""
    u = draw_uniforms(generator, num_samples, "multinomial", log_weights.device)
    return multinomial_indices_from_uniforms(log_weights, u, num_samples)


RESAMPLING_SCHEMES = {
    "systematic": systematic_resample_indices,
    "stratified": stratified_resample_indices,
    "residual": residual_resample_indices,
    "multinomial": multinomial_resample_indices,
}


def resample_indices(generator, log_weights, num_samples, scheme="systematic"):
    """Dispatch over the four classic resampling schemes (variance order:
    systematic <= stratified <= residual < multinomial)."""
    _scheme(scheme)
    return RESAMPLING_SCHEMES[scheme](generator, log_weights, num_samples)
