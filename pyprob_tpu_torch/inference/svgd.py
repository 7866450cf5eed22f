"""Stein variational gradient descent over the program's continuous latents
(SVGD, Liu & Wang 2016, arXiv:1608.04471; counterpart of
``pyprob_tpu/inference/svgd.py``).

An ensemble of N particles moves along the Stein variational direction

    phi(z_i) = 1/N sum_j [ k(z_j, z_i) grad log p(z_j) + grad_{z_j} k(z_j, z_i) ]

(steepest descent of KL(q || p) in the RKHS of the RBF kernel k): the
attraction drives particles to high density, the kernel's repulsion keeps
them apart, so the ensemble matches the posterior, correlations and
non-Gaussian shape included, without a density for q.

With Z [N, D] the update is dense algebra, as in the JAX package: the
squared distances by the Gram trick, the median-heuristic bandwidth h =
median(d²)/log(N+1) floored at 1e-6, attraction K @ G and repulsion
(2/h)(rowsum(K)·Z − K @ Z), ``torch.matmul``s of [N, N] by [N, D] (the
JAX package computes them outside any Pallas kernel).  The scores G are
one batched gradient of the shared potential
(``_FunctionalModel``), so the transforms and the discrete sites'
enumeration are the gradient engines'.  The fit is a loop of steps of
``torch.optim.Adam`` (optax's update) on −phi, on a card one CUDA graph of
the step where the potential launches none of the hand-written kernels
(``hmc.run_steps``).

The result is the decoded ensemble with uniform weights, tiled with fresh
decode draws (fresh discrete conditionals) when ``num_traces`` exceeds N.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from .. import util
from ..vectorized import _skips_batched_tier, _TraceabilityCache
from .hmc import Untraceable, _decoded_empirical, _functionalize, _mesh_later, run_steps

_svgd_cache = {}


def _median(x):
    """jnp.median of a 1-D tensor: the mean of the two middle values for an
    even count (``torch.median`` alone gives the lower one)."""
    m = x.shape[0]
    v = torch.sort(x).values
    return v[m // 2] if m % 2 else 0.5 * (v[m // 2 - 1] + v[m // 2])


def stein_phi(z, score):
    """The Stein variational direction [N, D] of the ensemble z [N, D]
    given its scores ∇log p(z) [N, D]."""
    n = z.shape[0]
    sq = torch.sum(z * z, -1)
    d2 = torch.clamp(sq[:, None] + sq[None, :] - 2.0 * (z @ z.T), min=0.0)
    # the median heuristic, floored for stability
    h = torch.clamp(_median(d2.reshape(-1)) / math.log(n + 1.0), min=1e-6)
    k = torch.exp(-d2 / h)
    attract = k @ score
    repulse = (2.0 / h) * (torch.sum(k, 1)[:, None] * z - k @ z)
    return (attract + repulse) / n


def fit(fm, z, obs, steps, learning_rate):
    """``steps`` Adam steps of the ensemble z [N, D] along the Stein
    direction, by ``hmc.run_steps`` (on a card one CUDA graph of the step
    where the potential launches none of the hand-written kernels).
    Returns the final ensemble, the history of mean |phi| [steps] (on the
    card) and whether a CUDA graph ran the steps."""
    z = z.detach().clone()
    opt = torch.optim.Adam([z], lr=float(learning_rate), betas=(0.9, 0.999), eps=1e-8,
                           capturable=z.is_cuda)

    def step():
        _, g = fm._eager_value_and_grad(z, obs, True)
        phi = stein_phi(z, -g)
        # Adam minimizes: step on -phi to ascend the Stein flow
        z.grad = -phi
        opt.step()
        return phi.abs().mean()

    history, graphed = run_steps(step, steps, z.device)
    z.grad = None
    return z.detach(), history, graphed


def vectorized_svgd_posterior(model, num_traces, observe=None, map_func=None, file_name=None, svgd_steps=None,
                              svgd_particles=None, learning_rate=None, likelihood_importance=1.0, mesh=None,
                              args=(), kwargs=None):
    """Transport an N-particle ensemble by SVGD, then return it as a
    uniform-weight Empirical of ``num_traces`` decoded draws.  Returns None
    if the model does not run on the batched tier (SVGD has no interpreter
    tier)."""
    if mesh is not None:
        raise _mesh_later()
    if _skips_batched_tier(model, fallback=True):
        return None
    if not observe:
        raise RuntimeError("STEIN_VARIATIONAL_GRADIENT_DESCENT requires observe={...} values")
    if any(v is None for v in observe.values()):
        raise RuntimeError(f"Observe has missing value(s): {observe}")
    t0 = time.time()
    svgd_steps = 500 if svgd_steps is None else int(svgd_steps)
    svgd_particles = int(min(max(num_traces, 64), 1024)) if svgd_particles is None else int(svgd_particles)
    learning_rate = 0.05 if learning_rate is None else float(learning_rate)
    device = util.device()
    generator = util.generator(device)
    observed = {k: util.to_tensor(v, device) for k, v in observe.items()}
    results_only = getattr(map_func, "__name__", "") == "trace_result"
    cacheable = not args and not kwargs
    cache_key = (id(model), str(device), tuple(sorted(observe)), likelihood_importance, svgd_particles,
                 results_only)
    if cacheable and cache_key in _svgd_cache:
        fm = _svgd_cache[cache_key]
    else:
        try:
            fm = _functionalize(model, observed, likelihood_importance, "STEIN_VARIATIONAL_GRADIENT_DESCENT", args,
                                kwargs, generator)
        except Untraceable as e:
            util.log_print(f"[pyprob_tpu_torch] model {model.name!r} does not run on the batched tier ({e}); "
                           "STEIN_VARIATIONAL_GRADIENT_DESCENT has no interpreter tier.")
            _TraceabilityCache.mark(model, False)
            return None
        if cacheable:
            _svgd_cache[cache_key] = fm
    _TraceabilityCache.mark(model, True)
    dim, n = fm.dim, svgd_particles

    z0 = fm.encode(n, observed)
    t_fit = time.time()
    z, history, graphed = fit(fm, z0, observed, svgd_steps, learning_rate)
    history = history.cpu().numpy().astype(np.float64)
    fit_seconds = time.time() - t_fit
    # tile the ensemble up to num_traces; each copy's decode redraws any
    # discrete sites from their exact conditionals
    idx = torch.arange(n, device=z.device).repeat(-(-num_traces // n))[:num_traces]
    emp = _decoded_empirical(fm, z[idx], observed, map_func, results_only, file_name)
    duration = time.time() - t0
    final_phi = float(history[-1]) if len(history) else float("nan")
    emp.rename(
        f"Posterior, SVGD ({n} particles, D={dim}, {svgd_steps} steps), draws: {emp.length:,}"
    )
    emp.add_metadata(
        op="posterior",
        num_traces=num_traces,
        inference_engine="InferenceEngine.STEIN_VARIATIONAL_GRADIENT_DESCENT",
        latent_dim=dim,
        svgd_particles=n,
        svgd_steps=svgd_steps,
        learning_rate=learning_rate,
        final_mean_update_norm=final_phi,
        vectorized=True,
        fit_seconds=fit_seconds,
        step_graph=graphed,
    )
    if util.verbosity() > 1:
        util.log_print(
            f"[SVGD] {n} particles over {dim} latent dim(s): final mean |phi| {final_phi:.2e} after "
            f"{svgd_steps} steps, {emp.length:,} draws in {duration:.3f}s"
        )
    return emp
