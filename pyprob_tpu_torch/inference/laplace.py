"""MAP estimation and the Laplace approximation over the program's
continuous latents (counterpart of ``pyprob_tpu/inference/laplace.py``).

The gradient engines' base (``inference/hmc.py``: ``_functionalize``)
makes the joint density a differentiable function of one flat
unconstrained latent vector, so the posterior mode is found by multi-start
gradient descent and the curvature at the mode gives a Gaussian:

- **MAP** (``map_estimate``): S starts fit at once by one Adam over
  ``[S, D]`` on the summed potential, which is exactly S independent Adams
  (Adam is elementwise, and each start's potential depends on its own row
  only), on -log p(x(z), obs) WITHOUT the Jacobian adjustment (Stan
  ``optimizing`` convention: the mode is the constrained-space posterior
  mode), enumerable discrete sites marginalized; the best final value wins.
- **Laplace** (engine): the Gaussian is fit in unconstrained space, so
  its own mode search uses the full potential U(z) = -log p(x(z), obs) -
  log|dx/dz|.  H = ∇²U(z_map) by ``torch.autograd.functional.hessian`` on
  a replay of one row, eigen-floored on the host in float64; q =
  N(z_map, H⁻¹).  The result is importance-reweighted draws from q, log w
  = -U(z) - log q(z), so it stays asymptotically exact where the
  Gaussian is wrong; its ESS and log Z (``log_evidence``) come from kernel
  3 over the ``[N]`` weights on the device, beside the Laplace evidence
  ``log_evidence_laplace`` = -U(z_map) + D/2·log 2π + ½·log det H⁻¹.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from .. import util
from ..parallel.collectives import log_weight_stats_host
from ..vectorized import _BATCH_LIMIT, _skips_batched_tier, _TraceabilityCache
from .hmc import Untraceable, _decoded_empirical, _functionalize, _mesh_later

_LOG_2PI = math.log(2.0 * math.pi)
# optax.adam's defaults
_B1, _B2, _EPS = 0.9, 0.999, 1e-8


class MAPResult:
    """Posterior-mode summary returned by ``Model.map_estimate``.

    Attributes: ``values`` ({site name-or-address: constrained value}),
    ``result`` (forward() return at the mode), ``log_joint``
    (log p(x, obs) at the mode, i.e. -potential without the Jacobian),
    ``z`` (flat unconstrained mode), ``num_starts``, ``map_steps``.
    """

    def __init__(self, values, result, log_joint, z, num_starts, map_steps):
        self.values = values
        self.result = result
        self.log_joint = log_joint
        self.z = z
        self.num_starts = num_starts
        self.map_steps = map_steps

    def __repr__(self):
        return f"MAPResult(log_joint={self.log_joint:.4f}, values={self.values})"


def adam_fit(fm, z0, observed, steps, lr, jac=True):
    """``steps`` Adam steps (optax.adam's update) of every row of z0 [S, D]
    on the potential (``jac=False``: without the Jacobian).  Returns the
    final rows [S, D] and their potentials [S]."""
    z = z0.detach().clone()
    mu = torch.zeros_like(z)
    nu = torch.zeros_like(z)
    for t in range(1, int(steps) + 1):
        _, g = fm.value_and_grad(z, observed, jac=jac)
        mu = (1.0 - _B1) * g + _B1 * mu
        nu = (1.0 - _B2) * g * g + _B2 * nu
        mu_hat = mu / (1.0 - _B1**t)
        nu_hat = nu / (1.0 - _B2**t)
        z = z - lr * (mu_hat / (torch.sqrt(nu_hat) + _EPS))
    with torch.no_grad():
        pots = (fm.potential if jac else fm.potential_nojac)(z, observed)
    return z, pots


def _find_map(fm, observed, map_steps, num_starts, learning_rate, jac=True):
    z0 = fm.encode(num_starts, observed)
    z_finals, pots = adam_fit(fm, z0, observed, map_steps, learning_rate, jac=jac)
    pots_host = pots.detach().cpu().numpy().astype(np.float64)
    if not np.isfinite(pots_host).any():
        raise RuntimeError(
            "MAP optimization diverged from every start (non-finite "
            "potential); try a smaller learning_rate or more map_steps."
        )
    best = int(np.nanargmin(np.where(np.isfinite(pots_host), pots_host, np.nan)))
    return z_finals[best], float(pots_host[best])


def hessian(fm, z, observed):
    """∇²U at one point z [D]: ``torch.autograd.functional.hessian`` of the
    potential of a one-row replay, float64 on the host."""
    with torch.enable_grad():
        H = torch.autograd.functional.hessian(lambda v: fm.potential(v[None], observed)[0], z.detach())
    return H.detach().cpu().numpy().astype(np.float64)


def _prepare(model, observe, likelihood_importance, engine_name, args, kwargs):
    if not observe:
        raise RuntimeError(f"{engine_name} requires observe={{...}} values")
    if any(v is None for v in observe.values()):
        raise RuntimeError(f"Observe has missing value(s): {observe}")
    device = util.device()
    observed = {k: util.to_tensor(v, device) for k, v in observe.items()}
    fm = _functionalize(model, observed, likelihood_importance, engine_name, args, kwargs)
    return fm, observed


def map_estimate(model, observe=None, map_steps=None, num_starts=None, learning_rate=None,
                 likelihood_importance=1.0, args=(), kwargs=None):
    """Posterior mode of the program's continuous latents (discrete
    enumerable sites marginalized, then drawn from their exact
    conditional at the mode).  Returns a ``MAPResult``.

    The mode is the CONSTRAINED-space posterior mode: optimization runs
    in unconstrained space but without the transform's log-Jacobian
    adjustment (Stan ``optimizing`` convention), so for a Gamma-posterior
    latent this returns (α−1)/β, not the log-space mode.  ``log_joint``
    is log p(x, obs) at that mode.  A model that does not run on the
    batched tier raises (there is no interpreter tier)."""
    from .hmc import no_interpreter_tier

    map_steps = 400 if map_steps is None else int(map_steps)
    num_starts = 8 if num_starts is None else int(num_starts)
    learning_rate = 0.05 if learning_rate is None else float(learning_rate)
    if _skips_batched_tier(model, fallback=True):
        raise no_interpreter_tier("map_estimate", model)
    try:
        fm, observed = _prepare(model, observe, likelihood_importance, "map_estimate", args, kwargs)
    except Untraceable:
        _TraceabilityCache.mark(model, False)
        raise no_interpreter_tier("map_estimate", model) from None
    z_map, pot = _find_map(fm, observed, map_steps, num_starts, learning_rate, jac=False)
    outputs, dists, sites, sizes = fm.decode(z_map[None], observed, False)
    values = {}
    for s in sites:
        if s.control and not s.observed and s.address in outputs["values"]:
            values[s.name or s.address] = outputs["values"][s.address][0].detach().cpu().numpy()
    result = outputs["result"]
    result = result[0].detach().cpu().numpy() if isinstance(result, torch.Tensor) else result
    return MAPResult(
        values=values,
        result=result,
        log_joint=-pot,
        z=z_map.detach().cpu().numpy(),
        num_starts=num_starts,
        map_steps=map_steps,
    )


def vectorized_laplace_posterior(model, num_traces, observe=None, map_func=None, file_name=None, map_steps=None,
                                 num_starts=None, learning_rate=None, likelihood_importance=1.0, mesh=None,
                                 args=(), kwargs=None):
    """Laplace-approximate posterior: N(z_map, H⁻¹) in unconstrained
    space, returned as importance-reweighted draws (asymptotically exact).
    Returns None if the model does not run on the batched tier."""
    if mesh is not None:
        raise _mesh_later()
    if _skips_batched_tier(model, fallback=True):
        return None
    t0 = time.time()
    map_steps = 400 if map_steps is None else int(map_steps)
    num_starts = 8 if num_starts is None else int(num_starts)
    learning_rate = 0.05 if learning_rate is None else float(learning_rate)
    results_only = getattr(map_func, "__name__", "") == "trace_result"
    try:
        fm, observed = _prepare(model, observe, likelihood_importance, "LAPLACE", args, kwargs)
    except Untraceable as e:
        util.log_print(
            f"[pyprob_tpu_torch] model {model.name!r} does not run on the batched tier ({e}); "
            "LAPLACE has no interpreter tier."
        )
        _TraceabilityCache.mark(model, False)
        return None
    _TraceabilityCache.mark(model, True)
    dim = fm.dim
    z_map, pot = _find_map(fm, observed, map_steps, num_starts, learning_rate)

    # curvature at the mode; eigen-floor on the host in float64 so saddle
    # or flat directions become a (wide) proper Gaussian instead of a
    # crash — the IS reweighting absorbs the approximation either way
    H = hessian(fm, z_map, observed)
    H = 0.5 * (H + H.T)
    w, V = np.linalg.eigh(H)
    floor = max(1e-8, 1e-6 * float(np.max(np.abs(w))) if w.size else 0.0)
    w = np.maximum(w, floor)
    # cov = V diag(1/w) Vᵀ; scale scaleᵀ = cov
    scale = V @ np.diag(1.0 / np.sqrt(w))
    logdet_cov = float(-np.sum(np.log(w)))
    log_evidence_laplace = float(-pot + 0.5 * dim * _LOG_2PI + 0.5 * logdet_cov)

    device = z_map.device
    generator = util.generator(device)
    eps = torch.randn((num_traces, dim), generator=generator, dtype=util.dtype(), device=device)
    scale_t = torch.as_tensor(scale, dtype=util.dtype(), device=device)
    z = z_map.detach()[None] + eps @ scale_t.T
    log_q = -0.5 * torch.sum(eps * eps, -1) - 0.5 * dim * _LOG_2PI - 0.5 * logdet_cov
    per = max(1, _BATCH_LIMIT // fm.num_combos)
    with torch.no_grad():
        pots = torch.cat([fm.potential(z[b : b + per], observed) for b in range(0, num_traces, per)])
    log_w = -pots - log_q
    log_w = torch.where(torch.isnan(log_w), torch.full_like(log_w, -math.inf), log_w)
    # ESS and log Z from kernel 3 over the device-resident weights
    ess, log_sum = log_weight_stats_host(log_w)
    log_evidence = log_sum - math.log(num_traces)
    emp = _decoded_empirical(
        fm, z, observed, map_func, results_only, file_name,
        log_weights=log_w.detach().cpu().numpy().astype(np.float64), effective_sample_size=ess,
    )
    duration = time.time() - t0
    emp.log_evidence = log_evidence
    emp.log_evidence_laplace = log_evidence_laplace
    emp.rename(
        f"Posterior, Laplace (D={dim}, {num_starts} starts x "
        f"{map_steps} steps), IS-reweighted draws: {emp.length:,}, "
        f"ESS: {ess:,.2f}"
    )
    emp.add_metadata(
        op="posterior",
        num_traces=num_traces,
        inference_engine="InferenceEngine.LAPLACE",
        latent_dim=dim,
        map_steps=map_steps,
        num_starts=num_starts,
        learning_rate=learning_rate,
        log_joint_at_mode=-pot,
        log_evidence=log_evidence,
        log_evidence_laplace=log_evidence_laplace,
        effective_sample_size=ess,
        vectorized=True,
    )
    if util.verbosity() > 1:
        util.log_print(
            f"[Laplace] mode over {dim} latent dim(s): log joint {-pot:.3f},"
            f" Laplace evidence {log_evidence_laplace:.3f}, {emp.length:,} "
            f"reweighted draws (ESS {ess:,.1f}) in {duration:.3f}s"
        )
    return emp
