"""Automatic-differentiation variational inference over the program's
continuous latents (ADVI, arXiv:1603.00788; counterpart of
``pyprob_tpu/inference/vi.py``).

The gradient engines' base (``inference/hmc.py``: ``_functionalize``)
makes the joint density a differentiable function of one flat
unconstrained latent vector z (the HMC transforms, enumerable discrete
sites marginalized), so a guide q over z is fitted by reparameterized ELBO
gradients:

- ``meanfield``: a diagonal Gaussian (μ, log σ);
- ``fullrank``: a Gaussian with a dense lower-triangular scale L (free
  strictly-lower entries plus an exp'd diagonal), which captures the
  posterior's correlations;
- ``flow``: a RealNVP normalizing flow, 6 affine coupling layers with
  alternating masks over a meanfield base, zero-initialized output layers
  (each coupling starts as the identity) and tanh-bounded scales; the
  couplings invert in closed form, so q's density stays exact.

The Gaussian ELBOs use the closed-form entropy, the flow's the sampled
−log q.  The JAX package fits in one ``lax.scan`` with optax's Adam; here
the fit is a loop of steps with ``torch.optim.Adam`` (optax's update:
bias-corrected moments, ε outside the square root).  A step draws the
particles' ε [P, D] from the run's generator, and its gradient is the
chain rule through one potential: the guide's draws z(θ) go through the
potential and its gradient ∂U/∂z, which autograd pulls back to the
guide's parameters through z(θ) alone.  On a card the whole step (the
guide, the potential, the pull-back and Adam) is one CUDA graph where the
potential launches none of the hand-written kernels (``hmc.run_steps``).

The result is importance-reweighted: ``num_traces`` guide draws weighted
log p(x, obs) − log q(z), decoded as the gradient engines decode
(enumerated discrete sites drawn from their exact conditional), with ESS
and ``log_evidence`` from kernel 3 over the ``[N]`` weights on the card.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from .. import util
from ..parallel.collectives import log_weight_stats_host
from ..vectorized import _BATCH_LIMIT, _skips_batched_tier, _TraceabilityCache
from .hmc import Untraceable, _decoded_empirical, _functionalize, _mesh_later, run_steps

_LOG_2PI = math.log(2.0 * math.pi)
_FLOW_LAYERS = 6
_GUIDES = ("meanfield", "fullrank", "flow")

_vi_cache = {}


class Guide:
    """A variational family over the flat unconstrained latents [D]; every
    method takes a leading [P] dimension of particles.  Parameters are a
    dict of tensors laid out as the JAX package's pytree: ``mu`` and
    ``log_sigma`` (meanfield, flow), ``log_diag`` and ``tril`` (fullrank),
    and ``layers``, a list of dicts of ``w1`` [D, H], ``b1`` [H], ``w2``
    [H, 2D], ``b2`` [2D] (flow)."""

    def __init__(self, kind, dim):
        if kind not in _GUIDES:
            raise ValueError(f"guide must be 'meanfield', 'fullrank' or 'flow', got {kind!r}")
        self.kind, self.dim = kind, int(dim)
        self.hidden = max(32, 2 * self.dim)
        self._tril = {}  # device -> the strictly-lower entries' (rows, cols)

    def make_params(self, mu0):
        """Initial parameters around the mean ``mu0`` [D]: σ = e^-1, L =
        e^-1·I, and the flow's first layers 0.01·N(0, 1) from a generator
        seeded 7 with zero output layers."""
        D, like = self.dim, dict(dtype=mu0.dtype, device=mu0.device)
        params = {"mu": mu0.detach().clone()}
        if self.kind == "fullrank":
            params["log_diag"] = torch.full((D,), -1.0, **like)
            params["tril"] = torch.zeros((D * (D - 1) // 2,), **like)
            return params
        params["log_sigma"] = torch.full((D,), -1.0, **like)
        if self.kind == "flow":
            gen = torch.Generator(device=mu0.device).manual_seed(7)
            params["layers"] = [
                {
                    "w1": 0.01 * torch.randn((D, self.hidden), generator=gen, **like),
                    "b1": torch.zeros((self.hidden,), **like),
                    "w2": torch.zeros((self.hidden, 2 * D), **like),
                    "b2": torch.zeros((2 * D,), **like),
                }
                for _ in range(_FLOW_LAYERS)
            ]
        return params

    def _scale_tril(self, params):
        L = torch.diag(torch.exp(params["log_diag"]))
        if self.dim > 1:
            if L.device not in self._tril:
                rows, cols = np.tril_indices(self.dim, k=-1)
                self._tril[L.device] = (torch.as_tensor(rows, device=L.device), torch.as_tensor(cols, device=L.device))
            L = L.index_put(self._tril[L.device], params["tril"], accumulate=True)
        return L

    def _mask(self, layer, like):
        return ((torch.arange(self.dim, device=like.device) + layer) % 2).to(like.dtype)

    def _st(self, layer, x_masked):
        """A coupling layer's scale (tanh-bounded) and shift nets."""
        h = torch.tanh(x_masked @ layer["w1"] + layer["b1"])
        out = h @ layer["w2"] + layer["b2"]
        return torch.tanh(out[..., : self.dim]) * 2.0, out[..., self.dim :]

    def sample(self, params, eps):
        """z [P, D] from standard-normal ε [P, D]."""
        return self.sample_logq(params, eps)[0] if self.kind == "flow" else self._gaussian_sample(params, eps)

    def _gaussian_sample(self, params, eps):
        if self.kind == "meanfield":
            return params["mu"] + torch.exp(params["log_sigma"]) * eps
        return params["mu"] + eps @ self._scale_tril(params).T

    def sample_logq(self, params, eps):
        """(z [P, D], log q(z) [P]) from ε: the flow's forward pass yields
        log q as it goes; a Gaussian's is its density at z."""
        if self.kind != "flow":
            z = self._gaussian_sample(params, eps)
            return z, self.log_prob(params, z)
        D = self.dim
        z = params["mu"] + torch.exp(params["log_sigma"]) * eps
        log_q = -0.5 * torch.sum(eps * eps, -1) - 0.5 * D * _LOG_2PI - torch.sum(params["log_sigma"])
        for i, layer in enumerate(params["layers"]):
            m = self._mask(i, z)
            s, t = self._st(layer, z * m)
            z = m * z + (1.0 - m) * (z * torch.exp(s) + t)
            log_q = log_q - torch.sum((1.0 - m) * s, -1)
        return z, log_q

    def log_prob(self, params, z):
        """log q(z) [P] of given z [P, D] (the flow by its inverse)."""
        D = self.dim
        if self.kind == "meanfield":
            r = (z - params["mu"]) * torch.exp(-params["log_sigma"])
            return -0.5 * torch.sum(r * r, -1) - torch.sum(params["log_sigma"]) - 0.5 * D * _LOG_2PI
        if self.kind == "fullrank":
            L = self._scale_tril(params)
            r = torch.linalg.solve_triangular(L, (z - params["mu"]).T, upper=False).T
            return -0.5 * torch.sum(r * r, -1) - torch.sum(params["log_diag"]) - 0.5 * D * _LOG_2PI
        logdet = torch.zeros(z.shape[:-1], dtype=z.dtype, device=z.device)
        for i in reversed(range(len(params["layers"]))):
            m = self._mask(i, z)
            s, t = self._st(params["layers"][i], z * m)
            z = m * z + (1.0 - m) * ((z - t) * torch.exp(-s))
            logdet = logdet + torch.sum((1.0 - m) * s, -1)
        eps = (z - params["mu"]) * torch.exp(-params["log_sigma"])
        return -0.5 * torch.sum(eps * eps, -1) - 0.5 * D * _LOG_2PI - torch.sum(params["log_sigma"]) - logdet

    def entropy(self, params):
        """The Gaussians' closed-form entropy (None for the flow)."""
        if self.kind == "flow":
            return None
        log_scale = params["log_sigma"] if self.kind == "meanfield" else params["log_diag"]
        return torch.sum(log_scale) + 0.5 * self.dim * (1.0 + _LOG_2PI)


def guide_leaves(params):
    """The parameter tensors in the JAX pytree's order (dict keys sorted)."""
    out = []
    for key in sorted(params):
        value = params[key]
        if isinstance(value, list):
            for layer in value:
                out.extend(layer[k] for k in sorted(layer))
        else:
            out.append(value)
    return out


def guide_params_from_numpy(params, device=None):
    """A guide's parameters from numpy arrays in the JAX package's pytree
    layout (``jax.tree.map(np.asarray, params)``) as float32 tensors on the
    port's device."""
    device = util.device() if device is None else device

    def conv(v):
        if isinstance(v, dict):
            return {k: conv(x) for k, x in v.items()}
        if isinstance(v, (list, tuple)):
            return [conv(x) for x in v]
        return torch.as_tensor(np.asarray(v), dtype=util.dtype(), device=device)

    return conv(params)


def guide_params_to_numpy(params):
    """The inverse of ``guide_params_from_numpy``: the same layout, numpy."""
    if isinstance(params, dict):
        return {k: guide_params_to_numpy(v) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return [guide_params_to_numpy(v) for v in params]
    return params.detach().cpu().numpy()


def elbo_and_grads(guide, fm, params, eps, obs, value_and_grad=None):
    """The ELBO at the particles ε [P, D] (0-d) and its gradient for each
    of ``guide_leaves(params)``.  The potential's gradient ∂U/∂z at the
    draws z(θ) comes from ``value_and_grad(z)`` (default
    ``fm.value_and_grad``); autograd pulls it back through z(θ) (and the
    flow's log q, or the Gaussians' entropy)."""
    if value_and_grad is None:
        value_and_grad = lambda v: fm.value_and_grad(v, obs)  # noqa: E731
    leaves = guide_leaves(params)
    P = eps.shape[0]
    with torch.enable_grad():
        for leaf in leaves:
            leaf.requires_grad_(True)
        if guide.kind == "flow":
            z, log_q = guide.sample_logq(params, eps)
            u, g = value_and_grad(z.detach())
            surrogate = torch.sum(z * g) / P + log_q.mean()
            elbo = -(u.mean() + log_q.detach().mean())
        else:
            z = guide.sample(params, eps)
            entropy = guide.entropy(params)
            u, g = value_and_grad(z.detach())
            surrogate = torch.sum(z * g) / P - entropy
            elbo = entropy.detach() - u.mean()
        # a parameter the ELBO does not read (fullrank's strictly-lower
        # entries at D = 1) has gradient zero
        grads = torch.autograd.grad(surrogate, leaves, allow_unused=True)
    for leaf in leaves:
        leaf.requires_grad_(False)
    grads = [torch.zeros_like(leaf) if gr is None else gr for leaf, gr in zip(leaves, grads)]
    return elbo, grads


def fit(guide, fm, params, obs, steps, learning_rate, generator, particles):
    """``steps`` Adam steps (``torch.optim.Adam``, optax's ``adam`` update)
    of the guide's parameters on the negative ELBO, each at ``particles``
    fresh ε from ``generator``, by ``hmc.run_steps`` (on a card one CUDA
    graph of the step where the potential launches none of the hand-written
    kernels).  Returns the parameters, updated in place, the ELBO history
    [steps] (on the card) and whether a CUDA graph ran the steps."""
    leaves = guide_leaves(params)
    device = leaves[0].device
    opt = torch.optim.Adam(leaves, lr=float(learning_rate), betas=(0.9, 0.999), eps=1e-8,
                           capturable=device.type == "cuda")
    eps = torch.empty((particles, guide.dim), dtype=leaves[0].dtype, device=device)

    def refresh():
        eps.copy_(torch.randn(eps.shape, generator=generator, dtype=eps.dtype, device=device))

    def step():
        elbo, grads = elbo_and_grads(guide, fm, params, eps, obs, lambda v: fm._eager_value_and_grad(v, obs, True))
        for leaf, grad in zip(leaves, grads):
            leaf.grad = grad
        opt.step()
        return elbo

    history, graphed = run_steps(step, steps, device, refresh)
    for leaf in leaves:
        leaf.grad = None
    return params, history, graphed


def importance_draws(guide, fm, params, obs, num, generator):
    """``num`` guide draws z [num, D] and their log-weights log p(x(z), obs)
    + log|dx/dz| − log q(z) [num] (NaN as −inf), the potential in chunks of
    the batched tier's rows."""
    like = dict(dtype=params["mu"].dtype, device=params["mu"].device)
    eps = torch.randn((num, guide.dim), generator=generator, **like)
    per = max(1, _BATCH_LIMIT // fm.num_combos)
    with torch.no_grad():
        z, log_q = guide.sample_logq(params, eps)
        pots = torch.cat([fm.potential(z[b : b + per], obs) for b in range(0, num, per)])
    log_w = -pots - log_q
    return z, torch.where(torch.isnan(log_w), torch.full_like(log_w, -math.inf), log_w)


def vectorized_vi_posterior(model, num_traces, observe=None, map_func=None, file_name=None, vi_steps=None,
                            vi_particles=None, guide=None, learning_rate=None, likelihood_importance=1.0, mesh=None,
                            args=(), kwargs=None):
    """Fit a guide by ADVI, then return an importance-reweighted Empirical
    of ``num_traces`` guide draws.  Returns None if the model does not run
    on the batched tier (VI has no interpreter tier)."""
    if mesh is not None:
        raise _mesh_later()
    if _skips_batched_tier(model, fallback=True):
        return None
    if not observe:
        raise RuntimeError("VARIATIONAL_INFERENCE requires observe={...} values")
    if any(v is None for v in observe.values()):
        raise RuntimeError(f"Observe has missing value(s): {observe}")
    t0 = time.time()
    vi_steps = 1500 if vi_steps is None else int(vi_steps)
    vi_particles = 32 if vi_particles is None else int(vi_particles)
    guide = "meanfield" if guide is None else guide
    if guide not in _GUIDES:
        raise ValueError(f"guide must be 'meanfield', 'fullrank' or 'flow', got {guide!r}")
    learning_rate = 0.05 if learning_rate is None else float(learning_rate)
    device = util.device()
    generator = util.generator(device)
    observed = {k: util.to_tensor(v, device) for k, v in observe.items()}
    results_only = getattr(map_func, "__name__", "") == "trace_result"
    cacheable = not args and not kwargs
    cache_key = (id(model), str(device), tuple(sorted(observe)), likelihood_importance, guide, vi_particles,
                 results_only)
    if cacheable and cache_key in _vi_cache:
        fm, family = _vi_cache[cache_key]
    else:
        try:
            fm = _functionalize(model, observed, likelihood_importance, "VARIATIONAL_INFERENCE", args, kwargs,
                                generator)
        except Untraceable as e:
            util.log_print(f"[pyprob_tpu_torch] model {model.name!r} does not run on the batched tier ({e}); "
                           "VARIATIONAL_INFERENCE has no interpreter tier.")
            _TraceabilityCache.mark(model, False)
            return None
        family = Guide(guide, fm.dim)
        if cacheable:
            _vi_cache[cache_key] = fm, family
    _TraceabilityCache.mark(model, True)
    dim = fm.dim

    # the guide's mean starts at the encoded image of a prior draw
    params = family.make_params(fm.encode(1, observed)[0])
    t_fit = time.time()
    params, history, graphed = fit(family, fm, params, observed, vi_steps, learning_rate, generator, vi_particles)
    history = history.detach().cpu().numpy().astype(np.float64)
    fit_seconds = time.time() - t_fit
    z, log_w = importance_draws(family, fm, params, observed, num_traces, generator)
    # ESS and log Z from kernel 3 over the weights on the card
    ess, log_sum = log_weight_stats_host(log_w)
    log_evidence = log_sum - math.log(num_traces)
    final_elbo = float(history[-1]) if len(history) else float("nan")
    emp = _decoded_empirical(
        fm, z, observed, map_func, results_only, file_name,
        log_weights=log_w.detach().cpu().numpy().astype(np.float64), effective_sample_size=ess,
    )
    duration = time.time() - t0
    emp.log_evidence = log_evidence
    emp.rename(
        f"Posterior, VI ({guide}, D={dim}, {vi_steps} steps, "
        f"ELBO {final_elbo:.3f}), IS-reweighted draws: {emp.length:,}, "
        f"ESS: {ess:,.2f}"
    )
    emp.add_metadata(
        op="posterior",
        num_traces=num_traces,
        inference_engine="InferenceEngine.VARIATIONAL_INFERENCE",
        guide=guide,
        latent_dim=dim,
        vi_steps=vi_steps,
        vi_particles=vi_particles,
        learning_rate=learning_rate,
        final_elbo=final_elbo,
        elbo_history=history.tolist(),
        log_evidence=log_evidence,
        effective_sample_size=ess,
        vectorized=True,
        fit_seconds=fit_seconds,
        step_graph=graphed,
    )
    if util.verbosity() > 1:
        util.log_print(
            f"[VI] {guide} guide over {dim} latent dim(s): ELBO "
            f"{final_elbo:.3f} after {vi_steps} steps, {emp.length:,} "
            f"reweighted draws (ESS {ess:,.1f}) in {duration:.3f}s"
        )
    return emp
