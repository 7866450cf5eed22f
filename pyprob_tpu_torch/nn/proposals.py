"""Per-address proposal heads (counterpart of ``pyprob_tpu/nn/proposals.py``).

Each head maps the network features x [B, H] plus the site's prior
parameters to a batched proposal distribution.  Ported so far:

* Normal prior -> ``normal_mixture``: a mixture of K Normals whose means and
  stddevs are residual-scaled by the prior;
* Uniform, Beta and VonMises priors -> ``uniform_truncated_normal_mixture``:
  a mixture of K TruncatedNormals on the prior's [low, high] (Beta's
  bounds, one period centred on VonMises' location), means squashed into
  it and stddevs scaled by its width;
* Poisson prior -> ``poisson_truncated_normal_mixture``: a mixture of K
  TruncatedNormals on [0, 40], means squashed into it (its draws are real
  values, as the JAX package's);
* the positive-support priors (Gamma, Exponential, LogNormal, Weibull,
  Chi2, HalfNormal, HalfCauchy, InverseGamma, Pareto) ->
  ``positive_lognormal_mixture``: a mixture of K LogNormals residual-scaled
  in log space by the prior's exact log-space moments;
* the heavy-tailed priors (StudentT, Laplace, Cauchy, Logistic, Gumbel) ->
  ``studentt_mixture``: a mixture of K StudentTs whose means and scales are
  residual-scaled by the prior's reference (loc, scale), with a learned df
  per component of ``meta["df_floor"]`` (0.5 for new heads, 1.0 for a
  carried head that does not record it) + softplus;
* Categorical prior -> ``categorical`` over the site's categories;
* Bernoulli prior -> ``bernoulli``;
* MultivariateNormal prior -> ``mvn``: a full-covariance Normal whose mean
  is the prior's plus L_prior·raw and whose scale is L_prior·M, M lower
  triangular with diagonal exp(clip(raw, ±10)): a zeroed head proposes
  the prior itself;
* Dirichlet prior -> ``dirichlet``: α = α_prior·exp(clip(raw, ±10)) + 1e-6;
* LKJCholesky prior -> ``lkj_cpc_normal``: Normals on the canonical
  partial correlations (``LKJCholeskyCPCNormal``), log-scales clipped to
  [−8, 4].

The reference's alternative heads ``normal_normal`` (one Normal),
``uniform_beta`` (one Beta on the prior's bounds) and
``uniform_beta_mixture`` (K of them) are never picked by
``head_kind_for`` but are built by ``head_init`` and ``head_apply``.  The
event-shaped heads take an ``event_dim`` (D for the MVN and Dirichlet
heads, d for the LKJ head) and read their prior parameters as rows of
``[B, D]`` or ``[B, D, D]``, whatever batch the prior's parameters had.
Geometric, NegativeBinomial, Multinomial, Censored and ZeroInflated have
no head, as in the JAX package.  The mixture heads build their ``[B, K]``
parameter tensors once; the truncated-Normal ones hand them, with one
``low`` and one ``high`` tensor shared by every component, to the
truncated mixture's kernel.  The LogNormal, StudentT and Beta mixtures are
scored in plain torch, as in the JAX package.
"""

from __future__ import annotations

import math

import torch

from ..distributions import (
    Bernoulli,
    Beta,
    Categorical,
    Cauchy,
    Chi2,
    Dirichlet,
    Exponential,
    Gamma,
    Gumbel,
    HalfCauchy,
    HalfNormal,
    InverseGamma,
    LKJCholesky,
    LKJCholeskyCPCNormal,
    Laplace,
    Logistic,
    LogNormal,
    Mixture,
    MultivariateNormal,
    Normal,
    Pareto,
    Poisson,
    StudentT,
    Uniform,
    VonMises,
    Weibull,
)
from .layers import mlp_apply, mlp_from_numpy, mlp_init, mlp_to_numpy

_EPSILON = 1e-6
_POISSON_LOW = 0.0
_POISSON_HIGH = 40.0
_EULER_GAMMA = 0.5772156649015329
_PI_OVER_SQRT6 = math.pi / math.sqrt(6.0)

_POSITIVE_LOGNORMAL_PRIORS = (
    Gamma,
    Exponential,
    LogNormal,
    Weibull,
    Chi2,
    HalfNormal,
    HalfCauchy,
    InverseGamma,
    Pareto,
)
_STUDENTT_PRIORS = (StudentT, Laplace, Cauchy, Logistic, Gumbel)
# the df floor a new StudentT-mixture head records in its meta: the head can
# learn tails heavier than a Cauchy prior's (df 1)
_DF_FLOOR = 0.5
# kinds whose MLP emits K each of two parameters and the mixing logits
_MIXTURE_KINDS = (
    "normal_mixture",
    "uniform_truncated_normal_mixture",
    "poisson_truncated_normal_mixture",
    "uniform_beta_mixture",
    "positive_lognormal_mixture",
)
_EVENT_KINDS = ("mvn", "dirichlet", "lkj_cpc_normal")


def head_kind_for(distribution):
    """The proposal head kind for a prior; None if it has no learned
    proposal.  Only the distributions this port has are recognised."""
    if isinstance(distribution, Normal):
        return "normal_mixture"
    if isinstance(distribution, (Uniform, Beta, VonMises)):
        return "uniform_truncated_normal_mixture"
    if isinstance(distribution, Poisson):
        return "poisson_truncated_normal_mixture"
    if isinstance(distribution, Categorical):
        return "categorical"
    if isinstance(distribution, Bernoulli):
        return "bernoulli"
    if isinstance(distribution, _POSITIVE_LOGNORMAL_PRIORS):
        return "positive_lognormal_mixture"
    if isinstance(distribution, _STUDENTT_PRIORS):
        return "studentt_mixture"
    if isinstance(distribution, MultivariateNormal):
        return "mvn"
    if isinstance(distribution, Dirichlet):
        return "dirichlet"
    if isinstance(distribution, LKJCholesky):
        return "lkj_cpc_normal"
    return None


def event_dim_for(distribution):
    """The event dimension an event-shaped head is built for (None for the
    scalar heads): D of a MultivariateNormal or Dirichlet, d of an
    LKJCholesky."""
    if isinstance(distribution, (MultivariateNormal, Dirichlet)):
        return int(distribution.event_shape[0])
    if isinstance(distribution, LKJCholesky):
        return distribution.dim
    return None


def _log_space_moments(distribution):
    """The exact (mean, stddev) of log X under a positive-support prior, the
    point the LogNormal-mixture head residual-scales by."""
    if isinstance(distribution, LogNormal):
        return distribution.loc, distribution.scale
    if isinstance(distribution, Exponential):
        # log X = −log rate + log E, E ~ Exp(1): E[log E] = −γ, Std = π/√6
        rate = distribution.rate
        return -torch.log(rate) - _EULER_GAMMA, torch.full_like(rate, _PI_OVER_SQRT6)
    if isinstance(distribution, Gamma):
        a, r = distribution.concentration, distribution.rate
        return torch.digamma(a) - torch.log(r), torch.sqrt(torch.polygamma(1, a))
    if isinstance(distribution, Chi2):
        # Chi2(df) = Gamma(df/2, 1/2)
        half_df = distribution.df / 2.0
        return torch.digamma(half_df) + math.log(2.0), torch.sqrt(torch.polygamma(1, half_df))
    if isinstance(distribution, Weibull):
        # X = scale · E^(1/k), E ~ Exp(1)
        lam, k = distribution.scale, distribution.concentration
        return torch.log(lam) - _EULER_GAMMA / k, _PI_OVER_SQRT6 / k
    if isinstance(distribution, HalfNormal):
        # E[log X] = log scale + (ψ(1/2) + log 2)/2, Std = √ψ'(1/2) / 2
        s = distribution.scale
        return torch.log(s) - 0.6351814227307392, torch.full_like(s, 1.1107207345395915)
    if isinstance(distribution, HalfCauchy):
        # no log-moments (heavy tails): the median with a wide spread
        s = distribution.scale
        return torch.log(s), torch.full_like(s, 2.0)
    if isinstance(distribution, InverseGamma):
        # log X = log rate − log Gamma(a, 1)
        a, r = distribution.concentration, distribution.rate
        return torch.log(r) - torch.digamma(a), torch.sqrt(torch.polygamma(1, a))
    if isinstance(distribution, Pareto):
        # log X = log scale + E/α, E ~ Exp(1)
        m, a = distribution.scale, distribution.alpha
        return torch.log(m) + 1.0 / a, 1.0 / a
    raise ValueError(f"No log-space moments for {distribution.name}")


def _location_scale_ref(distribution):
    """The (loc, scale) a heavy-tailed prior's StudentT-mixture head
    residual-scales by: the location and a scale of the prior's spread
    (its standard deviation where it has one)."""
    if isinstance(distribution, (StudentT, Cauchy)):
        return distribution.loc, distribution.scale
    if isinstance(distribution, Laplace):
        return distribution.loc, distribution.scale * math.sqrt(2.0)
    if isinstance(distribution, Logistic):
        return distribution.loc, distribution.scale * (math.pi / math.sqrt(3.0))
    if isinstance(distribution, Gumbel):
        return distribution.loc + _EULER_GAMMA * distribution.scale, distribution.scale * _PI_OVER_SQRT6
    raise ValueError(f"No location/scale reference for {distribution.name}")


def prior_param_arrays(distribution):
    """The prior parameters the head consumes at apply time."""
    if isinstance(distribution, Normal):
        return {"mean": distribution.mean, "stddev": distribution.stddev}
    if isinstance(distribution, (Uniform, Beta)):
        return {"low": distribution.low, "high": distribution.high}
    if isinstance(distribution, VonMises):
        # one full period centred on the prior's location covers the support
        loc = distribution.loc
        return {"low": loc - math.pi, "high": loc + math.pi}
    if isinstance(distribution, _POSITIVE_LOGNORMAL_PRIORS):
        log_loc, log_scale = _log_space_moments(distribution)
        return {"log_loc": log_loc, "log_scale": log_scale}
    if isinstance(distribution, _STUDENTT_PRIORS):
        loc, scale = _location_scale_ref(distribution)
        return {"loc": loc, "scale": scale}
    if isinstance(distribution, MultivariateNormal):
        return {"loc": distribution.loc, "scale_tril": distribution.scale_tril}
    if isinstance(distribution, Dirichlet):
        return {"concentration": distribution.concentration}
    return {}  # LKJCholesky: the CPC-normal head reads no prior parameter


def head_init(generator, kind, input_dim, device, mixture_components=10, num_categories=None,
              event_dim=None):
    meta = {"kind": kind, "mixture_components": mixture_components}
    if kind in _MIXTURE_KINDS:
        out_dim = 3 * mixture_components
    elif kind == "studentt_mixture":
        # means, log-scales, mixing logits and dfs, K each
        out_dim = 4 * mixture_components
        meta["df_floor"] = _DF_FLOOR
    elif kind in ("normal_normal", "uniform_beta"):
        out_dim = 2
    elif kind == "categorical":
        if num_categories is None:
            raise ValueError("a categorical head needs num_categories")
        out_dim = num_categories
        meta["num_categories"] = num_categories
    elif kind == "bernoulli":
        out_dim = 1
    elif kind in _EVENT_KINDS:
        if event_dim is None:
            raise ValueError(f"a {kind} head needs event_dim")
        D = event_dim
        # mvn: residual mean D, Cholesky diagonal D, strict lower triangle
        # D(D-1)/2; lkj: means and log-scales of the D(D-1)/2 partial
        # correlations
        out_dim = {"mvn": D + D * (D + 1) // 2, "dirichlet": D, "lkj_cpc_normal": D * (D - 1)}[kind]
        meta["event_dim"] = event_dim
    else:
        raise ValueError(f"Unknown proposal head kind: {kind}")
    return {
        "ff": mlp_init(generator, (input_dim,), (out_dim,), device, num_layers=2),
        "meta": meta,
    }


def _rows(prior_param, B, event_shape=()):
    """A prior parameter (shared, or one value per row) as ``[B]`` +
    ``event_shape``."""
    return prior_param.reshape((-1,) + event_shape).expand((B,) + event_shape)


def head_apply(params, x, prior_params):
    """x: [B, H] features; prior_params: dict of the prior's parameters,
    shared or one a row, in any shape with their elements in row order
    (``[B]``, ``[B, 1]``, ``[D]``, ``[B, D·D]``, ...).  Returns a proposal
    distribution with batch shape (B,)."""
    out = mlp_apply(params["ff"], x, activation=torch.relu, activation_last=None)
    return head_distribution(params["meta"], out, prior_params)


def head_distribution(meta, out, prior_params):
    """The proposal of a head whose MLP gave ``out`` [B, out_dim] (the
    gathered heads of the gather loss and of lockstep rounds apply their
    MLPs themselves)."""
    kind = meta["kind"]
    B = out.shape[0]
    if kind in _EVENT_KINDS:
        return _event_head_distribution(kind, meta["event_dim"], out, prior_params)
    if kind == "normal_normal":
        prior_mean = _rows(prior_params["mean"], B)
        prior_std = _rows(prior_params["stddev"], B)
        return Normal(prior_mean + out[:, 0] * prior_std, torch.exp(out[:, 1]) * prior_std)
    if kind == "uniform_beta":
        low, high = _rows(prior_params["low"], B), _rows(prior_params["high"], B)
        softplus = torch.nn.functional.softplus
        return Beta(1.0 + softplus(out[:, 0]), 1.0 + softplus(out[:, 1]), low=low, high=high)
    if kind == "categorical":
        return Categorical(probs=torch.softmax(out, dim=1) + _EPSILON)
    if kind == "bernoulli":
        return Bernoulli(probs=torch.clamp(torch.sigmoid(out[:, 0]) + _EPSILON, 0.0, 1.0))
    K = meta["mixture_components"]
    if kind == "studentt_mixture":
        loc = _rows(prior_params["loc"], B)[:, None]
        scale = _rows(prior_params["scale"], B)[:, None]
        means = loc + out[:, :K] * scale
        scales = torch.exp(out[:, K : 2 * K]) * scale
        coeffs = torch.softmax(out[:, 2 * K : 3 * K], dim=1)
        dfs = meta.get("df_floor", 1.0) + torch.nn.functional.softplus(out[:, 3 * K :])
        return Mixture._from_studentt_params(dfs, means, scales, coeffs)
    coeffs = torch.softmax(out[:, 2 * K :], dim=1)
    if kind == "normal_mixture":
        prior_mean = _rows(prior_params["mean"], B)[:, None]
        prior_std = _rows(prior_params["stddev"], B)[:, None]
        means = prior_mean + out[:, :K] * prior_std
        stddevs = torch.exp(out[:, K : 2 * K]) * prior_std
        return Mixture._from_normal_params(means, stddevs, coeffs)
    if kind == "positive_lognormal_mixture":
        log_loc = _rows(prior_params["log_loc"], B)[:, None]
        log_scale = _rows(prior_params["log_scale"], B)[:, None]
        means = log_loc + out[:, :K] * log_scale
        stddevs = torch.exp(out[:, K : 2 * K]) * log_scale
        return Mixture([LogNormal(means[:, i], stddevs[:, i]) for i in range(K)], probs=coeffs)
    if kind == "uniform_beta_mixture":
        low, high = _rows(prior_params["low"], B), _rows(prior_params["high"], B)
        c1s = 1.0 + torch.nn.functional.softplus(out[:, :K])
        c0s = 1.0 + torch.nn.functional.softplus(out[:, K : 2 * K])
        return Mixture([Beta(c1s[:, i], c0s[:, i], low=low, high=high) for i in range(K)], probs=coeffs)
    if kind == "poisson_truncated_normal_mixture":
        low = out.new_full((B,), _POISSON_LOW)
        high = out.new_full((B,), _POISSON_HIGH)
        means = low[:, None] + torch.sigmoid(out[:, :K]) * (high - low)[:, None]
        stddevs = torch.exp(out[:, K : 2 * K])
        return Mixture._from_truncated_normal_params(means, stddevs, coeffs, low, high)
    if kind != "uniform_truncated_normal_mixture":
        raise ValueError(f"Unknown proposal head kind: {kind}")
    low = _rows(prior_params["low"], B)
    high = _rows(prior_params["high"], B)
    width = (high - low)[:, None]
    means = low[:, None] + torch.sigmoid(out[:, :K]) * width
    stddevs = width / 1000.0 + torch.sigmoid(out[:, K : 2 * K]) * width * 10.0
    return Mixture._from_truncated_normal_params(means, stddevs, coeffs, low, high)


def _event_head_distribution(kind, D, out, prior_params):
    B = out.shape[0]
    if kind == "mvn":
        loc = _rows(prior_params["loc"], B, (D,))
        L_prior = _rows(prior_params["scale_tril"], B, (D, D))
        mean = loc + torch.matmul(L_prior, out[:, :D, None])[..., 0]
        # M's strict lower triangle in row-major order, then its diagonal
        rows, cols = torch.tril_indices(D, D, offset=-1, device=out.device)
        diag = torch.arange(D, device=out.device)
        at = torch.cat([rows * D + cols, diag * (D + 1)])
        entries = torch.cat([out[:, 2 * D :], torch.exp(torch.clamp(out[:, D : 2 * D], -10.0, 10.0))], dim=1)
        M = out.new_zeros((B, D * D)).index_copy(1, at, entries).reshape(B, D, D)
        return MultivariateNormal(mean, scale_tril=torch.matmul(L_prior, M))
    if kind == "dirichlet":
        conc = _rows(prior_params["concentration"], B, (D,))
        return Dirichlet(conc * torch.exp(torch.clamp(out[:, :D], -10.0, 10.0)) + _EPSILON)
    k = D * (D - 1) // 2
    return LKJCholeskyCPCNormal(out[:, :k], torch.clamp(out[:, k:], -8.0, 4.0), dim=D)


def head_from_numpy(p, device):
    """A head from the JAX package's parameters (``Static`` unwrapped)."""
    meta = dict(p["meta"])
    out = {"kind": meta["kind"], "mixture_components": meta["mixture_components"]}
    if meta["kind"] == "categorical":
        out["num_categories"] = meta["num_categories"]
    if meta["kind"] == "studentt_mixture" and "df_floor" in meta:
        out["df_floor"] = meta["df_floor"]
    if meta["kind"] in _EVENT_KINDS:
        out["event_dim"] = meta["event_dim"]
    return {"ff": mlp_from_numpy(p["ff"], device), "meta": out}


def head_to_numpy(p):
    """The JAX package's layout of a head (the inverse of ``head_from_numpy``)."""
    return {"ff": mlp_to_numpy(p["ff"]), "meta": dict(p["meta"])}
