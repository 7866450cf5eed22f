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
* Bernoulli prior -> ``bernoulli``.

Geometric, NegativeBinomial, Censored and ZeroInflated have no head, as in
the JAX package.  The mixture heads build their ``[B, K]`` parameter
tensors once; the truncated-Normal ones hand them, with one ``low`` and
one ``high`` tensor shared by every component, to the truncated mixture's
kernel.  The LogNormal and StudentT mixtures are scored in plain torch, as
in the JAX package.  The event-shaped head kinds raise with the slice that
brings them.
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
    Exponential,
    Gamma,
    Gumbel,
    HalfCauchy,
    HalfNormal,
    InverseGamma,
    Laplace,
    Logistic,
    LogNormal,
    Mixture,
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
# kinds whose MLP emits means, stddevs and mixing logits, K each (the
# StudentT mixture also K dfs)
_MIXTURE_KINDS = (
    "normal_mixture",
    "uniform_truncated_normal_mixture",
    "poisson_truncated_normal_mixture",
    "positive_lognormal_mixture",
    "studentt_mixture",
)
_PORTED_KINDS = _MIXTURE_KINDS + ("categorical", "bernoulli")


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
    return {}


def _check_kind(kind):
    if kind not in _PORTED_KINDS:
        raise NotImplementedError(
            f"proposal head {kind!r} is not ported yet; it comes with the event-shaped "
            "slice of the distributions: the MultivariateNormal, Dirichlet and LKJ heads, "
            "and the reference's alternative Beta heads"
        )


def head_init(generator, kind, input_dim, device, mixture_components=10, num_categories=None):
    _check_kind(kind)
    meta = {"kind": kind, "mixture_components": mixture_components}
    if kind == "categorical":
        if num_categories is None:
            raise ValueError("a categorical head needs num_categories")
        out_dim = num_categories
        meta["num_categories"] = num_categories
    elif kind == "bernoulli":
        out_dim = 1
    elif kind == "studentt_mixture":
        # means, log-scales, mixing logits and dfs, K each
        out_dim = 4 * mixture_components
        meta["df_floor"] = _DF_FLOOR
    else:
        out_dim = 3 * mixture_components
    return {
        "ff": mlp_init(generator, (input_dim,), (out_dim,), device, num_layers=2),
        "meta": meta,
    }


def _rows(prior_param, B):
    """A prior parameter (a scalar or one value per row) as ``[B]``."""
    return prior_param.reshape(-1).expand(B)


def head_apply(params, x, prior_params):
    """x: [B, H] features; prior_params: dict of scalars or [B] tensors.
    Returns a proposal distribution with batch shape (B,)."""
    _check_kind(params["meta"]["kind"])
    out = mlp_apply(params["ff"], x, activation=torch.relu, activation_last=None)
    return head_distribution(params["meta"], out, prior_params)


def head_distribution(meta, out, prior_params):
    """The proposal of a head whose MLP gave ``out`` [B, out_dim] (the
    gathered heads of the gather loss and of lockstep rounds apply their
    MLPs themselves)."""
    kind = meta["kind"]
    _check_kind(kind)
    B = out.shape[0]
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
    if kind == "poisson_truncated_normal_mixture":
        low = out.new_full((B,), _POISSON_LOW)
        high = out.new_full((B,), _POISSON_HIGH)
        means = low[:, None] + torch.sigmoid(out[:, :K]) * (high - low)[:, None]
        stddevs = torch.exp(out[:, K : 2 * K])
        return Mixture._from_truncated_normal_params(means, stddevs, coeffs, low, high)
    low = _rows(prior_params["low"], B)
    high = _rows(prior_params["high"], B)
    width = (high - low)[:, None]
    means = low[:, None] + torch.sigmoid(out[:, :K]) * width
    stddevs = width / 1000.0 + torch.sigmoid(out[:, K : 2 * K]) * width * 10.0
    return Mixture._from_truncated_normal_params(means, stddevs, coeffs, low, high)


def head_from_numpy(p, device):
    """A head from the JAX package's parameters (``Static`` unwrapped)."""
    meta = dict(p["meta"])
    _check_kind(meta["kind"])
    out = {"kind": meta["kind"], "mixture_components": meta["mixture_components"]}
    if meta["kind"] == "categorical":
        out["num_categories"] = meta["num_categories"]
    if meta["kind"] == "studentt_mixture" and "df_floor" in meta:
        out["df_floor"] = meta["df_floor"]
    return {"ff": mlp_from_numpy(p["ff"], device), "meta": out}


def head_to_numpy(p):
    """The JAX package's layout of a head (the inverse of ``head_from_numpy``)."""
    return {"ff": mlp_to_numpy(p["ff"]), "meta": dict(p["meta"])}
