"""Per-address proposal heads (counterpart of ``pyprob_tpu/nn/proposals.py``).

Each head maps the network features x [B, H] plus the site's prior
parameters to a batched proposal distribution.  Ported so far:

* Normal prior -> ``normal_mixture``: a mixture of K Normals whose means and
  stddevs are residual-scaled by the prior;
* Uniform prior -> ``uniform_truncated_normal_mixture``: a mixture of K
  TruncatedNormals on the prior's [low, high], means squashed into it and
  stddevs scaled by its width.

The heads build their ``[B, K]`` parameter tensors once and hand them to
the mixture kernels as they are.  The other head kinds are recognised and
raise with the slice that brings them.
"""

from __future__ import annotations

import torch

from ..distributions import Categorical, Mixture, Normal, Uniform
from .layers import mlp_apply, mlp_from_numpy, mlp_init, mlp_to_numpy

_PORTED_KINDS = ("normal_mixture", "uniform_truncated_normal_mixture")


def head_kind_for(distribution):
    """The proposal head kind for a prior; None if it has no learned
    proposal.  Only the distributions this port has are recognised."""
    if isinstance(distribution, Normal):
        return "normal_mixture"
    if isinstance(distribution, Uniform):
        return "uniform_truncated_normal_mixture"
    if isinstance(distribution, Categorical):
        return "categorical"
    return None


def prior_param_arrays(distribution):
    """The prior parameters the head consumes at apply time."""
    if isinstance(distribution, Normal):
        return {"mean": distribution.mean, "stddev": distribution.stddev}
    if isinstance(distribution, Uniform):
        return {"low": distribution.low, "high": distribution.high}
    return {}


def _check_kind(kind):
    if kind not in _PORTED_KINDS:
        raise NotImplementedError(
            f"proposal head {kind!r} is not ported yet; it comes with the "
            "distributions slice, beside its prior distributions"
        )


def head_init(generator, kind, input_dim, device, mixture_components=10):
    _check_kind(kind)
    return {
        "ff": mlp_init(
            generator, (input_dim,), (3 * mixture_components,), device, num_layers=2
        ),
        "meta": {"kind": kind, "mixture_components": mixture_components},
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
    """The proposal of a head whose MLP gave ``out`` [B, 3K] (the gathered
    heads of the gather loss and of lockstep rounds apply their MLPs
    themselves)."""
    kind = meta["kind"]
    _check_kind(kind)
    K = meta["mixture_components"]
    B = out.shape[0]
    coeffs = torch.softmax(out[:, 2 * K :], dim=1)
    if kind == "normal_mixture":
        prior_mean = _rows(prior_params["mean"], B)[:, None]
        prior_std = _rows(prior_params["stddev"], B)[:, None]
        means = prior_mean + out[:, :K] * prior_std
        stddevs = torch.exp(out[:, K : 2 * K]) * prior_std
        return Mixture._from_normal_params(means, stddevs, coeffs)
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
    return {
        "ff": mlp_from_numpy(p["ff"], device),
        "meta": {"kind": meta["kind"], "mixture_components": meta["mixture_components"]},
    }


def head_to_numpy(p):
    """The JAX package's layout of a head (the inverse of ``head_from_numpy``)."""
    return {"ff": mlp_to_numpy(p["ff"]), "meta": dict(p["meta"])}
