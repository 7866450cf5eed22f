"""Per-address proposal heads (counterpart of ``pyprob_tpu/nn/proposals.py``).

Each head maps the network features x [B, H] plus the site's prior
parameters to a batched proposal distribution.  This slice serves the
Normal prior's head, a mixture of K Normals whose means and stddevs are
residual-scaled by the prior; the head builds its ``[B, K]`` parameter
tensors once and hands them to the mixture kernel as they are.  The other
head kinds are recognised and raise with the slice that brings them.
"""

from __future__ import annotations

import torch

from ..distributions import Categorical, Mixture, Normal
from .layers import mlp_apply, mlp_from_numpy, mlp_init, mlp_to_numpy


def head_kind_for(distribution):
    """The proposal head kind for a prior; None if it has no learned
    proposal.  Only the distributions this port has are recognised."""
    if isinstance(distribution, Normal):
        return "normal_mixture"
    if isinstance(distribution, Categorical):
        return "categorical"
    return None


def prior_param_arrays(distribution):
    """The prior parameters the head consumes at apply time."""
    if isinstance(distribution, Normal):
        return {"mean": distribution.mean, "stddev": distribution.stddev}
    return {}


def _check_kind(kind):
    if kind != "normal_mixture":
        raise NotImplementedError(
            f"proposal head {kind!r} is not ported yet; it comes with the "
            "Marsaglia slice"
        )


def head_init(generator, kind, input_dim, device, mixture_components=10):
    _check_kind(kind)
    return {
        "ff": mlp_init(
            generator, (input_dim,), (3 * mixture_components,), device, num_layers=2
        ),
        "meta": {"kind": kind, "mixture_components": mixture_components},
    }


def head_apply(params, x, prior_params):
    """x: [B, H] features; prior_params: dict of scalars or [B] tensors.
    Returns a proposal distribution with batch shape (B,)."""
    meta = params["meta"]
    _check_kind(meta["kind"])
    K = meta["mixture_components"]
    out = mlp_apply(params["ff"], x, activation=torch.relu, activation_last=None)
    B = out.shape[0]
    means = out[:, :K]
    stddevs = torch.exp(out[:, K : 2 * K])
    coeffs = torch.softmax(out[:, 2 * K :], dim=1)
    prior_mean = prior_params["mean"].reshape(-1, 1).expand(B, 1)
    prior_std = prior_params["stddev"].reshape(-1, 1).expand(B, 1)
    means = prior_mean + means * prior_std
    stddevs = stddevs * prior_std
    return Mixture._from_normal_params(means, stddevs, coeffs)


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
