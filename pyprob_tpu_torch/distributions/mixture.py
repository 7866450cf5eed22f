"""Mixture distribution (counterpart of
``pyprob_tpu/distributions/mixture.py``).

``log_prob`` is the logsumexp over component log-densities plus mixing
logits.  Two homogeneous families with a 1-D batch go through hand-written
kernels (``_fused_log_prob``), where the JAX package calls its Pallas
kernels: all-Normal mixtures through ``ops.kernels.mixture_normal_log_prob``
and all-TruncatedNormal mixtures whose components share one ``low`` and
one ``high`` through ``ops.kernels.mixture_truncated_normal_log_prob``.
Both are differentiable, their gradients kernels too on CUDA, and reach
the means, the stddevs and the mixing logits through the ``.contiguous()``
and ``.expand()`` views that feed them (the training loss).  Sampling
draws the component index and gathers one component's parameters per row
for a single draw; the JAX package draws every component and selects one
with a one-hot contraction, so the two agree in distribution, not draw
for draw.
"""

from __future__ import annotations

import torch

from .. import util
from ..ops import kernels
from .distribution import Distribution
from .categorical import Categorical
from .normal import Normal
from .truncated_normal import TruncatedNormal


class Mixture(Distribution):
    _param_names = ()

    def __init__(self, distributions, probs=None, logits=None):
        self._distributions = list(distributions)
        if probs is None and logits is None:
            batch_shape = torch.broadcast_shapes(
                *[d.batch_shape for d in self._distributions]
            )
            K = len(self._distributions)
            probs = torch.full(
                tuple(batch_shape) + (K,),
                1.0 / K,
                dtype=util.dtype(),
                device=self._distributions[0].device,
            )
        self._mixing = Categorical(probs=probs, logits=logits)
        # [B, K] (means, stddevs) of an all-Normal mixture, or [B, K]
        # (means, stddevs) and [B] (low, high) of a truncated one, whose
        # caller already holds them stacked (the proposal heads); None =
        # stack on demand from the components
        self._normal_params = None
        self._tnorm_params = None
        self._finish_init()

    @classmethod
    def _from_normal_params(cls, means, stddevs, probs):
        """Mixture of K Normals from ``[B, K]`` parameter tensors, kept
        stacked for the kernel (the components are column views)."""
        K = means.shape[1]
        comps = [Normal(means[:, i], stddevs[:, i]) for i in range(K)]
        d = cls(comps, probs=probs)
        d._normal_params = (means, stddevs)
        return d

    @classmethod
    def _from_truncated_normal_params(cls, means, stddevs, probs, low, high):
        """Mixture of K TruncatedNormals on one ``[low, high]`` per row from
        ``[B, K]`` parameter tensors and ``[B]`` bounds, kept stacked for
        the kernel."""
        K = means.shape[1]
        comps = [TruncatedNormal(means[:, i], stddevs[:, i], low, high) for i in range(K)]
        d = cls(comps, probs=probs)
        d._tnorm_params = (means, stddevs, low, high)
        return d

    def _finish_init(self):
        self._num_components = len(self._distributions)
        super().__init__(
            name="Mixture",
            address_suffix=f"Mixture({', '.join(d.address_suffix for d in self._distributions)})",
            batch_shape=self._mixing.batch_shape,
        )

    @property
    def device(self):
        return self._mixing.device

    @property
    def distributions(self):
        return self._distributions

    @property
    def mixing_distribution(self):
        return self._mixing

    @property
    def probs(self):
        return self._mixing.probs

    def _stacked_normal_params(self):
        """``[B, K]`` (means, stddevs) when every component is a Normal and
        the batch is 1-D, else None."""
        if self._normal_params is not None:
            return self._normal_params
        if len(self._batch_shape) != 1 or not all(
            isinstance(d, Normal) for d in self._distributions
        ):
            return None
        B = self._batch_shape[0]
        means = torch.stack([d.loc.expand(B) for d in self._distributions], -1)
        stddevs = torch.stack([d.scale.expand(B) for d in self._distributions], -1)
        return means, stddevs

    def _stacked_tnorm_params(self):
        """``[B, K]`` (means, stddevs) and ``[B]`` (low, high) when every
        component is a TruncatedNormal on the same bounds (the same tensors,
        as the JAX package checks) and the batch is 1-D, else None."""
        if self._tnorm_params is not None:
            return self._tnorm_params
        comps = self._distributions
        if len(self._batch_shape) != 1 or not all(
            isinstance(d, TruncatedNormal)
            and d.low is comps[0].low
            and d.high is comps[0].high
            for d in comps
        ):
            return None
        B = self._batch_shape[0]
        means = torch.stack([d.mean_non_truncated.expand(B) for d in comps], -1)
        stddevs = torch.stack([d.stddev_non_truncated.expand(B) for d in comps], -1)
        return means, stddevs, comps[0].low.expand(B), comps[0].high.expand(B)

    def log_prob(self, value, sum=False):
        value = util.to_tensor(value, self.device)
        fused = self._fused_log_prob(value)
        if fused is not None:
            return fused.sum() if sum else fused
        comp = torch.stack([d.log_prob(value) for d in self._distributions], -1)
        lp = torch.logsumexp(comp + self._mixing.logits, dim=-1)
        return lp.sum() if sum else lp

    def _fused_log_prob(self, value):
        """The kernel path for all-Normal and shared-bounds all-TruncatedNormal
        mixtures with a 1-D batch scored at one value per row; None when
        the shapes don't fit."""
        if value.dim() != 1 or self._batch_shape != tuple(value.shape):
            return None
        params = self._stacked_normal_params()
        if params is not None:
            means, stddevs = params
            logits = self._mixing.logits.expand(means.shape)
            return kernels.mixture_normal_log_prob(
                value.contiguous(),
                means.contiguous(),
                stddevs.contiguous(),
                logits.contiguous(),
            )
        params = self._stacked_tnorm_params()
        if params is not None:
            means, stddevs, low, high = params
            logits = self._mixing.logits.expand(means.shape)
            return kernels.mixture_truncated_normal_log_prob(
                value.contiguous(),
                means.contiguous(),
                stddevs.contiguous(),
                logits.contiguous(),
                low.contiguous(),
                high.contiguous(),
            )
        return None

    def _sample(self, generator, shape):
        stacked = (
            self._stacked_normal_params() or self._stacked_tnorm_params()
            if shape == ()
            else None
        )
        if stacked is not None:
            # (means, stddevs) or (means, stddevs, low, high)
            idx = self._mixing._sample(generator, ()).unsqueeze(-1)
            loc = torch.gather(stacked[0], -1, idx).squeeze(-1)
            scale = torch.gather(stacked[1], -1, idx).squeeze(-1)
            if len(stacked) == 2:
                return Normal(loc, scale)._sample(generator, ())
            return TruncatedNormal(loc, scale, *stacked[2:])._sample(generator, ())
        idx = self._mixing._sample(generator, shape)
        draws = torch.stack(
            [d._sample(generator, shape).expand(idx.shape) for d in self._distributions],
            dim=-1,
        )
        return torch.gather(draws, -1, idx.unsqueeze(-1)).squeeze(-1)

    @property
    def mean(self):
        w = torch.exp(self._mixing.logits)
        means = torch.stack(
            [d.mean.expand(self._batch_shape) for d in self._distributions], -1
        )
        return torch.sum(w * means, -1)

    @property
    def variance(self):
        w = torch.exp(self._mixing.logits)
        means = torch.stack(
            [d.mean.expand(self._batch_shape) for d in self._distributions], -1
        )
        variances = torch.stack(
            [d.variance.expand(self._batch_shape) for d in self._distributions], -1
        )
        m = torch.sum(w * means, -1)
        return torch.sum(w * (variances + means**2), -1) - m**2
