"""Mixture distribution (counterpart of
``pyprob_tpu/distributions/mixture.py``).

``log_prob`` is the logsumexp over component log-densities plus mixing
logits.  All-Normal mixtures with a 1-D batch go through the hand-written
kernel behind ``ops.kernels.mixture_normal_log_prob`` (``_fused_log_prob``),
where the JAX package calls its Pallas kernel; it is differentiable, its
gradient a kernel too on CUDA, and reaches the means, the stddevs and the
mixing logits through the ``.contiguous()`` and ``.expand()`` views that
feed it (the training loss).  Sampling draws the
component index and gathers one Normal per row; the JAX package draws
every component and selects one with a one-hot contraction, so the two
agree in distribution, not draw for draw.
"""

from __future__ import annotations

import torch

from .. import util
from ..ops import kernels
from .distribution import Distribution
from .categorical import Categorical
from .normal import Normal


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
        # [B, K] (means, stddevs) of an all-Normal mixture whose caller
        # already holds them stacked (the proposal head); None = stack on
        # demand from the components
        self._normal_params = None
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

    def log_prob(self, value, sum=False):
        value = util.to_tensor(value, self.device)
        fused = self._fused_log_prob(value)
        if fused is not None:
            return fused.sum() if sum else fused
        comp = torch.stack([d.log_prob(value) for d in self._distributions], -1)
        lp = torch.logsumexp(comp + self._mixing.logits, dim=-1)
        return lp.sum() if sum else lp

    def _fused_log_prob(self, value):
        """The kernel path for all-Normal mixtures with a 1-D batch scored
        at one value per row; None when the shapes don't fit."""
        if value.dim() != 1 or self._batch_shape != tuple(value.shape):
            return None
        params = self._stacked_normal_params()
        if params is None:
            return None
        means, stddevs = params
        logits = self._mixing.logits.expand(means.shape)
        return kernels.mixture_normal_log_prob(
            value.contiguous(),
            means.contiguous(),
            stddevs.contiguous(),
            logits.contiguous(),
        )

    def _sample(self, generator, shape):
        params = self._stacked_normal_params() if shape == () else None
        if params is not None:
            means, stddevs = params
            idx = self._mixing._sample(generator, ()).unsqueeze(-1)
            loc = torch.gather(means, -1, idx).squeeze(-1)
            scale = torch.gather(stddevs, -1, idx).squeeze(-1)
            return Normal(loc, scale)._sample(generator, ())
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
