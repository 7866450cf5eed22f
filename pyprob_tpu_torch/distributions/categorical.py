"""Categorical distribution (counterpart of
``pyprob_tpu/distributions/categorical.py``).

Logits built from ``probs`` are ``log(clip(probs / Σprobs, 1e-38))``, not a
``log_softmax``, as in the JAX package: the mixture heads' scores depend on
that order of operations.  XLA flushes float32 subnormals to zero, so
there a probability below ``finfo(float32).tiny`` (and the clip bound
1e-38 itself) gives logit −inf; the port does the same.  The address
suffix carries the category count.
"""

from __future__ import annotations

import torch

from .. import util
from .distribution import Distribution, _common_device


class Categorical(Distribution):
    _param_names = ("logits",)

    def __init__(self, probs=None, logits=None):
        if (probs is None) == (logits is None):
            raise ValueError("Provide exactly one of probs, logits")
        if probs is not None:
            probs = util.to_tensor(probs, _common_device(probs))
            probs = probs / probs.sum(dim=-1, keepdim=True)
            flushed = probs < torch.finfo(probs.dtype).tiny
            self._logits = torch.log(torch.where(flushed, torch.zeros_like(probs), probs))
        else:
            logits = util.to_tensor(logits, _common_device(logits))
            self._logits = torch.log_softmax(logits, dim=-1)
        self._finish_init()

    def _finish_init(self):
        shape = tuple(self._logits.shape)
        self._num_categories = int(shape[-1])
        super().__init__(
            name="Categorical",
            address_suffix=f"Categorical(len_probs:{self._num_categories})",
            batch_shape=shape[:-1],
        )

    @property
    def num_categories(self):
        return self._num_categories

    @property
    def logits(self):
        return self._logits

    @property
    def probs(self):
        return torch.exp(self._logits)

    def _sample(self, generator, shape):
        # inverse CDF, as the JAX package's host sampler
        cdf = torch.cumsum(torch.exp(self._logits), dim=-1)
        cdf = cdf / cdf[..., -1:]
        u = torch.rand(
            shape + self._batch_shape + (1,),
            generator=generator,
            dtype=cdf.dtype,
            device=cdf.device,
        )
        idx = (u > cdf).sum(dim=-1)
        return torch.clamp(idx, max=self._num_categories - 1)

    def log_prob(self, value, sum=False):
        idx = torch.as_tensor(value, device=self._logits.device)
        if idx.is_floating_point():
            idx = torch.round(idx)
        idx = idx.long()
        common = torch.broadcast_shapes(idx.shape, self._batch_shape)
        idx = idx.expand(common)
        logits = self._logits.expand(common + (self._num_categories,))
        lp = torch.gather(logits, -1, idx.unsqueeze(-1)).squeeze(-1)
        return lp.sum() if sum else lp

    @property
    def mean(self):
        k = torch.arange(self._num_categories, device=self._logits.device)
        return torch.sum(torch.exp(self._logits) * k, -1)

    @property
    def variance(self):
        k = torch.arange(self._num_categories, device=self._logits.device)
        p = torch.exp(self._logits)
        m = torch.sum(p * k, -1)
        return torch.sum(p * k * k, -1) - m**2
