"""Multinomial distribution, event shape (k,): counts over k categories
summing to ``total_count`` (counterpart of
``pyprob_tpu/distributions/multinomial.py``).

``log_prob`` reduces over the trailing category dimension, with p clipped
to [1e-12, 1].  Draws are the chain of conditional binomials the JAX
package's sampler runs: x_i ~ Binomial(remaining, p_i / Σ_{j≥i} p_j).
It has no proposal head: a Multinomial latent cannot be an IC site.
"""

from __future__ import annotations

import torch

from .. import util
from .distribution import Distribution, _broadcast_shapes, _common_device


class Multinomial(Distribution):
    _param_names = ("total_count", "probs")
    _param_event_dims = (0, 1)

    def __init__(self, total_count=1, probs=None, logits=None):
        if (probs is None) == (logits is None):
            raise ValueError("Provide exactly one of probs, logits")
        device = _common_device(total_count, probs, logits)
        if logits is not None:
            probs = torch.softmax(util.to_tensor(logits, device), dim=-1)
        else:
            probs = util.to_tensor(probs, device)
            probs = probs / probs.sum(dim=-1, keepdim=True)
        if probs.dim() < 1:
            raise ValueError("Multinomial probs must be at least 1-D")
        self._total_count = util.to_tensor(total_count, device)
        self._probs = probs
        self._finish_init()

    def _finish_init(self):
        shape = tuple(self._probs.shape)
        self._event_size = int(shape[-1])
        super().__init__(
            name="Multinomial",
            address_suffix=f"Multinomial(len:{self._event_size})",
            batch_shape=_broadcast_shapes(self._total_count.shape, shape[:-1]),
        )

    @property
    def event_shape(self):
        return (self._event_size,)

    @property
    def probs(self):
        return self._probs

    @property
    def total_count(self):
        return self._total_count

    def _sample(self, generator, shape):
        out_shape = shape + self._batch_shape
        p = self._probs.expand(out_shape + (self._event_size,))
        # the conditional share of category i among categories i..k-1
        tail = p.flip(-1).cumsum(-1).flip(-1)
        ratios = torch.clamp(p / torch.clamp(tail, min=1e-30), 0.0, 1.0)
        remaining = self._total_count.expand(out_shape).contiguous()
        counts = []
        for i in range(self._event_size):
            x = torch.binomial(remaining, ratios[..., i].contiguous(), generator=generator)
            counts.append(x)
            remaining = remaining - x
        return torch.stack(counts, dim=-1)

    def log_prob(self, value, sum=False):
        x = util.to_tensor(value, self._probs.device)
        n = self._total_count
        p = torch.clamp(self._probs, 1e-12, 1.0)
        lp = torch.lgamma(n + 1.0) - torch.lgamma(x + 1.0).sum(-1) + torch.xlogy(x, p).sum(-1)
        return lp.sum() if sum else lp

    @property
    def mean(self):
        n = self._total_count
        return (n[..., None] if n.dim() else n) * self._probs

    @property
    def variance(self):
        return self.mean * (1.0 - self._probs)
