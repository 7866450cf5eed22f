"""Binomial distribution (counterpart of ``pyprob_tpu/distributions/binomial.py``).

``log_prob`` scores the log binomial coefficient by ``lgamma`` of the
float count, as the JAX package does, so a non-integer value gets the
same (continuous) score there and here.
"""

from __future__ import annotations

import torch

from .. import util
from .distribution import Distribution, _broadcast_shapes, _common_device


class Binomial(Distribution):
    _param_names = ("total_count", "probs")

    def __init__(self, total_count=1, probs=None, logits=None):
        if (probs is None) == (logits is None):
            raise ValueError("Provide exactly one of probs, logits")
        device = _common_device(total_count, probs, logits)
        if logits is not None:
            self._probs = torch.sigmoid(util.to_tensor(logits, device))
        else:
            self._probs = util.to_tensor(probs, device)
        self._total_count = util.to_tensor(total_count, device)
        self._finish_init()

    def _finish_init(self):
        batch_shape = _broadcast_shapes(self._total_count.shape, self._probs.shape)
        super().__init__(name="Binomial", address_suffix="Binomial", batch_shape=batch_shape)

    @property
    def probs(self):
        return self._probs

    @property
    def total_count(self):
        return self._total_count

    @property
    def logits(self):
        p = torch.clamp(self._probs, 1e-12, 1.0 - 1e-12)
        return torch.log(p) - torch.log1p(-p)

    def _sample(self, generator, shape):
        full = shape + self._batch_shape
        return torch.binomial(
            self._total_count.expand(full).contiguous(),
            self._probs.expand(full).contiguous(),
            generator=generator,
        )

    def log_prob(self, value, sum=False):
        k = util.to_tensor(value, self._probs.device)
        n = self._total_count
        p = torch.clamp(self._probs, 1e-12, 1.0 - 1e-12)
        log_binom = torch.lgamma(n + 1.0) - torch.lgamma(k + 1.0) - torch.lgamma(n - k + 1.0)
        lp = log_binom + torch.xlogy(k, p) + torch.special.xlog1py(n - k, -p)
        return lp.sum() if sum else lp

    @property
    def mean(self):
        return self._total_count * self._probs

    @property
    def variance(self):
        return self._total_count * self._probs * (1.0 - self._probs)
