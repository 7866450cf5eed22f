"""Poisson distribution (counterpart of ``pyprob_tpu/distributions/poisson.py``).

Draws are float counts.  ``log_prob`` is ``xlogy(k, rate) − rate −
lgamma(k + 1)`` on the float value, as the JAX package scores it: a
non-integer value gets that continuous score, a negative integer −inf.
"""

from __future__ import annotations

import torch

from .. import util
from .distribution import Distribution, _common_device


class Poisson(Distribution):
    _param_names = ("rate",)

    def __init__(self, rate):
        self._rate = util.to_tensor(rate, _common_device(rate))
        self._finish_init()

    def _finish_init(self):
        super().__init__(name="Poisson", address_suffix="Poisson", batch_shape=self._rate.shape)

    @property
    def rate(self):
        return self._rate

    def _sample(self, generator, shape):
        rate = self._rate.expand(shape + self._batch_shape).contiguous()
        return torch.poisson(rate, generator=generator)

    def log_prob(self, value, sum=False):
        k = util.to_tensor(value, self._rate.device)
        lp = torch.xlogy(k, self._rate) - self._rate - torch.lgamma(k + 1.0)
        return lp.sum() if sum else lp

    @property
    def mean(self):
        return self._rate

    @property
    def variance(self):
        return self._rate
