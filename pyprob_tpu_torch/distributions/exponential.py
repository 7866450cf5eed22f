"""Exponential distribution (counterpart of
``pyprob_tpu/distributions/exponential.py``)."""

from __future__ import annotations

import math

import torch

from .. import util
from .distribution import Distribution, _common_device


class Exponential(Distribution):
    _param_names = ("rate",)

    def __init__(self, rate=1.0):
        self._rate = util.to_tensor(rate, _common_device(rate))
        self._finish_init()

    def _finish_init(self):
        super().__init__(name="Exponential", address_suffix="Exponential", batch_shape=self._rate.shape)

    @property
    def rate(self):
        return self._rate

    def _sample(self, generator, shape):
        e = torch.empty(shape + self._batch_shape, dtype=self._rate.dtype, device=self._rate.device)
        return e.exponential_(generator=generator) / self._rate

    def log_prob(self, value, sum=False):
        value = util.to_tensor(value, self._rate.device)
        lp = torch.where(value >= 0, torch.log(self._rate) - self._rate * value, -math.inf)
        return lp.sum() if sum else lp

    def cdf(self, value):
        value = util.to_tensor(value, self._rate.device)
        return -torch.expm1(-self._rate * value)

    def icdf(self, value):
        return -torch.log1p(-util.to_tensor(value, self._rate.device)) / self._rate

    @property
    def mean(self):
        return 1.0 / self._rate

    @property
    def variance(self):
        return 1.0 / self._rate**2
