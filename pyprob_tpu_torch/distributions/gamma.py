"""Gamma distribution, shape and rate (counterpart of
``pyprob_tpu/distributions/gamma.py``)."""

from __future__ import annotations

import math

import torch

from .. import util
from .distribution import Distribution, _broadcast_shapes, _tensors


class Gamma(Distribution):
    _param_names = ("concentration", "rate")

    def __init__(self, concentration, rate=1.0):
        self._concentration, self._rate = _tensors(concentration, rate)
        self._finish_init()

    def _finish_init(self):
        batch_shape = _broadcast_shapes(self._concentration.shape, self._rate.shape)
        super().__init__(name="Gamma", address_suffix="Gamma", batch_shape=batch_shape)

    @property
    def concentration(self):
        return self._concentration

    @property
    def rate(self):
        return self._rate

    def _sample(self, generator, shape):
        return self._standard_gamma(generator, shape, self._concentration) / self._rate

    def log_prob(self, value, sum=False):
        x = util.to_tensor(value, self._rate.device)
        a, r = self._concentration, self._rate
        lp = torch.where(
            x > 0,
            torch.xlogy(a, r) + torch.xlogy(a - 1.0, x) - r * x - torch.lgamma(a),
            -math.inf,
        )
        return lp.sum() if sum else lp

    def cdf(self, value):
        x = util.to_tensor(value, self._rate.device)
        return torch.special.gammainc(self._concentration, self._rate * x)

    @property
    def mean(self):
        return self._concentration / self._rate

    @property
    def variance(self):
        return self._concentration / self._rate**2
