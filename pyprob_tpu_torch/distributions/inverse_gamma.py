"""InverseGamma distribution: X ~ InverseGamma(α, β) iff 1/X ~ Gamma(α,
rate=β) (counterpart of ``pyprob_tpu/distributions/inverse_gamma.py``).
The mean is NaN for α ≤ 1 and the variance for α ≤ 2, as there."""

from __future__ import annotations

import math

import torch

from .. import util
from .distribution import Distribution, _broadcast_shapes, _tensors


class InverseGamma(Distribution):
    _param_names = ("concentration", "rate")

    def __init__(self, concentration, rate=1.0):
        self._concentration, self._rate = _tensors(concentration, rate)
        self._finish_init()

    def _finish_init(self):
        batch_shape = _broadcast_shapes(self._concentration.shape, self._rate.shape)
        super().__init__(name="InverseGamma", address_suffix="InverseGamma", batch_shape=batch_shape)

    @property
    def concentration(self):
        return self._concentration

    @property
    def rate(self):
        return self._rate

    def _sample(self, generator, shape):
        return self._rate / self._standard_gamma(generator, shape, self._concentration)

    def log_prob(self, value, sum=False):
        x = util.to_tensor(value, self._rate.device)
        a, r = self._concentration, self._rate
        safe = torch.where(x > 0, x, torch.ones_like(x))
        lp = torch.where(
            x > 0,
            torch.xlogy(a, r) - torch.lgamma(a) - (a + 1.0) * torch.log(safe) - r / safe,
            -math.inf,
        )
        return lp.sum() if sum else lp

    def cdf(self, value):
        x = util.to_tensor(value, self._rate.device)
        safe = torch.where(x > 0, x, torch.ones_like(x))
        upper = 1.0 - torch.special.gammainc(self._concentration, self._rate / safe)
        return torch.where(x > 0, upper, torch.zeros_like(upper))

    @property
    def mean(self):
        a = self._concentration
        return torch.where(a > 1.0, self._rate / (a - 1.0), math.nan)

    @property
    def variance(self):
        a = self._concentration
        safe = torch.where(a > 2.0, a, torch.full_like(a, 3.0))
        return torch.where(a > 2.0, self._rate**2 / ((safe - 1.0) ** 2 * (safe - 2.0)), math.nan)
