"""HalfNormal distribution, |N(0, scale²)| on x ≥ 0 (counterpart of
``pyprob_tpu/distributions/half_normal.py``)."""

from __future__ import annotations

import math

import torch

from .. import util
from .distribution import Distribution, _common_device

_SQRT_2 = math.sqrt(2.0)
_SQRT_2_OVER_PI = math.sqrt(2.0 / math.pi)


class HalfNormal(Distribution):
    _param_names = ("scale",)

    def __init__(self, scale):
        self._scale = util.to_tensor(scale, _common_device(scale))
        self._finish_init()

    def _finish_init(self):
        super().__init__(name="HalfNormal", address_suffix="HalfNormal", batch_shape=self._scale.shape)

    @property
    def scale(self):
        return self._scale

    def _sample(self, generator, shape):
        return torch.abs(self._randn(generator, shape, self._scale)) * self._scale

    def log_prob(self, value, sum=False):
        x = util.to_tensor(value, self._scale.device)
        z = x / self._scale
        lp = 0.5 * math.log(2.0 / math.pi) - torch.log(self._scale) - 0.5 * z * z
        lp = torch.where(x >= 0, lp, -math.inf)
        return lp.sum() if sum else lp

    def cdf(self, value):
        x = util.to_tensor(value, self._scale.device)
        return torch.clamp(torch.erf(x / (self._scale * _SQRT_2)), 0.0, 1.0)

    def icdf(self, value):
        return self._scale * _SQRT_2 * torch.erfinv(util.to_tensor(value, self._scale.device))

    @property
    def mean(self):
        return self._scale * _SQRT_2_OVER_PI

    @property
    def variance(self):
        return self._scale**2 * (1.0 - 2.0 / math.pi)
