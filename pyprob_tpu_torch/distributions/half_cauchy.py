"""HalfCauchy distribution, |Cauchy(0, scale)| on x ≥ 0 (counterpart of
``pyprob_tpu/distributions/half_cauchy.py``); its mean and variance are
+inf, as the JAX package's."""

from __future__ import annotations

import math

import torch

from .. import util
from .distribution import Distribution, _common_device


class HalfCauchy(Distribution):
    _param_names = ("scale",)

    def __init__(self, scale):
        self._scale = util.to_tensor(scale, _common_device(scale))
        self._finish_init()

    def _finish_init(self):
        super().__init__(name="HalfCauchy", address_suffix="HalfCauchy", batch_shape=self._scale.shape)

    @property
    def scale(self):
        return self._scale

    def _sample(self, generator, shape):
        c = torch.empty(shape + self._batch_shape, dtype=self._scale.dtype, device=self._scale.device)
        return torch.abs(c.cauchy_(generator=generator)) * self._scale

    def log_prob(self, value, sum=False):
        x = util.to_tensor(value, self._scale.device)
        z = x / self._scale
        lp = math.log(2.0 / math.pi) - torch.log(self._scale) - torch.log1p(z * z)
        lp = torch.where(x >= 0, lp, -math.inf)
        return lp.sum() if sum else lp

    def cdf(self, value):
        x = util.to_tensor(value, self._scale.device)
        return torch.clamp(2.0 / math.pi * torch.arctan(x / self._scale), 0.0, 1.0)

    def icdf(self, value):
        return self._scale * torch.tan(math.pi * util.to_tensor(value, self._scale.device) / 2.0)

    @property
    def mean(self):
        return torch.full_like(self._scale, math.inf)

    @property
    def variance(self):
        return torch.full_like(self._scale, math.inf)
