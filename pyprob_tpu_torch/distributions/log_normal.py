"""LogNormal distribution (counterpart of ``pyprob_tpu/distributions/log_normal.py``)."""

from __future__ import annotations

import math

import torch

from .. import util
from .distribution import Distribution, _broadcast_shapes, _clip_tiny, _tensors

_LOG_SQRT_2PI = 0.5 * math.log(2.0 * math.pi)


class LogNormal(Distribution):
    _param_names = ("loc", "scale")

    def __init__(self, loc, scale):
        self._loc, self._scale = _tensors(loc, scale)
        self._finish_init()

    def _finish_init(self):
        batch_shape = _broadcast_shapes(self._loc.shape, self._scale.shape)
        super().__init__(name="LogNormal", address_suffix="LogNormal", batch_shape=batch_shape)

    @property
    def loc(self):
        return self._loc

    @property
    def scale(self):
        return self._scale

    def _sample(self, generator, shape):
        return torch.exp(self._loc + self._scale * self._randn(generator, shape, self._loc))

    def log_prob(self, value, sum=False):
        x = util.to_tensor(value, self._loc.device)
        x_in = _clip_tiny(x)
        z = (torch.log(x_in) - self._loc) / self._scale
        lp = -0.5 * z * z - torch.log(self._scale) - _LOG_SQRT_2PI - torch.log(x_in)
        lp = torch.where(x > 0, lp, -math.inf)
        return lp.sum() if sum else lp

    @property
    def mean(self):
        return torch.exp(self._loc + 0.5 * self._scale**2)

    @property
    def variance(self):
        s2 = self._scale**2
        return (torch.exp(s2) - 1.0) * torch.exp(2.0 * self._loc + s2)
