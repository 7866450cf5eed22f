"""Logistic distribution (counterpart of ``pyprob_tpu/distributions/logistic.py``).

``log_prob`` is −|z| − 2·log1p(e^−|z|) − log scale, free of overflow in both
tails.  Draws are loc + scale·(log u − log1p(−u)) with u uniform on
[tiny, 1), tiny the smallest normal float32, so every draw is finite.
"""

from __future__ import annotations

import math

import torch

from .. import util
from .distribution import Distribution, _broadcast_shapes, _tensors


class Logistic(Distribution):
    _param_names = ("loc", "scale")

    def __init__(self, loc, scale):
        self._loc, self._scale = _tensors(loc, scale)
        self._finish_init()

    def _finish_init(self):
        batch_shape = _broadcast_shapes(self._loc.shape, self._scale.shape)
        super().__init__(name="Logistic", address_suffix="Logistic", batch_shape=batch_shape)

    @property
    def loc(self):
        return self._loc

    @property
    def scale(self):
        return self._scale

    def _sample(self, generator, shape):
        u = self._rand(generator, shape, self._loc)
        u = torch.clamp(u, min=torch.finfo(u.dtype).tiny)
        return self._loc + self._scale * (torch.log(u) - torch.log1p(-u))

    def log_prob(self, value, sum=False):
        x = util.to_tensor(value, self._loc.device)
        z = torch.abs(x - self._loc) / self._scale
        lp = -z - 2.0 * torch.log1p(torch.exp(-z)) - torch.log(self._scale)
        return lp.sum() if sum else lp

    def cdf(self, value):
        x = util.to_tensor(value, self._loc.device)
        return 1.0 / (1.0 + torch.exp(-(x - self._loc) / self._scale))

    def icdf(self, value):
        u = util.to_tensor(value, self._loc.device)
        return self._loc + self._scale * (torch.log(u) - torch.log1p(-u))

    @property
    def mean(self):
        return self._loc

    @property
    def variance(self):
        return (math.pi**2 / 3.0) * self._scale**2
