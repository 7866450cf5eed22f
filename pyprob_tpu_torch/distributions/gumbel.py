"""Gumbel (extreme-value type I) distribution (counterpart of
``pyprob_tpu/distributions/gumbel.py``).

Draws are loc − scale·log(−log u) with u uniform on [tiny, 1), tiny the
smallest normal float32, so every draw is finite.
"""

from __future__ import annotations

import math

import torch

from .. import util
from .distribution import Distribution, _broadcast_shapes, _tensors

_EULER_GAMMA = 0.5772156649015329


class Gumbel(Distribution):
    _param_names = ("loc", "scale")

    def __init__(self, loc, scale):
        self._loc, self._scale = _tensors(loc, scale)
        self._finish_init()

    def _finish_init(self):
        batch_shape = _broadcast_shapes(self._loc.shape, self._scale.shape)
        super().__init__(name="Gumbel", address_suffix="Gumbel", batch_shape=batch_shape)

    @property
    def loc(self):
        return self._loc

    @property
    def scale(self):
        return self._scale

    def _sample(self, generator, shape):
        u = self._rand(generator, shape, self._loc)
        u = torch.clamp(u, min=torch.finfo(u.dtype).tiny)
        return self._loc - self._scale * torch.log(-torch.log(u))

    def log_prob(self, value, sum=False):
        x = util.to_tensor(value, self._loc.device)
        z = (x - self._loc) / self._scale
        lp = -z - torch.exp(-z) - torch.log(self._scale)
        return lp.sum() if sum else lp

    def cdf(self, value):
        x = util.to_tensor(value, self._loc.device)
        return torch.exp(-torch.exp(-(x - self._loc) / self._scale))

    def icdf(self, value):
        u = util.to_tensor(value, self._loc.device)
        return self._loc - self._scale * torch.log(-torch.log(u))

    @property
    def mean(self):
        return self._loc + self._scale * _EULER_GAMMA

    @property
    def variance(self):
        return (math.pi**2 / 6.0) * self._scale**2
