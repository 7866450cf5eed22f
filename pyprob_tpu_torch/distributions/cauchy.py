"""Cauchy distribution (counterpart of ``pyprob_tpu/distributions/cauchy.py``).

Draws are loc + scale·tan(π(u − ½)) (``Tensor.cauchy_``), finite for every
u the generator gives.  The mean and the variance are NaN, as the JAX
package's.
"""

from __future__ import annotations

import math

import torch

from .. import util
from .distribution import Distribution, _broadcast_shapes, _tensors


class Cauchy(Distribution):
    _param_names = ("loc", "scale")

    def __init__(self, loc, scale):
        self._loc, self._scale = _tensors(loc, scale)
        self._finish_init()

    def _finish_init(self):
        batch_shape = _broadcast_shapes(self._loc.shape, self._scale.shape)
        super().__init__(name="Cauchy", address_suffix="Cauchy", batch_shape=batch_shape)

    @property
    def loc(self):
        return self._loc

    @property
    def scale(self):
        return self._scale

    def _sample(self, generator, shape):
        c = torch.empty(shape + self._batch_shape, dtype=self._loc.dtype, device=self._loc.device)
        return self._loc + self._scale * c.cauchy_(generator=generator)

    def log_prob(self, value, sum=False):
        x = util.to_tensor(value, self._loc.device)
        z = (x - self._loc) / self._scale
        lp = -torch.log(math.pi * self._scale) - torch.log1p(z * z)
        return lp.sum() if sum else lp

    def cdf(self, value):
        x = util.to_tensor(value, self._loc.device)
        return torch.arctan((x - self._loc) / self._scale) / math.pi + 0.5

    def icdf(self, value):
        u = util.to_tensor(value, self._loc.device)
        return self._loc + self._scale * torch.tan(math.pi * (u - 0.5))

    @property
    def mean(self):
        return torch.full_like(self._loc, math.nan)

    @property
    def variance(self):
        return torch.full_like(self._scale, math.nan)
