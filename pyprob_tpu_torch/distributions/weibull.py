"""Weibull distribution (counterpart of ``pyprob_tpu/distributions/weibull.py``)."""

from __future__ import annotations

import math

import torch

from .. import util
from .distribution import Distribution, _broadcast_shapes, _clip_tiny, _tensors


class Weibull(Distribution):
    _param_names = ("scale", "concentration")

    def __init__(self, scale, concentration):
        self._scale, self._concentration = _tensors(scale, concentration)
        self._finish_init()

    def _finish_init(self):
        batch_shape = _broadcast_shapes(self._scale.shape, self._concentration.shape)
        super().__init__(name="Weibull", address_suffix="Weibull", batch_shape=batch_shape)

    @property
    def scale(self):
        return self._scale

    @property
    def concentration(self):
        return self._concentration

    def _sample(self, generator, shape):
        e = torch.empty(shape + self._batch_shape, dtype=self._scale.dtype, device=self._scale.device)
        return self._scale * e.exponential_(generator=generator) ** (1.0 / self._concentration)

    def log_prob(self, value, sum=False):
        x = util.to_tensor(value, self._scale.device)
        k, lam = self._concentration, self._scale
        z = _clip_tiny(x) / lam
        lp = torch.log(k / lam) + torch.xlogy(k - 1.0, z) - z**k
        lp = torch.where(x >= 0, lp, -math.inf)
        return lp.sum() if sum else lp

    @property
    def mean(self):
        return self._scale * torch.exp(torch.lgamma(1.0 + 1.0 / self._concentration))

    @property
    def variance(self):
        g1 = torch.exp(torch.lgamma(1.0 + 1.0 / self._concentration))
        g2 = torch.exp(torch.lgamma(1.0 + 2.0 / self._concentration))
        return self._scale**2 * (g2 - g1**2)
