"""Uniform distribution (counterpart of ``pyprob_tpu/distributions/uniform.py``)."""

from __future__ import annotations

import math

import torch

from .. import util
from .distribution import Distribution, _broadcast_shapes, _common_device


class Uniform(Distribution):
    _param_names = ("low", "high")

    def __init__(self, low, high):
        device = _common_device(low, high)
        self._low = util.to_tensor(low, device)
        self._high = util.to_tensor(high, device)
        self._finish_init()

    def _finish_init(self):
        batch_shape = _broadcast_shapes(self._low.shape, self._high.shape)
        super().__init__(
            name="Uniform", address_suffix="Uniform", batch_shape=batch_shape
        )

    @property
    def low(self):
        return self._low

    @property
    def high(self):
        return self._high

    def _sample(self, generator, shape):
        u = torch.rand(
            shape + self._batch_shape,
            generator=generator,
            dtype=self._low.dtype,
            device=self._low.device,
        )
        return self._low + u * (self._high - self._low)

    def log_prob(self, value, sum=False):
        """−log(high − low) inside [low, high], −inf outside."""
        value = util.to_tensor(value, self._low.device)
        inside = (value >= self._low) & (value <= self._high)
        lp = torch.where(
            inside, -torch.log(self._high - self._low), -math.inf
        )
        return lp.sum() if sum else lp

    def cdf(self, value):
        value = util.to_tensor(value, self._low.device)
        return torch.clamp((value - self._low) / (self._high - self._low), 0.0, 1.0)

    def icdf(self, value):
        value = util.to_tensor(value, self._low.device)
        return self._low + value * (self._high - self._low)

    @property
    def mean(self):
        return 0.5 * (self._low + self._high)

    @property
    def variance(self):
        return (self._high - self._low) ** 2 / 12.0
