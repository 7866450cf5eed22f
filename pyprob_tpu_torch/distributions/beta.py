"""Beta distribution, optionally rescaled to [low, high] (counterpart of
``pyprob_tpu/distributions/beta.py``).

Draws are X / (X + Y) of two standard Gamma draws, mapped to [low, high].
``log_prob`` clips the unit-interval value to [1e-12, 1 − 1e-12] and is
−inf outside [low, high]; log B(a, b) is computed from ``lgamma`` in
float64, as close to the JAX package's ``betaln`` as float32 shows.
"""

from __future__ import annotations

import math

import torch

from .. import util
from .distribution import Distribution, _broadcast_shapes, _tensors


def betaln(a, b):
    """log B(a, b), through float64."""
    a64, b64 = a.double(), b.double()
    return (torch.lgamma(a64) + torch.lgamma(b64) - torch.lgamma(a64 + b64)).to(a.dtype)


class Beta(Distribution):
    _param_names = ("concentration1", "concentration0", "low", "high")

    def __init__(self, concentration1, concentration0, low=0.0, high=1.0):
        (self._concentration1, self._concentration0, self._low, self._high) = _tensors(
            concentration1, concentration0, low, high
        )
        self._finish_init()

    def _finish_init(self):
        batch_shape = _broadcast_shapes(
            self._concentration1.shape, self._concentration0.shape, self._low.shape, self._high.shape
        )
        super().__init__(name="Beta", address_suffix="Beta", batch_shape=batch_shape)

    @property
    def low(self):
        return self._low

    @property
    def high(self):
        return self._high

    @property
    def concentration1(self):
        return self._concentration1

    @property
    def concentration0(self):
        return self._concentration0

    def _sample(self, generator, shape):
        x = self._standard_gamma(generator, shape, self._concentration1)
        y = self._standard_gamma(generator, shape, self._concentration0)
        return self._low + x / (x + y) * (self._high - self._low)

    def log_prob(self, value, sum=False):
        v = util.to_tensor(value, self._low.device)
        width = self._high - self._low
        x = (v - self._low) / width
        a, b = self._concentration1, self._concentration0
        x_in = torch.clamp(x, 1e-12, 1.0 - 1e-12)
        lp = (
            torch.xlogy(a - 1.0, x_in)
            + torch.special.xlog1py(b - 1.0, -x_in)
            - betaln(a, b)
            - torch.log(width)
        )
        lp = torch.where((x >= 0) & (x <= 1), lp, -math.inf)
        return lp.sum() if sum else lp

    @property
    def mean(self):
        a, b = self._concentration1, self._concentration0
        return self._low + (self._high - self._low) * a / (a + b)

    @property
    def variance(self):
        a, b = self._concentration1, self._concentration0
        v = a * b / ((a + b) ** 2 * (a + b + 1.0))
        return v * (self._high - self._low) ** 2
