"""Pareto (type I) distribution, α·m^α / x^(α+1) on x ≥ m (counterpart of
``pyprob_tpu/distributions/pareto.py``).  Draws go through the closed-form
inverse CDF, u clamped below 1 − 1e-7.  The mean is NaN for α ≤ 1 and the
variance for α ≤ 2, as there."""

from __future__ import annotations

import math

import torch

from .. import util
from .distribution import Distribution, _broadcast_shapes, _tensors


class Pareto(Distribution):
    _param_names = ("scale", "alpha")

    def __init__(self, scale, alpha):
        self._scale, self._alpha = _tensors(scale, alpha)
        self._finish_init()

    def _finish_init(self):
        batch_shape = _broadcast_shapes(self._scale.shape, self._alpha.shape)
        super().__init__(name="Pareto", address_suffix="Pareto", batch_shape=batch_shape)

    @property
    def scale(self):
        return self._scale

    @property
    def alpha(self):
        return self._alpha

    def _sample(self, generator, shape):
        return self.icdf(self._rand(generator, shape, self._scale))

    def log_prob(self, value, sum=False):
        x = util.to_tensor(value, self._scale.device)
        m, a = self._scale, self._alpha
        safe = torch.where(x >= m, x, m)
        lp = torch.where(
            x >= m, torch.log(a) + a * torch.log(m) - (a + 1.0) * torch.log(safe), -math.inf
        )
        return lp.sum() if sum else lp

    def cdf(self, value):
        x = util.to_tensor(value, self._scale.device)
        safe = torch.where(x >= self._scale, x, self._scale)
        c = 1.0 - (self._scale / safe) ** self._alpha
        return torch.where(x >= self._scale, c, torch.zeros_like(c))

    def icdf(self, value):
        u = torch.clamp(util.to_tensor(value, self._scale.device), 0.0, 1.0 - 1e-7)
        return self._scale * (1.0 - u) ** (-1.0 / self._alpha)

    @property
    def mean(self):
        a = self._alpha
        safe = torch.where(a > 1.0, a, torch.full_like(a, 2.0))
        return torch.where(a > 1.0, safe * self._scale / (safe - 1.0), math.nan)

    @property
    def variance(self):
        a = self._alpha
        safe = torch.where(a > 2.0, a, torch.full_like(a, 3.0))
        return torch.where(
            a > 2.0, self._scale**2 * safe / ((safe - 1.0) ** 2 * (safe - 2.0)), math.nan
        )
