"""Laplace distribution (counterpart of ``pyprob_tpu/distributions/laplace.py``).

Draws are loc − scale·sign(u)·log1p(−|u|) with u uniform on
[−1 + ε, 1), ε the float32 epsilon, as the JAX package draws them: every
draw is finite (at most about 16 scales from loc).
"""

from __future__ import annotations

import torch

from .. import util
from .distribution import Distribution, _broadcast_shapes, _tensors


class Laplace(Distribution):
    _param_names = ("loc", "scale")

    def __init__(self, loc, scale):
        self._loc, self._scale = _tensors(loc, scale)
        self._finish_init()

    def _finish_init(self):
        batch_shape = _broadcast_shapes(self._loc.shape, self._scale.shape)
        super().__init__(name="Laplace", address_suffix="Laplace", batch_shape=batch_shape)

    @property
    def loc(self):
        return self._loc

    @property
    def scale(self):
        return self._scale

    def _sample(self, generator, shape):
        u = 2.0 * self._rand(generator, shape, self._loc) - 1.0
        u = torch.clamp(u, min=-1.0 + torch.finfo(u.dtype).eps)
        return self._loc - self._scale * torch.sign(u) * torch.log1p(-torch.abs(u))

    def log_prob(self, value, sum=False):
        x = util.to_tensor(value, self._loc.device)
        lp = -torch.abs(x - self._loc) / self._scale - torch.log(2.0 * self._scale)
        return lp.sum() if sum else lp

    def cdf(self, value):
        x = util.to_tensor(value, self._loc.device)
        z = (x - self._loc) / self._scale
        return torch.where(z <= 0, 0.5 * torch.exp(z), 1.0 - 0.5 * torch.exp(-z))

    def icdf(self, value):
        u = util.to_tensor(value, self._loc.device)
        return self._loc - self._scale * torch.sign(u - 0.5) * torch.log1p(-2.0 * torch.abs(u - 0.5))

    @property
    def mean(self):
        return self._loc

    @property
    def variance(self):
        return 2.0 * self._scale**2
