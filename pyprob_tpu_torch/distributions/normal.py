"""Normal distribution (counterpart of ``pyprob_tpu/distributions/normal.py``)."""

from __future__ import annotations

import math

import torch

from .. import util
from .distribution import Distribution, _common_device

_LOG_SQRT_2PI = 0.5 * math.log(2.0 * math.pi)


class Normal(Distribution):
    _param_names = ("loc", "scale")

    def __init__(self, loc, scale):
        device = _common_device(loc, scale)
        self._loc = util.to_tensor(loc, device)
        self._scale = util.to_tensor(scale, device)
        self._finish_init()

    def _finish_init(self):
        batch_shape = torch.broadcast_shapes(self._loc.shape, self._scale.shape)
        super().__init__(
            name="Normal", address_suffix="Normal", batch_shape=batch_shape
        )

    @property
    def loc(self):
        return self._loc

    @property
    def scale(self):
        return self._scale

    def _sample(self, generator, shape):
        eps = torch.randn(
            shape + self._batch_shape,
            generator=generator,
            dtype=self._loc.dtype,
            device=self._loc.device,
        )
        return self._loc + self._scale * eps

    def log_prob(self, value, sum=False):
        value = util.to_tensor(value, self._loc.device)
        z = (value - self._loc) / self._scale
        lp = -0.5 * z * z - torch.log(self._scale) - _LOG_SQRT_2PI
        return lp.sum() if sum else lp

    @property
    def mean(self):
        return self._loc

    @property
    def variance(self):
        return self._scale**2

    @property
    def stddev(self):
        return self._scale
