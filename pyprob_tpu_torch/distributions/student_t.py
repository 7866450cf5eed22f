"""Student's t distribution (counterpart of
``pyprob_tpu/distributions/student_t.py``).

Draws are loc + scale·Z/√(2G/ν) with Z standard normal and G ~ Gamma(ν/2, 1),
exact for every ν > 0; G is kept at or above the smallest normal float32,
so no draw is ±inf at small ν (the proposal heads' df floor is 0.5).  The
mean is NaN for ν ≤ 1; the variance is NaN for ν ≤ 1 and +inf for
1 < ν ≤ 2, as the JAX package's.  There is no cdf or icdf, as there.
"""

from __future__ import annotations

import math

import torch

from .. import util
from .distribution import Distribution, _broadcast_shapes, _tensors


class StudentT(Distribution):
    _param_names = ("df", "loc", "scale")

    def __init__(self, df, loc=0.0, scale=1.0):
        self._df, self._loc, self._scale = _tensors(df, loc, scale)
        self._finish_init()

    def _finish_init(self):
        batch_shape = _broadcast_shapes(self._df.shape, self._loc.shape, self._scale.shape)
        super().__init__(name="StudentT", address_suffix="StudentT", batch_shape=batch_shape)

    @property
    def df(self):
        return self._df

    @property
    def loc(self):
        return self._loc

    @property
    def scale(self):
        return self._scale

    def _sample(self, generator, shape):
        z = self._randn(generator, shape, self._loc)
        g = self._standard_gamma(generator, shape, self._df / 2.0)
        g = torch.clamp(g, min=torch.finfo(g.dtype).tiny)
        return self._loc + self._scale * z * torch.rsqrt(2.0 * g / self._df)

    def log_prob(self, value, sum=False):
        x = util.to_tensor(value, self._loc.device)
        v = self._df
        z = (x - self._loc) / self._scale
        lp = (
            torch.lgamma((v + 1.0) / 2.0)
            - torch.lgamma(v / 2.0)
            - 0.5 * torch.log(v * math.pi)
            - torch.log(self._scale)
            - (v + 1.0) / 2.0 * torch.log1p(z * z / v)
        )
        return lp.sum() if sum else lp

    @property
    def mean(self):
        loc = self._loc + torch.zeros_like(self._df)
        return torch.where(self._df > 1.0, loc, math.nan)

    @property
    def variance(self):
        v = self._df
        var = self._scale**2 * v / (v - 2.0)
        return torch.where(v > 2.0, var, torch.where((v > 1.0) & (v <= 2.0), math.inf, math.nan))
