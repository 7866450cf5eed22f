"""Chi-squared distribution with ``df`` degrees of freedom (counterpart of
``pyprob_tpu/distributions/chi2.py``); draws are 2·Gamma(df/2, 1)."""

from __future__ import annotations

import math

import torch

from .. import util
from .distribution import Distribution, _common_device

_LOG_2 = math.log(2.0)


class Chi2(Distribution):
    _param_names = ("df",)

    def __init__(self, df):
        self._df = util.to_tensor(df, _common_device(df))
        self._finish_init()

    def _finish_init(self):
        super().__init__(name="Chi2", address_suffix="Chi2", batch_shape=self._df.shape)

    @property
    def df(self):
        return self._df

    def _sample(self, generator, shape):
        return 2.0 * self._standard_gamma(generator, shape, self._df / 2.0)

    def log_prob(self, value, sum=False):
        x = util.to_tensor(value, self._df.device)
        half_df = self._df / 2.0
        lp = torch.xlogy(half_df - 1.0, x) - x / 2.0 - half_df * _LOG_2 - torch.lgamma(half_df)
        lp = torch.where(x > 0, lp, -math.inf)
        return lp.sum() if sum else lp

    def cdf(self, value):
        x = util.to_tensor(value, self._df.device)
        return torch.special.gammainc(self._df / 2.0, torch.clamp(x, min=0.0) / 2.0)

    @property
    def mean(self):
        return self._df

    @property
    def variance(self):
        return 2.0 * self._df
