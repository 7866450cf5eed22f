"""Geometric distribution, the number of failures before the first success
on {0, 1, 2, ...} (counterpart of ``pyprob_tpu/distributions/geometric.py``).

It takes ``probs`` or ``logits``.  Draws invert the cdf in closed form,
floor(log u / log1p(−p)) with u uniform on [tiny, 1) and p clipped to
[1e-12, 1], as the JAX package draws them.  ``log_prob`` is
xlog1py(k, −p) + log p with p clipped to [1e-12, 1 − 1e-12], −inf below 0;
it does not check that k is an integer, as the JAX package's does not.
``cdf`` floors k.
"""

from __future__ import annotations

import math

import torch

from .. import util
from .distribution import Distribution, _common_device


class Geometric(Distribution):
    _param_names = ("probs",)

    def __init__(self, probs=None, logits=None):
        if (probs is None) == (logits is None):
            raise ValueError("Provide exactly one of probs, logits")
        if logits is not None:
            self._probs = torch.sigmoid(util.to_tensor(logits, _common_device(logits)))
        else:
            self._probs = util.to_tensor(probs, _common_device(probs))
        self._finish_init()

    def _finish_init(self):
        super().__init__(name="Geometric", address_suffix="Geometric", batch_shape=self._probs.shape)

    @property
    def probs(self):
        return self._probs

    def _sample(self, generator, shape):
        u = self._rand(generator, shape, self._probs)
        u = torch.clamp(u, min=torch.finfo(u.dtype).tiny)
        p = torch.clamp(self._probs, 1e-12, 1.0)
        return torch.floor(torch.log(u) / torch.log1p(-p))

    def log_prob(self, value, sum=False):
        k = util.to_tensor(value, self._probs.device)
        p = torch.clamp(self._probs, 1e-12, 1.0 - 1e-12)
        lp = torch.special.xlog1py(k, -p) + torch.log(p)
        lp = torch.where(k >= 0, lp, -math.inf)
        return lp.sum() if sum else lp

    def cdf(self, value):
        k = torch.floor(util.to_tensor(value, self._probs.device))
        p = torch.clamp(self._probs, 1e-12, 1.0 - 1e-12)
        c = 1.0 - torch.exp(torch.log1p(-p) * (k + 1.0))
        return torch.where(k >= 0, c, torch.zeros_like(c))

    @property
    def mean(self):
        return (1.0 - self._probs) / self._probs

    @property
    def variance(self):
        return (1.0 - self._probs) / self._probs**2
