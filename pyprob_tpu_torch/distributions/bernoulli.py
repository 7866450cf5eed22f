"""Bernoulli distribution (counterpart of ``pyprob_tpu/distributions/bernoulli.py``).

Draws are float 0/1 values, as the JAX package's.  ``log_prob`` clips the
probability to [1e-12, 1 − 1e-12] (the upper bound rounds to 1 in float32,
as in the JAX package) and scores ``xlogy(x, p) + xlog1py(1 − x, −p)``.
"""

from __future__ import annotations

import torch

from .. import util
from .distribution import Distribution, _common_device


class Bernoulli(Distribution):
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
        super().__init__(name="Bernoulli", address_suffix="Bernoulli", batch_shape=self._probs.shape)

    @property
    def probs(self):
        return self._probs

    @property
    def logits(self):
        p = torch.clamp(self._probs, 1e-12, 1.0 - 1e-12)
        return torch.log(p) - torch.log1p(-p)

    def _sample(self, generator, shape):
        u = self._rand(generator, shape, self._probs)
        return (u < self._probs).to(self._probs.dtype)

    def log_prob(self, value, sum=False):
        value = util.to_tensor(value, self._probs.device)
        p = torch.clamp(self._probs, 1e-12, 1.0 - 1e-12)
        lp = torch.xlogy(value, p) + torch.special.xlog1py(1.0 - value, -p)
        return lp.sum() if sum else lp

    @property
    def mean(self):
        return self._probs

    @property
    def variance(self):
        return self._probs * (1.0 - self._probs)
