"""NegativeBinomial distribution, the number of failures before the
``total_count``-th success at success probability ``probs`` (counterpart
of ``pyprob_tpu/distributions/negative_binomial.py``): pmf
C(k+r−1, k)·p^r·(1−p)^k, mean r(1−p)/p.

It takes ``probs`` or ``logits``.  Draws are the exact Gamma–Poisson
mixture, λ = G·(1−p)/p with G ~ Gamma(r, 1), then Poisson(λ), so
``total_count`` need not be an integer.  ``log_prob`` scores
lgamma(k+r) − lgamma(r) − lgamma(k+1) + xlogy(r, p) + xlogy(k, 1−p) at a
masked k (0 where k is invalid), and −inf where k is negative or further
than 1e-6 from an integer, as the JAX package's.
"""

from __future__ import annotations

import math

import torch

from .. import util
from .distribution import Distribution, _broadcast_shapes, _common_device


class NegativeBinomial(Distribution):
    _param_names = ("total_count", "probs")

    def __init__(self, total_count, probs=None, logits=None):
        if (probs is None) == (logits is None):
            raise ValueError("Provide exactly one of probs, logits")
        device = _common_device(total_count, probs, logits)
        if logits is not None:
            self._probs = torch.sigmoid(util.to_tensor(logits, device))
        else:
            self._probs = util.to_tensor(probs, device)
        self._total_count = util.to_tensor(total_count, device)
        self._finish_init()

    def _finish_init(self):
        batch_shape = _broadcast_shapes(self._total_count.shape, self._probs.shape)
        super().__init__(
            name="NegativeBinomial", address_suffix="NegativeBinomial", batch_shape=batch_shape
        )

    @property
    def total_count(self):
        return self._total_count

    @property
    def probs(self):
        return self._probs

    def _sample(self, generator, shape):
        g = self._standard_gamma(generator, shape, self._total_count)
        lam = g * (1.0 - self._probs) / self._probs
        return torch.poisson(lam, generator=generator)

    def log_prob(self, value, sum=False):
        k = util.to_tensor(value, self._probs.device)
        r, p = self._total_count, self._probs
        valid = (k >= 0) & (torch.abs(k - torch.round(k)) < 1e-6)
        safe_k = torch.where(valid, k, torch.zeros_like(k))
        lp = (
            torch.lgamma(safe_k + r)
            - torch.lgamma(r)
            - torch.lgamma(safe_k + 1.0)
            + torch.xlogy(r, p)
            + torch.xlogy(safe_k, 1.0 - p)
        )
        lp = torch.where(valid, lp, -math.inf)
        return lp.sum() if sum else lp

    @property
    def mean(self):
        return self._total_count * (1.0 - self._probs) / self._probs

    @property
    def variance(self):
        return self._total_count * (1.0 - self._probs) / self._probs**2
