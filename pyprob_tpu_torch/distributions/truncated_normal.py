"""Truncated normal distribution (counterpart of
``pyprob_tpu/distributions/truncated_normal.py``).

Sampling is the exact inverse-CDF transform: u uniform on [Φ(α), Φ(β)],
clipped to [1e-7, 1 − 1e-7], pushed through Φ⁻¹ (``torch.special.ndtri``)
and the result clipped to [low, high].  ``log_prob`` is normalised by
Z = max(Φ(β) − Φ(α), 1e-12) and is −inf outside [low, high].  Φ is
0.5·(1 + erf(z/√2)), as the JAX package and the mixture kernel compute it.
"""

from __future__ import annotations

import math

import torch

from .. import util
from .distribution import Distribution, _common_device

_LOG_SQRT_2PI = 0.5 * math.log(2.0 * math.pi)
_INV_SQRT_2 = 1.0 / math.sqrt(2.0)


def ndtr(z):
    """Φ(z) = 0.5·(1 + erf(z/√2)), as the mixture kernel computes it."""
    return 0.5 * (1.0 + torch.erf(z * _INV_SQRT_2))


def _phi(x):
    return torch.exp(-0.5 * x * x) / math.sqrt(2.0 * math.pi)


class TruncatedNormal(Distribution):
    _param_names = ("mean_non_truncated", "stddev_non_truncated", "low", "high")

    def __init__(self, mean_non_truncated, stddev_non_truncated, low, high):
        device = _common_device(mean_non_truncated, stddev_non_truncated, low, high)
        self._mean_non_truncated = util.to_tensor(mean_non_truncated, device)
        self._stddev_non_truncated = util.to_tensor(stddev_non_truncated, device)
        self._low = util.to_tensor(low, device)
        self._high = util.to_tensor(high, device)
        self._finish_init()

    def _finish_init(self):
        batch_shape = torch.broadcast_shapes(
            self._mean_non_truncated.shape,
            self._stddev_non_truncated.shape,
            self._low.shape,
            self._high.shape,
        )
        super().__init__(
            name="TruncatedNormal", address_suffix="TruncatedNormal", batch_shape=batch_shape
        )

    @property
    def mean_non_truncated(self):
        return self._mean_non_truncated

    @property
    def stddev_non_truncated(self):
        return self._stddev_non_truncated

    @property
    def variance_non_truncated(self):
        return self._stddev_non_truncated**2

    @property
    def low(self):
        return self._low

    @property
    def high(self):
        return self._high

    def _alpha_beta_z(self):
        mu, sigma = self._mean_non_truncated, self._stddev_non_truncated
        alpha = (self._low - mu) / sigma
        beta = (self._high - mu) / sigma
        big_phi_a, big_phi_b = ndtr(alpha), ndtr(beta)
        z = torch.clamp(big_phi_b - big_phi_a, min=1e-12)
        return alpha, beta, big_phi_a, big_phi_b, z

    def _sample(self, generator, shape):
        _, _, big_phi_a, big_phi_b, _ = self._alpha_beta_z()
        u = torch.rand(
            shape + self._batch_shape,
            generator=generator,
            dtype=big_phi_a.dtype,
            device=big_phi_a.device,
        )
        p = torch.clamp(big_phi_a + u * (big_phi_b - big_phi_a), 1e-7, 1.0 - 1e-7)
        x = self._mean_non_truncated + self._stddev_non_truncated * torch.special.ndtri(p)
        return torch.minimum(torch.maximum(x, self._low), self._high)

    def log_prob(self, value, sum=False):
        """Z-normalised truncated log-density, −inf outside [low, high]."""
        x = util.to_tensor(value, self._low.device)
        mu, sigma = self._mean_non_truncated, self._stddev_non_truncated
        _, _, _, _, z = self._alpha_beta_z()
        xi = (x - mu) / sigma
        lp = -0.5 * xi * xi - _LOG_SQRT_2PI - torch.log(sigma) - torch.log(z)
        inside = (x >= self._low) & (x <= self._high)
        lp = torch.where(inside, lp, torch.tensor(-math.inf, device=lp.device))
        return lp.sum() if sum else lp

    @property
    def mean(self):
        """Analytic truncated mean."""
        alpha, beta, _, _, z = self._alpha_beta_z()
        return self._mean_non_truncated + self._stddev_non_truncated * (
            _phi(alpha) - _phi(beta)
        ) / z

    @property
    def variance(self):
        alpha, beta, _, _, z = self._alpha_beta_z()
        pa, pb = _phi(alpha), _phi(beta)
        t1 = (alpha * pa - beta * pb) / z
        t2 = (pa - pb) / z
        return self.variance_non_truncated * (1.0 + t1 - t2**2)
