"""Canonical model families (counterpart of ``pyprob_tpu/models/models.py``).

* GaussianUnknownMean: the conjugate one-latent model with an analytic
  posterior, the main path's model.

The other families come with later slices.
"""

from __future__ import annotations

import math

from .. import state as _state
from ..distributions import Normal
from ..model import Model

sample = _state.sample
observe = _state.observe


class GaussianUnknownMean(Model):
    def __init__(
        self, prior_mean=1.0, prior_stddev=math.sqrt(5.0), likelihood_stddev=math.sqrt(2.0), num_observes=2
    ):
        super().__init__(name="Gaussian with unknown mean")
        self.prior_mean = prior_mean
        self.prior_stddev = prior_stddev
        self.likelihood_stddev = likelihood_stddev
        self.num_observes = num_observes

    def forward(self):
        mu = sample(Normal(self.prior_mean, self.prior_stddev))
        likelihood = Normal(mu, self.likelihood_stddev)
        for i in range(self.num_observes):
            observe(likelihood, name=f"obs{i}")
        return mu

    def true_posterior(self, observed_values):
        """Conjugate closed form."""
        n = len(observed_values)
        s2_prior = self.prior_stddev**2
        s2_lik = self.likelihood_stddev**2
        var = 1.0 / (1.0 / s2_prior + n / s2_lik)
        mean = var * (self.prior_mean / s2_prior + sum(observed_values) / s2_lik)
        return mean, math.sqrt(var)
