"""Canonical model families (counterpart of ``pyprob_tpu/models/models.py``).

* GaussianUnknownMean: the conjugate one-latent model with an analytic
  posterior, the main path's model.
* GaussianUnknownMeanMarsagliaRejection: the same posterior with the prior
  drawn by Marsaglia's polar method, a rejection loop written with the
  ``rejection_sample`` combinator, so the model runs on the batched tier.

The other families, among them the plain while-loop Marsaglia model of the
interpreter tier, come with later slices.
"""

from __future__ import annotations

import math

import torch

from .. import state as _state
from ..distributions import Normal, Uniform
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


class GaussianUnknownMeanMarsagliaRejection(Model):
    """GUM with its Normal prior drawn by Marsaglia's polar method inside
    ``rejection_sample``: two Uniform(−1, 1) sites per attempt, accepted
    inside the unit disc.  Same posterior as GaussianUnknownMean."""

    def __init__(
        self, prior_mean=1.0, prior_stddev=math.sqrt(5.0), likelihood_stddev=math.sqrt(2.0)
    ):
        super().__init__(
            name="Gaussian with unknown mean (Marsaglia, rejection combinator)"
        )
        self.prior_mean = prior_mean
        self.prior_stddev = prior_stddev
        self.likelihood_stddev = likelihood_stddev

    def marsaglia(self, mean, stddev):
        uniform = Uniform(-1.0, 1.0)

        def attempt():
            x = sample(uniform)
            y = sample(uniform)
            s = x * x + y * y
            return (x, s), s < 1.0

        (x, s) = _state.rejection_sample(attempt)
        return mean + stddev * (x * torch.sqrt(-2.0 * torch.log(s) / s))

    def forward(self):
        mu = self.marsaglia(self.prior_mean, self.prior_stddev)
        likelihood = Normal(mu, self.likelihood_stddev)
        observe(likelihood, name="obs0")
        observe(likelihood, name="obs1")
        return mu

    def true_posterior(self, observed_values):
        return GaussianUnknownMean(
            self.prior_mean, self.prior_stddev, self.likelihood_stddev
        ).true_posterior(observed_values)
