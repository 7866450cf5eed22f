"""Canonical model families (counterpart of ``pyprob_tpu/models/models.py``).

* GaussianUnknownMean: the conjugate one-latent model with an analytic
  posterior, the main path's model.
* GaussianUnknownMeanMarsagliaRejection: the same posterior with the prior
  drawn by Marsaglia's polar method, a rejection loop written with the
  ``rejection_sample`` combinator, so the model runs on the batched tier.
* GaussianProcessRegression: GP regression with the latent function
  marginalized out, one [N, N] kernel matrix and its Cholesky factor per
  particle.

The other families, among them the plain while-loop Marsaglia model of the
interpreter tier, come with later slices.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .. import state as _state
from ..distributions import MultivariateNormal, Normal, Uniform
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


class GaussianProcessRegression(Model):
    """GP regression with the latent function marginalized out: the
    latents are the kernel hyperparameters (log-lengthscale,
    log-amplitude, log-noise; any subset learnable, the rest fixed) and
    the likelihood is one MultivariateNormal observe ``y`` over the full
    dataset, y ~ N(0, amp^2 exp(-d^2/2ell^2) + noise^2 I).  On the batched
    tier each particle builds an [N, N] kernel matrix and factors it.  The
    exact single-hyperparameter posterior is available by grid integration
    (``true_posterior_moments``, numpy float64)."""

    LEARNABLE = ("lengthscale", "amplitude", "noise")

    def __init__(
        self,
        x,
        learn=("lengthscale",),
        lengthscale=1.0,
        amplitude=1.0,
        noise=0.1,
        prior_mean=0.0,
        prior_stddev=1.0,
    ):
        super().__init__(name="GP regression (marginal likelihood)")
        self.x = np.asarray(x, dtype=np.float64).reshape(-1)
        self.num_data = self.x.size
        unknown = set(learn) - set(self.LEARNABLE)
        if unknown:
            raise ValueError(f"unknown hyperparameters: {sorted(unknown)}")
        self.learn = tuple(learn)
        self.fixed = dict(
            lengthscale=float(lengthscale),
            amplitude=float(amplitude),
            noise=float(noise),
        )
        self.prior_mean = float(prior_mean)
        self.prior_stddev = float(prior_stddev)
        d = self.x[:, None] - self.x[None, :]
        self._sq_dists = d * d
        self._sq_dists_on = {}  # device -> float32 [N, N]

    def _sq_dists_tensor(self, device):
        sq = self._sq_dists_on.get(device)
        if sq is None:
            sq = torch.as_tensor(self._sq_dists, dtype=torch.float32, device=device)
            self._sq_dists_on[device] = sq
        return sq

    def _hyper(self, name):
        """Sample log-hyperparameter if learnable, else its fixed value."""
        if name in self.learn:
            lg = sample(Normal(self.prior_mean, self.prior_stddev), address=f"log_{name}")
            return torch.exp(lg)
        return self.fixed[name]

    def _cov(self, sq, ell, amp, noise):
        """numpy float64 kernel matrix (the host-side ground truth)."""
        K = (amp * amp) * np.exp(-0.5 * sq / (ell * ell))
        return K + (noise * noise + 1e-6) * np.eye(self.num_data)

    def _cov_batched(self, sq, batch, ell, amp, noise):
        """The [*batch, N, N] kernel matrices with each hyperparameter a
        float or a [*batch] tensor, in the JAX package's operation order.
        One [*batch, N, N] buffer: the division allocates it, the rest
        works in place (32,768 particles at N = 256 hold 8 GiB once, not
        several times)."""

        def per_matrix(v):
            return v[..., None, None] if isinstance(v, torch.Tensor) else v

        ell, amp = per_matrix(ell), per_matrix(amp)
        K = (-0.5 * sq).expand(batch + sq.shape).div(ell * ell)
        K.exp_().mul_(amp * amp)
        jitter = noise * noise + 1e-6
        if isinstance(jitter, torch.Tensor):
            jitter = jitter[..., None]
        K.diagonal(dim1=-2, dim2=-1).add_(jitter)
        return K

    def forward(self):
        first = sample(Normal(self.prior_mean, self.prior_stddev), address=f"log_{self.learn[0]}")
        vals = {self.learn[0]: torch.exp(first)}
        for name in self.LEARNABLE:
            if name not in vals:
                vals[name] = self._hyper(name)
        sq = self._sq_dists_tensor(first.device)
        loc = torch.zeros(self.num_data, dtype=sq.dtype, device=sq.device)
        # the kernel matrices are passed straight to the constructor, so
        # they are freed once it has factored them
        observe(
            MultivariateNormal(
                loc,
                covariance_matrix=self._cov_batched(
                    sq, first.shape, vals["lengthscale"], vals["amplitude"], vals["noise"]
                ),
            ),
            name="y",
        )
        return torch.stack([torch.log(vals[n]) for n in self.learn], dim=-1)

    def _log_marglik(self, y, ell, amp, noise):
        K = self._cov(self._sq_dists, ell, amp, noise)
        L = np.linalg.cholesky(K)
        alpha = np.linalg.solve(L, y)
        return (
            -0.5 * alpha @ alpha
            - np.sum(np.log(np.diag(L)))
            - 0.5 * self.num_data * math.log(2 * math.pi)
        )

    def true_posterior_moments(self, y, lim=3.0, n=241):
        """Grid-integrated posterior mean/stddev of the single learned
        log-hyperparameter (len(learn) == 1 only)."""
        if len(self.learn) != 1:
            raise ValueError("grid ground truth needs exactly one learnable")
        y = np.asarray(y, dtype=np.float64)
        name = self.learn[0]
        grid = np.linspace(
            self.prior_mean - lim * self.prior_stddev,
            self.prior_mean + lim * self.prior_stddev,
            n,
        )
        lp = np.empty(n)
        for i, g in enumerate(grid):
            vals = dict(self.fixed)
            vals[name] = math.exp(g)
            lp[i] = self._log_marglik(
                y, vals["lengthscale"], vals["amplitude"], vals["noise"]
            ) - 0.5 * (g - self.prior_mean) ** 2 / self.prior_stddev**2
        p = np.exp(lp - lp.max())
        p /= p.sum()
        mean = float(np.sum(p * grid))
        var = float(np.sum(p * (grid - mean) ** 2))
        return mean, math.sqrt(var)

    def synthesize(self, rng=None, **hyper):
        """Draw y from the GP prior at the fixed (or given) hyperparams."""
        vals = dict(self.fixed)
        vals.update(hyper)
        K = self._cov(self._sq_dists, vals["lengthscale"], vals["amplitude"], vals["noise"])
        rng = np.random.default_rng(rng)
        return np.linalg.cholesky(K) @ rng.normal(size=self.num_data)
