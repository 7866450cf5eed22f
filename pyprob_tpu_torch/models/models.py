"""Canonical model families (counterpart of ``pyprob_tpu/models/models.py``).

* GaussianUnknownMean: the conjugate one-latent model with an analytic
  posterior, the main path's model.
* GaussianUnknownMeanMarsaglia: the same posterior with the prior drawn by
  Marsaglia's polar method in a plain ``while True:`` loop that branches
  on ``float`` of the sampled values: each attempt's sites get new address
  instances, and the model runs on the interpreter tier.
* GaussianUnknownMeanMarsagliaRejection: the same loop written with the
  ``rejection_sample`` combinator, so the model runs on the batched tier.
* HiddenMarkovModel: a K-state chain with Gaussian emissions, its
  transitions indexed with torch so that it runs on the batched tier;
* Branching: Poisson/Fibonacci stochastic branching with an enumerable
  posterior, on the interpreter tier; BranchingCompiled, the same
  posterior over r with tensor control flow, on the batched tier;
* EightSchools: the hierarchical benchmark in its non-centered form;
* BayesianLinearRegression (conjugate) and BayesianLogisticRegression
  (grid ground truth): one vector observe ``y`` of the data, ``w @ X.T``
  over the particles' ``[N, D]`` weights by ``torch.matmul``;
* GaussianProcessRegression: GP regression with the latent function
  marginalized out, one [N, N] kernel matrix and its Cholesky factor per
  particle;
* GaussianMixture: a K-component 1-D mixture with unknown means (and
  optionally Dirichlet weights), observed as one Mixture over the data
  vector: on the batched tier an ``[N, D]`` all-Normal mixture, which
  kernel 1 scores as ``N·D`` rows;
* LinearGaussianStateSpace: a local-level model with its Kalman filter and
  RTS smoother as ground truth.

* MiniCaptcha: a letter drawn uniformly and its glyph observed under
  Normal noise, the glyphs from a table kept in the package
  (``glyphs_dejavusans_bold_18.bin``).

Each family's ground-truth helpers are numpy float64 copies of the JAX
package's.  VariableLengthGaussian and the Markov variant of the
state-space model come with later slices.
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch

from .. import state as _state
from .. import util
from ..distributions import (
    Bernoulli,
    Categorical,
    Dirichlet,
    Empirical,
    HalfCauchy,
    Mixture,
    MultivariateNormal,
    Normal,
    Poisson,
    Uniform,
)
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


class GaussianUnknownMeanMarsaglia(Model):
    def __init__(
        self, prior_mean=1.0, prior_stddev=math.sqrt(5.0), likelihood_stddev=math.sqrt(2.0)
    ):
        super().__init__(name="Gaussian with unknown mean (Marsaglia)")
        self.prior_mean = prior_mean
        self.prior_stddev = prior_stddev
        self.likelihood_stddev = likelihood_stddev

    def marsaglia(self, mean, stddev):
        uniform = Uniform(-1.0, 1.0)
        while True:
            x = sample(uniform)
            y = sample(uniform)
            s = float(x) ** 2 + float(y) ** 2
            if s < 1:
                return mean + stddev * (float(x) * math.sqrt(-2 * math.log(s) / s))

    def forward(self):
        mu = self.marsaglia(self.prior_mean, self.prior_stddev)
        likelihood = Normal(mu, self.likelihood_stddev)
        observe(likelihood, name="obs0")
        observe(likelihood, name="obs1")
        return mu


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


class _OnDevice:
    """float32 copies of a model's numpy tables, one per device."""

    def __init__(self, **tables):
        self._tables = {k: np.asarray(v, np.float32) for k, v in tables.items()}
        self._on = {}

    def __call__(self, name, device):
        key = (name, device)
        t = self._on.get(key)
        if t is None:
            t = self._on[key] = torch.as_tensor(self._tables[name], device=device)
        return t


class HiddenMarkovModel(Model):
    """A K-state chain with Gaussian emissions, indexed with torch so that
    ``T[state]`` over ``[N]`` states gives ``[N, K]`` probabilities on the
    batched tier; returns the one-hot states, ``[obs_length + 1, K]`` a
    trace."""

    def __init__(self, init_probs, transition_probs, emission_means, emission_stddev=1.0, obs_length=16):
        super().__init__(name="Hidden Markov model")
        self._tables = _OnDevice(init=init_probs, T=transition_probs, means=emission_means)
        self.num_states = len(init_probs)
        self.emission_stddev = emission_stddev
        self.obs_length = obs_length

    def forward(self):
        tables, device = self._tables, util.param_device()
        state = sample(Categorical(probs=tables("init", device)))
        T, means = tables("T", state.device), tables("means", state.device)
        states = [state]
        for t in range(self.obs_length):
            state = sample(Categorical(probs=T[state]))
            observe(Normal(means[state], self.emission_stddev), name=f"obs{t}")
            states.append(state)
        return torch.nn.functional.one_hot(torch.stack(states, dim=-1), self.num_states).to(util.dtype())


def _fib(n):
    if n < 2:
        return 1
    a, fib = 1, 1
    for _ in range(n - 2):
        a, fib = fib, a + fib
    return fib


class Branching(Model):
    """Poisson/Fibonacci stochastic branching with an enumerable posterior:
    it branches on ``float`` of a sampled count, so it runs on the
    interpreter tier."""

    def __init__(self, rate=4.0):
        super().__init__(name="Branching")
        self.rate = rate

    def forward(self):
        count_prior = Poisson(self.rate)
        r = sample(count_prior)
        if 4 < float(r):
            l = 6
        else:
            l = 1 + _fib(3 * int(r)) + float(sample(count_prior))
        observe(Poisson(l), name="obs")
        return float(r)

    def true_posterior(self, observe_value=6, support=40):
        """The posterior over r enumerated on [0, support)²: an Empirical
        of r with log-weights log p(obs | r, s) + log p(r) + log p(s), in
        float64."""

        def log_poisson(k, rate):
            return k * math.log(rate) - rate - math.lgamma(k + 1.0)

        vals, log_weights = [], []
        for r in range(support):
            for s in range(support):
                l = 6 if 4 < r else 1 + _fib(3 * r) + s
                vals.append(float(r))
                log_weights.append(
                    log_poisson(observe_value, float(l)) + log_poisson(r, self.rate) + log_poisson(s, self.rate)
                )
        return Empirical(values=vals, log_weights=log_weights)


class BranchingCompiled(Model):
    """Branching with tensor control flow, so it runs on the batched tier:
    the branch is a ``where`` over a table of fib(3r), and the second count
    is drawn on both branches (the likelihood ignores it when r > 4, which
    marginalizes it out exactly): the posterior over r is Branching's."""

    def __init__(self, rate=4.0, max_r=40):
        super().__init__(name="Branching (compiled)")
        self.rate = rate
        self.max_r = max_r
        self._tables = _OnDevice(fib3=[_fib(3 * r) for r in range(max_r + 1)])

    def forward(self):
        count_prior = Poisson(self.rate)
        r = sample(count_prior)
        s = sample(count_prior)
        fib3 = self._tables("fib3", r.device)
        idx = torch.clamp(r, 0, self.max_r).long()
        l = torch.where(r > 4.0, 6.0, 1.0 + fib3[idx] + s)
        observe(Poisson(l), name="obs")
        return r

    def true_posterior(self, observe_value=6, support=40):
        return Branching(self.rate).true_posterior(observe_value, support)


_GLYPH_FILE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "glyphs_dejavusans_bold_18.bin")
_GLYPH_FIRST, _GLYPH_LAST = 32, 126  # the table's characters: printable ASCII, in code order
_glyph_table = None


def _glyphs():
    """The glyph table: ``[95, 28, 28]`` uint8, the red channel of each
    printable ASCII character as the JAX package's ``render`` draws it at
    its default arguments (``make_glyph_table.py`` writes it)."""
    global _glyph_table
    if _glyph_table is None:
        n = _GLYPH_LAST - _GLYPH_FIRST + 1
        _glyph_table = np.fromfile(_GLYPH_FILE, dtype=np.uint8).reshape(n, 28, 28)
    return _glyph_table


def _render_with_pil(font, text, size, height, width, x, y):
    try:
        from PIL import Image, ImageDraw, ImageFont
    except ImportError as e:
        raise ImportError(
            "MiniCaptcha.render needs PIL for text, sizes, offsets or fonts other "
            "than one printable ASCII character at the defaults"
        ) from e
    if font is None:
        import matplotlib

        font = os.path.join(os.path.dirname(matplotlib.__file__), "mpl-data", "fonts", "ttf", "DejaVuSans-Bold.ttf")
    canvas = Image.new("RGB", (height, width), (255, 255, 255))
    ImageDraw.Draw(canvas).text((x, y), text, font=ImageFont.truetype(font, size=size), fill="#000000")
    return np.asarray(canvas)[:, :, 0]


class MiniCaptcha(Model):
    """One letter of ``alphabet`` drawn uniformly (site ``letter_id``, a
    Categorical) and its 28 × 28 glyph observed under Normal noise as one
    784-vector ``query_image`` (``[N, 784]`` on the batched tier).  The
    glyphs come from the package's glyph table, equal to the bit to the
    JAX package's PIL rendering; other text, sizes, offsets or fonts go
    through PIL, as the JAX package always does."""

    def __init__(self, alphabet=("A", "B", "C", "D", "E", "F"), noise=0.1, font=None):
        super().__init__(name="MiniCaptcha")
        self._alphabet = list(alphabet)
        self._noise = noise
        self._font = font
        self._tables = _OnDevice(images=np.stack([self.render(a) for a in self._alphabet]))

    @property
    def alphabet(self):
        return self._alphabet

    def render(self, text, size=18, height=28, width=28, x=6, y=6):
        """The image of ``text`` as a float32 784-vector, 1 where ink is."""
        code = ord(text) if len(text) == 1 else -1
        if (self._font is None and (size, height, width, x, y) == (18, 28, 28, 6, 6)
                and _GLYPH_FIRST <= code <= _GLYPH_LAST):
            red = _glyphs()[code - _GLYPH_FIRST]
        else:
            red = _render_with_pil(self._font, text, size, height, width, x, y)
        return (1.0 - red / 255.0).reshape(-1).astype(np.float32)

    def forward(self):
        device = util.param_device()
        images = self._tables("images", device)
        probs = torch.full((len(self._alphabet),), 1.0 / len(self._alphabet), dtype=util.dtype(), device=device)
        letter_id = sample(Categorical(probs=probs))
        observe(Normal(images[letter_id], self._noise), name="query_image")
        return letter_id


class EightSchools(Model):
    """The canonical Bayesian hierarchical benchmark (Rubin 1981; Gelman et
    al., BDA §5.5): eight schools' treatment effects with known standard
    errors, partial pooling through a population mean and scale, in the
    non-centered parameterization (theta = mu + tau * z, z ~ N(0, 1)).
    Observe names are ``y0..y7``; ``observes()`` returns the classic data.
    forward() returns [mu, tau] (``[N, 2]`` on the batched tier)."""

    Y = (28.0, 8.0, -3.0, 7.0, -1.0, 1.0, 18.0, 12.0)
    SIGMA = (15.0, 10.0, 16.0, 11.0, 9.0, 11.0, 10.0, 18.0)

    def __init__(self, sigma=None):
        super().__init__(name="Eight schools (non-centered)")
        self.sigma = tuple(sigma) if sigma is not None else self.SIGMA

    def observes(self):
        """The classic dataset as an observe dict."""
        return {f"y{i}": v for i, v in enumerate(self.Y)}

    def forward(self):
        mu = sample(Normal(0.0, 5.0), name="mu")
        tau = sample(HalfCauchy(5.0), name="tau")
        for i, s in enumerate(self.sigma):
            z = sample(Normal(0.0, 1.0), address=f"z{i}")
            observe(Normal(mu + tau * z, s), name=f"y{i}")
        return torch.stack([mu, tau], dim=-1)


def _design_matrix(X):
    X = np.asarray(X, dtype=np.float64)
    if X.ndim != 2:
        raise ValueError("X must be [num_data, num_features]")
    return X


class BayesianLinearRegression(Model):
    """Bayesian linear regression with known noise: w_j ~ N(0, tau^2) per
    coefficient (sites ``w0..w{D-1}``), y ~ N(X w, sigma^2 I) observed as
    one vector observe ``y``.  Conjugate: ``true_posterior()`` gives the
    exact Gaussian posterior."""

    def __init__(self, X, prior_stddev=1.0, noise_stddev=0.5):
        super().__init__(name="Bayesian linear regression")
        self.X = _design_matrix(X)
        self.num_data, self.num_features = self.X.shape
        self.prior_stddev = float(prior_stddev)
        self.noise_stddev = float(noise_stddev)
        self._tables = _OnDevice(XT=self.X.T)

    def forward(self):
        ws = [sample(Normal(0.0, self.prior_stddev), address=f"w{j}") for j in range(self.num_features)]
        w = torch.stack(ws, dim=-1)
        observe(Normal(torch.matmul(w, self._tables("XT", w.device)), self.noise_stddev), name="y")
        return w

    def true_posterior(self, y):
        """Exact Gaussian posterior: mean vector and covariance matrix."""
        y = np.asarray(y, dtype=np.float64)
        prec = self.X.T @ self.X / self.noise_stddev**2 + np.eye(self.num_features) / self.prior_stddev**2
        cov = np.linalg.inv(prec)
        mean = cov @ (self.X.T @ y) / self.noise_stddev**2
        return mean, cov

    def synthesize(self, w_true, rng=None):
        """Draw a dataset y = X w_true + noise (host numpy)."""
        rng = np.random.default_rng(rng)
        return self.X @ np.asarray(w_true, dtype=np.float64) + rng.normal(
            0.0, self.noise_stddev, size=self.num_data
        )


class BayesianLogisticRegression(Model):
    """Bayesian logistic regression: w_j ~ N(0, tau^2), y ~
    Bernoulli(sigmoid(X w)) observed as one vector observe ``y``.
    ``true_posterior_moments()`` grid-integrates the exact posterior for
    num_features <= 2."""

    def __init__(self, X, prior_stddev=2.0):
        super().__init__(name="Bayesian logistic regression")
        self.X = _design_matrix(X)
        self.num_data, self.num_features = self.X.shape
        self.prior_stddev = float(prior_stddev)
        self._tables = _OnDevice(XT=self.X.T)

    def forward(self):
        ws = [sample(Normal(0.0, self.prior_stddev), address=f"w{j}") for j in range(self.num_features)]
        w = torch.stack(ws, dim=-1)
        observe(Bernoulli(logits=torch.matmul(w, self._tables("XT", w.device))), name="y")
        return w

    def _log_post(self, w, y):
        logits = self.X @ w
        loglik = np.sum(y * logits - np.logaddexp(0.0, logits))
        logprior = -0.5 * np.sum(w**2) / self.prior_stddev**2
        return loglik + logprior

    def true_posterior_moments(self, y, lim=8.0, n=401):
        """Grid-integrated exact posterior mean/stddev per coefficient
        (num_features <= 2 only)."""
        y = np.asarray(y, dtype=np.float64)
        grid = np.linspace(-lim, lim, n)
        if self.num_features == 1:
            lp = np.array([self._log_post(np.array([g]), y) for g in grid])
            p = np.exp(lp - lp.max())
            p /= p.sum()
            mean = float(np.sum(p * grid))
            var = float(np.sum(p * (grid - mean) ** 2))
            return np.array([mean]), np.array([math.sqrt(var)])
        if self.num_features == 2:
            G0, G1 = np.meshgrid(grid, grid, indexing="ij")
            lp = np.empty_like(G0)
            for i in range(n):
                for j in range(n):
                    lp[i, j] = self._log_post(np.array([G0[i, j], G1[i, j]]), y)
            p = np.exp(lp - lp.max())
            p /= p.sum()
            means = np.array([np.sum(p * G0), np.sum(p * G1)])
            stds = np.array([
                math.sqrt(np.sum(p * (G0 - means[0]) ** 2)),
                math.sqrt(np.sum(p * (G1 - means[1]) ** 2)),
            ])
            return means, stds
        raise ValueError("grid ground truth implemented for D <= 2")

    def synthesize(self, w_true, rng=None):
        rng = np.random.default_rng(rng)
        p = 1.0 / (1.0 + np.exp(-(self.X @ np.asarray(w_true, np.float64))))
        return (rng.uniform(size=self.num_data) < p).astype(np.float64)


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
        jitter = noise * noise + 1e-6
        if isinstance(jitter, torch.Tensor):
            jitter = jitter[..., None]
        differentiated = torch.is_grad_enabled() and any(
            isinstance(v, torch.Tensor) and v.requires_grad for v in (ell, amp, jitter)
        )
        if differentiated:
            # the same operations out of place, for autograd (the gradient
            # engines): the same bits, adding 0 off the diagonal
            K = torch.exp(K) * (amp * amp)
            return K + jitter * torch.eye(K.shape[-1], dtype=K.dtype, device=K.device)
        K.exp_().mul_(amp * amp)
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


class GaussianMixture(Model):
    """K-component 1-D Gaussian mixture with unknown component means:
    mu_k ~ N(prior_mean, prior_stddev) (sites ``mu0..mu{K-1}``), y_i ~
    sum_k w_k N(mu_k, sigma) observed as one Mixture observe ``y`` over the
    data vector (assignments marginalized).  On the batched tier each
    component is an ``[N, num_data]`` Normal, so kernel 1 scores the observe
    on ``N·num_data`` rows.  With exchangeable priors the posterior is
    K!-fold label-switching multimodal.  ``learn_weights=True`` adds a
    Dirichlet(alpha) weight latent (site ``w``), a ``[N, K]`` row of
    weights per particle that the mixture reads as ``[N, 1, K]``.  Exact
    K = 2 fixed-weight posterior by grid integration
    (``true_posterior_moments``)."""

    def __init__(
        self,
        num_components=2,
        weights=None,
        obs_stddev=0.6,
        prior_mean=0.0,
        prior_stddev=3.0,
        num_data=30,
        learn_weights=False,
        dirichlet_alpha=2.0,
    ):
        super().__init__(name="Gaussian mixture (marginalized assignments)")
        self.num_components = int(num_components)
        if weights is None:
            weights = np.full(self.num_components, 1.0 / self.num_components)
        self.weights = np.asarray(weights, dtype=np.float64)
        if self.weights.shape != (self.num_components,):
            raise ValueError("weights must have shape [num_components]")
        self.obs_stddev = float(obs_stddev)
        self.prior_mean = float(prior_mean)
        self.prior_stddev = float(prior_stddev)
        self.num_data = int(num_data)
        self.learn_weights = bool(learn_weights)
        self.dirichlet_alpha = float(dirichlet_alpha)
        self._tables = _OnDevice(
            weights=self.weights, alpha=np.full(self.num_components, self.dirichlet_alpha)
        )

    def forward(self):
        mus = [
            sample(Normal(self.prior_mean, self.prior_stddev), address=f"mu{k}")
            for k in range(self.num_components)
        ]
        device = mus[0].device
        if self.learn_weights:
            w = sample(Dirichlet(self._tables("alpha", device)), address="w")
            probs = w.unsqueeze(-2)  # one weight row per particle, over the data
        else:
            probs = self._tables("weights", device)
        comps = [Normal(m.unsqueeze(-1).expand(tuple(m.shape) + (self.num_data,)), self.obs_stddev) for m in mus]
        observe(Mixture(comps, probs=probs), name="y")
        return torch.stack(mus, dim=-1)

    def _log_post(self, mus, y):
        lps = np.stack(
            [
                -0.5 * ((y - m) / self.obs_stddev) ** 2
                - math.log(self.obs_stddev)
                - 0.5 * math.log(2 * math.pi)
                + math.log(wk)
                for m, wk in zip(mus, self.weights)
            ],
            axis=-1,
        )
        loglik = np.sum(_logsumexp(lps, axis=-1))
        logprior = -0.5 * np.sum(((np.asarray(mus) - self.prior_mean) / self.prior_stddev) ** 2)
        return loglik + logprior

    def true_posterior_moments(self, y, lim=3.0, n=201):
        """Grid-integrated exact posterior over (mu0, mu1) for K = 2 fixed
        weights; returns (means[2], stddevs[2]).  The grid covers the full
        label-switching posterior, so with symmetric priors the two sites'
        means coincide."""
        if self.num_components != 2 or self.learn_weights:
            raise ValueError("grid ground truth: K=2 fixed weights only")
        y = np.asarray(y, dtype=np.float64)
        grid = np.linspace(
            self.prior_mean - lim * self.prior_stddev,
            self.prior_mean + lim * self.prior_stddev,
            n,
        )
        G0, G1 = np.meshgrid(grid, grid, indexing="ij")
        lp = np.empty_like(G0)
        for i in range(n):
            for j in range(n):
                lp[i, j] = self._log_post([G0[i, j], G1[i, j]], y)
        p = np.exp(lp - lp.max())
        p /= p.sum()
        means = np.array([np.sum(p * G0), np.sum(p * G1)])
        stds = np.sqrt([np.sum(p * (G0 - means[0]) ** 2), np.sum(p * (G1 - means[1]) ** 2)])
        return means, stds

    def synthesize(self, mus_true, rng=None, weights=None):
        """Draw a dataset from the mixture at the given component means."""
        rng = np.random.default_rng(rng)
        w = self.weights if weights is None else np.asarray(weights)
        idx = rng.choice(self.num_components, size=self.num_data, p=w / w.sum())
        mus_true = np.asarray(mus_true, dtype=np.float64)
        return mus_true[idx] + rng.normal(0, self.obs_stddev, self.num_data)


def _logsumexp(a, axis=None):
    m = np.max(a, axis=axis, keepdims=True)
    return np.squeeze(m, axis=axis) + np.log(np.sum(np.exp(a - m), axis=axis))


class LinearGaussianStateSpace(Model):
    """Linear-Gaussian state-space model (local-level / AR(1)):
    x_0 ~ N(0, p0), x_t ~ N(a x_{t-1}, q), y_t ~ N(x_t, r) observed at every
    step (sites ``x0..x{T}``, observes ``y0..y{T-1}``).  forward() returns
    the state path [T+1], so a trace posterior's mean is the smoothed path,
    against the exact Kalman filter (``kalman_filter``) and RTS smoother
    (``kalman_smoother``)."""

    def __init__(self, num_steps=8, a=1.0, init_stddev=1.0,
                 transition_stddev=math.sqrt(0.5),
                 observation_stddev=math.sqrt(0.3)):
        super().__init__(name="Linear-Gaussian state space")
        self.num_steps = int(num_steps)
        self.a = float(a)
        self.init_stddev = float(init_stddev)
        self.transition_stddev = float(transition_stddev)
        self.observation_stddev = float(observation_stddev)

    def forward(self):
        xs = [sample(Normal(0.0, self.init_stddev), address="x0")]
        for t in range(self.num_steps):
            xs.append(sample(Normal(self.a * xs[-1], self.transition_stddev), address=f"x{t + 1}"))
            observe(Normal(xs[-1], self.observation_stddev), name=f"y{t}")
        return torch.stack(xs, dim=-1)

    def observes(self, ys):
        return {f"y{t}": float(v) for t, v in enumerate(ys)}

    def kalman_filter(self, ys):
        """Exact filtering means/vars of x_1..x_T given y_1..y_t (each entry
        conditions on the observations up to its own step).  Returns
        (means[T], vars[T])."""
        q, r = self.transition_stddev**2, self.observation_stddev**2
        mean, var = 0.0, self.init_stddev**2
        means, vars_ = [], []
        for y in np.asarray(ys, dtype=np.float64):
            mean_p = self.a * mean
            var_p = self.a * self.a * var + q
            k = var_p / (var_p + r)
            mean = mean_p + k * (y - mean_p)
            var = (1 - k) * var_p
            means.append(mean)
            vars_.append(var)
        return np.array(means), np.array(vars_)

    def kalman_smoother(self, ys):
        """Exact smoothing means/vars of x_0..x_T given all observations
        (Rauch-Tung-Striebel).  Returns (means[T+1], vars[T+1]) aligned with
        forward()'s path."""
        q, r = self.transition_stddev**2, self.observation_stddev**2
        ys = np.asarray(ys, dtype=np.float64)
        T = len(ys)
        fm, fv = np.empty(T + 1), np.empty(T + 1)
        pm, pv = np.empty(T + 1), np.empty(T + 1)  # predicted, before each update
        fm[0], fv[0] = 0.0, self.init_stddev**2
        pm[0], pv[0] = fm[0], fv[0]
        for t in range(T):
            pm[t + 1] = self.a * fm[t]
            pv[t + 1] = self.a * self.a * fv[t] + q
            k = pv[t + 1] / (pv[t + 1] + r)
            fm[t + 1] = pm[t + 1] + k * (ys[t] - pm[t + 1])
            fv[t + 1] = (1 - k) * pv[t + 1]
        sm, sv = fm.copy(), fv.copy()
        for t in range(T - 1, -1, -1):
            c = fv[t] * self.a / pv[t + 1]
            sm[t] = fm[t] + c * (sm[t + 1] - pm[t + 1])
            sv[t] = fv[t] + c * c * (sv[t + 1] - pv[t + 1])
        return sm, sv

    def synthesize(self, rng=None):
        """Draw (states[T+1], observations[T]) from the prior."""
        rng = np.random.default_rng(rng)
        xs = [rng.normal(0.0, self.init_stddev)]
        ys = []
        for _ in range(self.num_steps):
            xs.append(self.a * xs[-1] + rng.normal(0.0, self.transition_stddev))
            ys.append(xs[-1] + rng.normal(0.0, self.observation_stddev))
        return np.array(xs), np.array(ys)

    def kalman_log_evidence(self, ys):
        """Exact log marginal likelihood log p(y_1..y_T): the sum of the
        one-step predictive log-densities of the Kalman recursion."""
        q, r = self.transition_stddev**2, self.observation_stddev**2
        mean, var = 0.0, self.init_stddev**2
        log_z = 0.0
        for y in np.asarray(ys, dtype=np.float64):
            mean_p = self.a * mean
            var_p = self.a * self.a * var + q
            s = var_p + r
            log_z += -0.5 * (math.log(2 * math.pi * s) + (y - mean_p) ** 2 / s)
            k = var_p / s
            mean = mean_p + k * (y - mean_p)
            var = (1 - k) * var_p
        return log_z
