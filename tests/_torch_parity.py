"""Shared set-up of the parity tests between pyprob_tpu and pyprob_tpu_torch.

The Gaussian-unknown-mean body and its Marsaglia variants (the prior drawn
by the polar method inside ``rejection_sample``, and in a plain while loop
that branches on ``float`` of the sampled values), pyprob's HMM, the
Beta–Bernoulli and Gamma–Poisson models, the Laplace-prior model (and its
interpreter-only copy), the Beta–NegativeBinomial model and the
event-shaped latents (MultivariateNormal, Dirichlet, LKJCholesky) and
conjugate models are defined once here and both
packages' models call them: an address embeds the source line of
its ``sample`` call and the function-name chain, so the two packages'
sites get equal addresses and carried proposal heads land on the right
address.  The ``rejection_sample`` body takes its ``sqrt`` and ``log``
from the caller, the HMM body its tables.  ``port_trace`` rebuilds a JAX
package trace in the port's records (the Censored and ZeroInflated
wrappers with their bases), so both packages' losses can run on the same
traces.
"""

import math

import numpy as np
import jax.numpy as jnp
import torch

import pyprob_tpu
import pyprob_tpu_torch
from pyprob_tpu.nn import InferenceNetworkFeedForward as JaxFF, InferenceNetworkLSTM as JaxLSTM
from pyprob_tpu.nn.layers import Static
from pyprob_tpu_torch.nn import InferenceNetworkFeedForward as TorchFF, InferenceNetworkLSTM as TorchLSTM

OBSERVE = {"obs0": 8.0, "obs1": 9.0}
POSTERIOR_MEAN, POSTERIOR_STDDEV = 7.25, math.sqrt(1.0 / 1.2)


def gum_body(pp):
    mu = pp.sample(pp.distributions.Normal(1.0, math.sqrt(5.0)))
    likelihood = pp.distributions.Normal(mu, math.sqrt(2.0))
    pp.observe(likelihood, name="obs0")
    pp.observe(likelihood, name="obs1")
    return mu


class JaxGUM(pyprob_tpu.Model):
    def forward(self):
        return gum_body(pyprob_tpu)


class TorchGUM(pyprob_tpu_torch.Model):
    def forward(self):
        return gum_body(pyprob_tpu_torch)


def marsaglia_body(pp, sqrt, log):
    uniform = pp.distributions.Uniform(-1.0, 1.0)

    def attempt():
        x = pp.sample(uniform)
        y = pp.sample(uniform)
        s = x * x + y * y
        return (x, s), s < 1.0

    x, s = pp.rejection_sample(attempt)
    mu = 1.0 + math.sqrt(5.0) * (x * sqrt(-2.0 * log(s) / s))
    likelihood = pp.distributions.Normal(mu, math.sqrt(2.0))
    pp.observe(likelihood, name="obs0")
    pp.observe(likelihood, name="obs1")
    return mu


class JaxMarsaglia(pyprob_tpu.Model):
    def forward(self):
        return marsaglia_body(pyprob_tpu, jnp.sqrt, jnp.log)


class TorchMarsaglia(pyprob_tpu_torch.Model):
    def forward(self):
        return marsaglia_body(pyprob_tpu_torch, torch.sqrt, torch.log)


def marsaglia_while_body(pp):
    uniform = pp.distributions.Uniform(-1.0, 1.0)
    while True:
        x = pp.sample(uniform)
        y = pp.sample(uniform)
        s = float(x) ** 2 + float(y) ** 2
        if s < 1:
            break
    mu = 1.0 + math.sqrt(5.0) * (float(x) * math.sqrt(-2.0 * math.log(s) / s))
    likelihood = pp.distributions.Normal(mu, math.sqrt(2.0))
    pp.observe(likelihood, name="obs0")
    pp.observe(likelihood, name="obs1")
    return mu


class JaxMarsagliaWhile(pyprob_tpu.Model):
    def forward(self):
        return marsaglia_while_body(pyprob_tpu)


class TorchMarsagliaWhile(pyprob_tpu_torch.Model):
    def forward(self):
        return marsaglia_while_body(pyprob_tpu_torch)


# pyprob's HMM test (tests/test_inference.py:271-317): 3 states, 16 Normal
# observes, 17 categorical sites
HMM_INIT = [1.0 / 3.0] * 3
HMM_T = [[0.1, 0.5, 0.4], [0.2, 0.2, 0.6], [0.15, 0.15, 0.7]]
HMM_MEANS = [-1.0, 1.0, 0.0]
HMM_OBSERVATION = [0.9, 0.8, 0.7, 0.0, -0.025, -5.0, -2.0, -0.1, 0.0, 0.13, 0.45, 6, 0.2, 0.3, -1, -1]
HMM_OBSERVE = {f"obs{i}": v for i, v in enumerate(HMM_OBSERVATION)}


def hmm_body(pp, table):
    """``table(name, state)``: the model's ``init``, ``T`` or ``means`` in the
    caller's array type, on ``state``'s device (None: the first draw)."""
    state = pp.sample(pp.distributions.Categorical(probs=table("init", None)))
    for t in range(len(HMM_OBSERVATION)):
        state = pp.sample(pp.distributions.Categorical(probs=table("T", state)[state]))
        pp.observe(pp.distributions.Normal(table("means", state)[state], 1.0), name=f"obs{t}")
    return state


_HMM_TABLES = {"init": HMM_INIT, "T": HMM_T, "means": HMM_MEANS}


class JaxHMM(pyprob_tpu.Model):
    def forward(self):
        return hmm_body(pyprob_tpu, lambda name, state: jnp.asarray(_HMM_TABLES[name], jnp.float32))


class TorchHMM(pyprob_tpu_torch.Model):
    def forward(self):
        def table(name, state):
            device = pyprob_tpu_torch.util.param_device() if state is None else state.device
            return torch.tensor(_HMM_TABLES[name], dtype=torch.float32, device=device)

        return hmm_body(pyprob_tpu_torch, table)


# p ~ Beta(2, 3), 20 Bernoulli observes (the Beta head: kernels 2 and 2b)
BETA_BERNOULLI_OBSERVE = {f"y{i}": float(i < 14) for i in range(20)}


def beta_bernoulli_body(pp):
    p = pp.sample(pp.distributions.Beta(2.0, 3.0))
    for i in range(20):
        pp.observe(pp.distributions.Bernoulli(probs=p), name=f"y{i}")
    return p


class JaxBetaBernoulli(pyprob_tpu.Model):
    def forward(self):
        return beta_bernoulli_body(pyprob_tpu)


class TorchBetaBernoulli(pyprob_tpu_torch.Model):
    def forward(self):
        return beta_bernoulli_body(pyprob_tpu_torch)


# rate ~ Gamma(2, 1), two Poisson observes (tests/test_proposals_extended.py:111-122)
def gamma_poisson_body(pp):
    rate = pp.sample(pp.distributions.Gamma(2.0, 1.0))
    likelihood = pp.distributions.Poisson(rate)
    pp.observe(likelihood, name="obs0")
    pp.observe(likelihood, name="obs1")
    return rate


class JaxGammaPoisson(pyprob_tpu.Model):
    def forward(self):
        return gamma_poisson_body(pyprob_tpu)


class TorchGammaPoisson(pyprob_tpu_torch.Model):
    def forward(self):
        return gamma_poisson_body(pyprob_tpu_torch)


# x ~ Laplace(0, 1), obs0 ~ Normal(x, 0.5) (tests/test_proposals_extended.py:
# 191-228): the StudentT-mixture head.  The interpreter-only copy carries
# _never_vectorize and a branch on the draw that adds an unobserved second
# Laplace site where x > 0: two trace types, so training takes the
# gather-table loss by itself, and x's posterior stays the same
LAPLACE_OBSERVE = {"obs0": 4.0}


def laplace_body(pp, branch=False):
    x = pp.sample(pp.distributions.Laplace(0.0, 1.0))
    if branch and x > 0:
        pp.sample(pp.distributions.Laplace(0.0, 1.0), name="side")
    pp.observe(pp.distributions.Normal(x, 0.5), name="obs0")
    return x


class JaxLaplace(pyprob_tpu.Model):
    def forward(self):
        return laplace_body(pyprob_tpu)


class TorchLaplace(pyprob_tpu_torch.Model):
    def forward(self):
        return laplace_body(pyprob_tpu_torch)


class TorchLaplaceInterpreter(pyprob_tpu_torch.Model):
    _never_vectorize = True

    def forward(self):
        return laplace_body(pyprob_tpu_torch, branch=True)


# p ~ Beta(2, 2), k0 = 7 and k1 = 9 ~ NegativeBinomial(5, p)
# (tests/test_distributions_r3.py:171-180): the posterior is Beta(12, 18)
NB_OBSERVE = {"k0": 7.0, "k1": 9.0}


def nb_body(pp):
    p = pp.sample(pp.distributions.Beta(2.0, 2.0), name="p")
    pp.observe(pp.distributions.NegativeBinomial(5.0, p), name="k0")
    pp.observe(pp.distributions.NegativeBinomial(5.0, p), name="k1")
    return p


class JaxNB(pyprob_tpu.Model):
    def forward(self):
        return nb_body(pyprob_tpu)


class TorchNB(pyprob_tpu_torch.Model):
    def forward(self):
        return nb_body(pyprob_tpu_torch)


# the event-shaped latents of tests/test_proposals_extended.py:231-410 and
# the conjugate models of tests/test_distributions_extra.py:115-134, their
# coordinates read as z[..., i] so one body runs on both packages' tiers.
# z ~ N(0, I_2), obs ~ N(z0 + z1, 0.2) = 4: the posterior mean is 1.961 per
# coordinate
MVN_LATENT_OBSERVE = {"obs": 4.0}


def mvn_latent_body(pp):
    z = pp.sample(pp.distributions.MultivariateNormal(np.zeros(2), covariance_matrix=np.eye(2)))
    pp.observe(pp.distributions.Normal(z[..., 0] + z[..., 1], 0.2), name="obs")
    return z


# p ~ Dir(2, 2, 2), obs ~ Categorical(p) = 2: the posterior is Dir(2, 2, 3)
DIRICHLET_LATENT_OBSERVE = {"obs": 2}


def dirichlet_latent_body(pp):
    p = pp.sample(pp.distributions.Dirichlet(np.ones(3) * 2.0))
    pp.observe(pp.distributions.Categorical(probs=p), name="obs")
    return p


# L ~ LKJCholesky(2, 1), y ~ N(0, L Lᵀ) = (2.2, 2.18): the result is the
# correlation L[1, 0]
LKJ_LATENT_OBSERVE = {"y": np.array([2.2, 2.18])}


def lkj_latent_body(pp):
    L = pp.sample(pp.distributions.LKJCholesky(2, 1.0))
    pp.observe(pp.distributions.MultivariateNormal(np.zeros(2), scale_tril=L), name="y")
    return L[..., 1, 0]


def dircat_body(pp):
    p = pp.sample(pp.distributions.Dirichlet(np.ones(3)))
    likelihood = pp.distributions.Categorical(probs=p)
    for name in ("o0", "o1", "o2"):
        pp.observe(likelihood, name=name)
    return p


def mvn_conjugate_body(pp):
    x = pp.sample(pp.distributions.MultivariateNormal(np.zeros(2), covariance_matrix=np.eye(2)))
    pp.observe(pp.distributions.MultivariateNormal(x, covariance_matrix=np.eye(2)), name="y")
    return x


class JaxMVNLatent(pyprob_tpu.Model):
    def forward(self):
        return mvn_latent_body(pyprob_tpu)


class TorchMVNLatent(pyprob_tpu_torch.Model):
    def forward(self):
        return mvn_latent_body(pyprob_tpu_torch)


class JaxDirichletLatent(pyprob_tpu.Model):
    def forward(self):
        return dirichlet_latent_body(pyprob_tpu)


class TorchDirichletLatent(pyprob_tpu_torch.Model):
    def forward(self):
        return dirichlet_latent_body(pyprob_tpu_torch)


class JaxLKJLatent(pyprob_tpu.Model):
    def forward(self):
        return lkj_latent_body(pyprob_tpu)


class TorchLKJLatent(pyprob_tpu_torch.Model):
    def forward(self):
        return lkj_latent_body(pyprob_tpu_torch)


class JaxDirCat(pyprob_tpu.Model):
    def forward(self):
        return dircat_body(pyprob_tpu)


class TorchDirCat(pyprob_tpu_torch.Model):
    def forward(self):
        return dircat_body(pyprob_tpu_torch)


class JaxMVNConjugate(pyprob_tpu.Model):
    def forward(self):
        return mvn_conjugate_body(pyprob_tpu)


class TorchMVNConjugate(pyprob_tpu_torch.Model):
    def forward(self):
        return mvn_conjugate_body(pyprob_tpu_torch)


def _port_distribution(d):
    """A JAX package distribution as the port's, its parameters on the CPU."""
    if d is None:
        return None
    D = pyprob_tpu_torch.distributions
    f = lambda a: torch.tensor(np.asarray(a), dtype=torch.float32)  # noqa: E731
    name = type(d).__name__
    if name in ("Mixture", "Factor", "Empirical") or not hasattr(D, name):
        raise TypeError(name)
    # the wrappers' bases are distributions, ported in turn
    if name == "Censored":
        return D.Censored(_port_distribution(d.base), lower=f(d.lower), upper=f(d.upper))
    if name == "ZeroInflated":
        return D.ZeroInflated(_port_distribution(d.base), gate=f(d.gate))
    cls = getattr(D, name)
    blank = cls.__new__(cls)
    if name.startswith("LKJCholesky"):
        blank._dim = d.dim
    return blank._with_leaves([f(getattr(d, "_" + n)) for n in d._param_names])


def port_trace(jtrace):
    """A JAX package trace (pruned or whole) as the port's ``Trace``: the
    same addresses and values, the distributions on the CPU."""
    from pyprob_tpu_torch.trace import Trace, Variable

    tr = Trace()
    for v in jtrace.variables:
        tr.add(Variable(
            distribution=_port_distribution(v.distribution),
            value=None if v.value is None else np.asarray(v.value, np.float32),
            address_base=v.address_base, address=v.address, instance=v.instance,
            control=v.control, name=v.name, observed=v.observed, tagged=v.tagged,
        ))
    tr.end(None, None)
    return tr


def unwrap_static(tree):
    if isinstance(tree, Static):
        return tree.value
    if isinstance(tree, dict):
        return {k: unwrap_static(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [unwrap_static(v) for v in tree]
    return np.asarray(tree) if hasattr(tree, "shape") else tree


def _embeddings(observe_dim, observe_names):
    return {name: {"dim": observe_dim} for name in observe_names}


def jax_network(model, lstm_dim=16, mixture_components=3, observe_dim=4, seed=7, vectorized=None,
                observe_names=("obs0", "obs1"), observe_embeddings=None):
    """An untrained pyprob_tpu LSTM network for ``model``: constructor plus
    layer pre-generation on two prior traces (``vectorized`` picks the
    tier that draws them).  Prior traces hold no observed values, so an
    observe of more than one element needs ``observe_embeddings`` with its
    ``reshape``."""
    pyprob_tpu.seed(seed)
    net = JaxLSTM(
        model=model,
        observe_embeddings=observe_embeddings or _embeddings(observe_dim, observe_names),
        lstm_dim=lstm_dim,
        proposal_mixture_components=mixture_components,
    )
    net._pre_generate_layers(model.prior(num_traces=2, vectorized=vectorized).get_values())
    return net


def carry(jnet, model):
    """The port's network with ``jnet``'s weights."""
    params = unwrap_static(jnet.snapshot_params()["params"])
    meta = {
        "head_meta": jnet._head_meta,
        "observe_meta": jnet._observe_meta,
        "observe_embedding_dim": jnet._observe_embedding_dim,
        "lstm_input_dim": jnet._lstm_input_dim,
        "local_observe_dim": jnet._local_observe_dim,
        "lstm_dim": jnet._lstm_dim,
        "lstm_depth": jnet._lstm_depth,
        "sample_embedding_dim": jnet._sample_embedding_dim,
        "address_embedding_dim": jnet._address_embedding_dim,
        "distribution_type_embedding_dim": jnet._distribution_type_embedding_dim,
        "proposal_mixture_components": jnet._proposal_mixture_components,
    }
    net = TorchLSTM.from_numpy(model, params, meta, device="cpu")
    model._inference_network = net
    return net


def jax_ff_network(model, mixture_components=3, observe_dim=4, seed=7, vectorized=None,
                   observe_names=("obs0", "obs1"), observe_embeddings=None):
    """An untrained pyprob_tpu feedforward network for ``model``, its heads
    grown from two prior traces (``vectorized`` picks the tier that draws
    them; ``observe_embeddings`` as for ``jax_network``)."""
    pyprob_tpu.seed(seed)
    net = JaxFF(
        model=model,
        observe_embeddings=observe_embeddings or _embeddings(observe_dim, observe_names),
        proposal_mixture_components=mixture_components,
    )
    net._pre_generate_layers(model.prior(num_traces=2, vectorized=vectorized).get_values())
    return net


def carry_ff(jnet, model):
    """The port's feedforward network with ``jnet``'s weights."""
    params = unwrap_static(jnet.snapshot_params()["params"])
    meta = {
        "head_meta": jnet._head_meta,
        "observe_meta": jnet._observe_meta,
        "observe_embedding_dim": jnet._observe_embedding_dim,
        "proposal_mixture_components": jnet._proposal_mixture_components,
    }
    net = TorchFF.from_numpy(model, params, meta, device="cpu")
    model._inference_network = net
    return net


# ---------------------------------------------------------------------------
# the tempered and variational engines' models (tests/test_pt.py,
# test_tempered_smc.py, test_vi.py, test_svgd.py), each body with its
# closed-form posterior where it has one
# ---------------------------------------------------------------------------


def hierarchy_body(pp, both=False):
    """x1 ~ N(0, 1), x2 ~ N(x1, 1), y ~ N(x2, 1): at y = 2 the posterior
    mean is [2/3, 4/3], covariance [[2/3, 1/3], [1/3, 2/3]], log Z -2.135."""
    x1 = pp.sample(pp.distributions.Normal(0.0, 1.0))
    x2 = pp.sample(pp.distributions.Normal(x1, 1.0))
    pp.observe(pp.distributions.Normal(x2, 1.0), name="y")
    return (x1, x2) if both else x1


def bimodal_body(pp, stddev=1.0):
    """y ~ N(mu², stddev), mu ~ N(0, 3): modes at ±sqrt(y)."""
    mu = pp.sample(pp.distributions.Normal(0.0, 3.0))
    pp.observe(pp.distributions.Normal(mu * mu, stddev), name="y")
    return mu


def uniform_gum_body(pp):
    """GUM under a Uniform(0, 20) prior: at OBSERVE about N(8.5, 1)."""
    mu = pp.sample(pp.distributions.Uniform(0.0, 20.0))
    likelihood = pp.distributions.Normal(mu, math.sqrt(2.0))
    pp.observe(likelihood, name="obs0")
    pp.observe(likelihood, name="obs1")
    return mu


def positive_body(pp):
    """lam ~ Exponential(1), y ~ N(lam, 0.5): at y = 2 the mean is 1.76."""
    lam = pp.sample(pp.distributions.Exponential(1.0))
    pp.observe(pp.distributions.Normal(lam, 0.5), name="y")
    return lam


def mix_body(pp, where):
    """mu ~ N(0, 5), k ~ Categorical([0.5, 0.5]), y ~ N(mu ∓ 2, 1)."""
    mu = pp.sample(pp.distributions.Normal(0.0, 5.0))
    k = pp.sample(pp.distributions.Categorical(probs=[0.5, 0.5]))
    pp.observe(pp.distributions.Normal(mu + where(k == 0, -2.0, 2.0), 1.0), name="y")
    return mu


def depmix_body(pp, asarray):
    """d ~ Categorical([0.3, 0.7]), x ~ N([-3, 3][d], 1), y ~ N(x, 0.5): a
    continuous site whose prior depends on the enumerated latent."""
    d = pp.sample(pp.distributions.Categorical(probs=[0.3, 0.7]))
    centers = asarray([-3.0, 3.0])
    x = pp.sample(pp.distributions.Normal(centers[d], 1.0))
    pp.observe(pp.distributions.Normal(x, 0.5), name="y")
    return x


def banana_body(pp, stack):
    """x ~ N(0, 1), y ~ N(0, 2), w ~ N(y − x², 0.3): a curved posterior."""
    x = pp.sample(pp.distributions.Normal(0.0, 1.0))
    y = pp.sample(pp.distributions.Normal(0.0, 2.0))
    pp.observe(pp.distributions.Normal(y - x * x, 0.3), name="w")
    return stack([x, y])


def body_pair(body, *jax_args, torch_args=None, **kwargs):
    """The JAX package's and the port's model of one body (equal
    addresses); ``torch_args`` replace ``jax_args`` for the port."""
    torch_args = jax_args if torch_args is None else torch_args

    class J(pyprob_tpu.Model):
        def forward(self):
            return body(pyprob_tpu, *jax_args, **kwargs)

    class T(pyprob_tpu_torch.Model):
        def forward(self):
            return body(pyprob_tpu_torch, *torch_args, **kwargs)

    return J(), T()


def mix_pair():
    return body_pair(mix_body, jnp.where, torch_args=(torch.where,))


def depmix_pair():
    return body_pair(depmix_body, jnp.asarray, torch_args=(torch.tensor,))


def _norm_log_pdf(x, m, s):
    return -0.5 * ((x - m) / s) ** 2 - math.log(s) - 0.5 * math.log(2 * math.pi)


def mixture_posterior(name, y=1.0):
    """(mean, stddev, log Z) of mix_body's or depmix_body's posterior at y:
    a two-component Gaussian mixture in closed form."""
    if name == "mix":
        # mu | k, y ~ N(25 (y ± 2) / 26, 25/26), p(k) N(y; ∓2, sqrt 26)
        comps = [(25 * (y - s) / 26, 25 / 26, math.log(0.5) + _norm_log_pdf(y, s, math.sqrt(26.0)))
                 for s in (-2.0, 2.0)]
    else:
        # x | d, y ~ N((c_d + 4 y) / 5, 1/5), p_d N(y; c_d, sqrt 1.25)
        comps = [((c + 4.0 * y) / 5, 0.2, math.log(p) + _norm_log_pdf(y, c, math.sqrt(1.25)))
                 for p, c in ((0.3, -3.0), (0.7, 3.0))]
    logs = np.array([c[2] for c in comps])
    log_z = float(np.max(logs) + np.log(np.sum(np.exp(logs - np.max(logs)))))
    w = np.exp(logs - log_z)
    mean = float(sum(wi * m for wi, (m, _, _) in zip(w, comps)))
    var = float(sum(wi * (v + m * m) for wi, (m, v, _) in zip(w, comps))) - mean * mean
    return mean, math.sqrt(var), log_z
