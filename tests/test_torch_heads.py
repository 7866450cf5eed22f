"""The port's proposal heads for Categorical, Bernoulli, Poisson, Beta,
VonMises, the positive-support priors and the heavy-tailed priors against
the JAX package's (``pyprob_tpu/nn/proposals.py``), on the CPU (the
event-shaped and alternative heads are in
``tests/test_torch_event_shaped.py``).

``head_kind_for`` and ``prior_param_arrays`` for every ported class, and
for the four classes with no head; each head kind's ``head_apply`` on a
JAX head carried into the port (the proposal's log-density at values
inside and, for the truncated heads, at the bounds, and far in the tails
for the StudentT-mixture heads; its mixture's parameters), and one loss's
gradients (−Σ log q of the values) with respect to the head's weights and
its input, within 1e-5 (1e-5 + 1e-4 |ref| for the truncated-Normal heads,
the float32 cancellation of the truncated mixture's terms, and for the
StudentT-mixture heads, whose lgamma(ν/2) and log1p(z²/ν) lose float32
precision near the df floor 0.5).  On the CPU the truncated mixture is
the kernel's plain version; its kernel branch is taken (one ``low`` and
one ``high`` shared by the components).
"""

import functools
import math

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import pyprob_tpu_torch as pp
from pyprob_tpu import distributions as JD
from pyprob_tpu.nn import proposals as JP
from pyprob_tpu_torch import distributions as TD
from pyprob_tpu_torch.nn import proposals as TP
from pyprob_tpu_torch.nn.layers import tensor_leaves

from pyprob_tpu.nn.layers import Static
from _torch_parity import unwrap_static

torch.set_num_threads(2)
B, H, K = 8, 6, 3


@pytest.fixture(autouse=True)
def _port_on_cpu():
    pp.set_device("cpu")
    pp.seed(0)
    yield


# name: batched prior parameters (B = 8 rows)
PRIORS = {
    "Normal": dict(loc=np.linspace(-1, 1, B), scale=np.linspace(0.5, 2, B)),
    "Uniform": dict(low=np.linspace(-2, 0, B), high=np.linspace(1, 3, B)),
    "Categorical": dict(probs=np.tile([0.2, 0.5, 0.3], (B, 1))),
    "Bernoulli": dict(probs=np.linspace(0.1, 0.9, B)),
    "Poisson": dict(rate=np.linspace(0.5, 8, B)),
    "Beta": dict(concentration1=np.linspace(0.5, 3, B), concentration0=np.full(B, 2.0),
                 low=np.full(B, -1.0), high=np.full(B, 2.0)),
    "VonMises": dict(loc=np.linspace(-1, 1, B), concentration=np.linspace(0.5, 4, B)),
    "Gamma": dict(concentration=np.linspace(0.5, 5, B), rate=np.linspace(0.5, 2, B)),
    "Exponential": dict(rate=np.linspace(0.5, 3, B)),
    "LogNormal": dict(loc=np.linspace(-1, 1, B), scale=np.linspace(0.3, 1.5, B)),
    "Weibull": dict(scale=np.linspace(0.5, 2, B), concentration=np.linspace(0.7, 3, B)),
    "Chi2": dict(df=np.linspace(1, 6, B)),
    "HalfNormal": dict(scale=np.linspace(0.5, 2, B)),
    "HalfCauchy": dict(scale=np.linspace(0.5, 2, B)),
    "InverseGamma": dict(concentration=np.linspace(1.5, 5, B), rate=np.linspace(0.5, 2, B)),
    "Pareto": dict(scale=np.linspace(0.5, 2, B), alpha=np.linspace(1.5, 4, B)),
    "Binomial": dict(total_count=np.full(B, 5.0), probs=np.linspace(0.1, 0.9, B)),
    "StudentT": dict(df=np.linspace(0.6, 8, B), loc=np.linspace(-1, 1, B), scale=np.linspace(0.5, 2, B)),
    "Laplace": dict(loc=np.linspace(-1, 1, B), scale=np.linspace(0.5, 2, B)),
    "Cauchy": dict(loc=np.linspace(-1, 1, B), scale=np.linspace(0.5, 2, B)),
    "Logistic": dict(loc=np.linspace(-1, 1, B), scale=np.linspace(0.5, 2, B)),
    "Gumbel": dict(loc=np.linspace(-1, 1, B), scale=np.linspace(0.5, 2, B)),
    # no head: sites of these classes propose from the prior
    "Geometric": dict(probs=np.linspace(0.1, 0.9, B)),
    "NegativeBinomial": dict(total_count=np.full(B, 5.0), probs=np.linspace(0.1, 0.9, B)),
    "Censored": dict(loc=np.linspace(-1, 1, B), scale=np.full(B, 1.0), upper=np.full(B, 1.0)),
    "ZeroInflated": dict(rate=np.linspace(0.5, 8, B), gate=np.full(B, 0.3)),
}


def _priors(name):
    params = {k: np.asarray(v, np.float32) for k, v in PRIORS[name].items()}
    out = []
    for lib, array in ((JD, jnp.asarray), (TD, torch.from_numpy)):
        p = {k: array(v) for k, v in params.items()}
        if name == "Censored":
            out.append(lib.Censored(lib.Normal(p["loc"], p["scale"]), upper=p["upper"]))
        elif name == "ZeroInflated":
            out.append(lib.ZeroInflated(lib.Poisson(p["rate"]), gate=p["gate"]))
        else:
            out.append(getattr(lib, name)(**p))
    return tuple(out)


@pytest.mark.parametrize("name", sorted(PRIORS))
def test_head_kind_and_prior_params_match(name):
    j, t = _priors(name)
    assert TP.head_kind_for(t) == JP.head_kind_for(j)
    if name in ("Geometric", "NegativeBinomial", "Censored", "ZeroInflated"):
        assert TP.head_kind_for(t) is None
    jp, tp = JP.prior_param_arrays(j), TP.prior_param_arrays(t)
    assert sorted(tp) == sorted(jp)
    for k in jp:
        np.testing.assert_allclose(
            np.broadcast_to(tp[k].numpy(), (B,)), np.broadcast_to(np.asarray(jp[k]), (B,)),
            rtol=1e-5, atol=1e-6, err_msg=k,
        )


# head case: (prior, values the proposal scores, truncated?)
HEADS = {
    "categorical": ("Categorical", [0, 1, 2, 2, 1, 0, 1, 2], False),
    "bernoulli": ("Bernoulli", [0, 1, 1, 0, 1, 0, 0, 1], False),
    "poisson": ("Poisson", [0.0, 3.0, 7.0, 12.0, 40.0, 1.0, 2.5, 39.0], True),
    "beta": ("Beta", [-1.0, -0.5, 0.0, 0.7, 1.2, 1.9, 2.0, 0.1], True),
    "von_mises": ("VonMises", [-3.0, -1.0, 0.0, 0.5, 1.5, 2.0, 3.5, 0.9], True),
    "lognormal_gamma": ("Gamma", [0.1, 0.5, 1.0, 2.0, 3.0, 5.0, 8.0, 0.3], False),
    "lognormal_pareto": ("Pareto", [0.6, 1.0, 1.5, 2.0, 3.0, 5.0, 8.0, 1.1], False),
    "lognormal_halfcauchy": ("HalfCauchy", [0.1, 0.5, 1.0, 2.0, 3.0, 5.0, 8.0, 0.3], False),
    "studentt_laplace": ("Laplace", [-1e6, -3.0, -0.5, 0.0, 0.4, 2.0, 7.0, 1e6], False),
    "studentt_studentt": ("StudentT", [-40.0, -3.0, -0.5, 0.0, 0.4, 2.0, 7.0, 1e7], False),
    "studentt_gumbel": ("Gumbel", [-5.0, -3.0, -0.5, 0.0, 0.4, 2.0, 7.0, 60.0], False),
    # a carried head that predates the df_floor key decodes df from 1.0
    "studentt_cauchy_no_df_floor": ("Cauchy", [-1e6, -3.0, -0.5, 0.0, 0.4, 2.0, 7.0, 1e6], False),
}


def _heads(case, seed=3):
    prior_name, values, truncated = HEADS[case]
    jprior, tprior = _priors(prior_name)
    kind = JP.head_kind_for(jprior)
    nc = 3 if kind == "categorical" else None
    jparams = JP.head_init(jax.random.PRNGKey(seed), kind, H, mixture_components=K, num_categories=nc)
    if case.endswith("no_df_floor"):
        meta = {k: v for k, v in jparams["meta"].value.items() if k != "df_floor"}
        jparams = {"ff": jparams["ff"], "meta": Static(meta)}
    tparams = TP.head_from_numpy(unwrap_static(jparams), "cpu")
    if kind == "studentt_mixture":
        assert tparams["meta"].get("df_floor") == (None if case.endswith("no_df_floor") else 0.5)
    x = np.random.default_rng(seed).normal(size=(B, H)).astype(np.float32)
    return jprior, tprior, jparams, tparams, x, np.asarray(values, np.float32), truncated


@functools.lru_cache(maxsize=None)
def _jax_reference(case):
    """The JAX head's proposal at ``case``'s values, its mixture's
    parameters, and the loss −Σ max(log q, −1e38) with its gradients with
    respect to the head's weights and its input: one jitted call."""
    jprior, _, jparams, _, x, values, _ = _heads(case)
    jpp = JP.prior_param_arrays(jprior)
    static = {k: v for k, v in jparams.items() if k == "meta"}

    def run(ff, xx):
        d = JP.head_apply({"ff": ff, **static}, xx, jpp)
        lp = d.log_prob(jnp.asarray(values))
        if isinstance(d, JD.Mixture):
            leaves = [jnp.broadcast_to(leaf, (B,)) for c in d.distributions for leaf in c._leaves()]
        else:
            leaves = []
        return -jnp.sum(jnp.maximum(lp, -1e38)), (lp, d.probs, leaves)

    (loss, (lp, probs, leaves)), (gff, gx) = jax.jit(
        jax.value_and_grad(run, argnums=(0, 1), has_aux=True)
    )(jparams["ff"], jnp.asarray(x))
    return {
        "loss": float(loss), "log_prob": np.asarray(lp), "probs": np.asarray(probs),
        "leaves": [np.asarray(a) for a in leaves], "grad_x": np.asarray(gx),
        "grad_layers": unwrap_static(gff)["layers"],
    }


def _tol(case):
    loose = HEADS[case][2] or case.startswith("studentt")
    return dict(atol=1e-5, rtol=1e-4 if loose else 1e-5)


@pytest.mark.parametrize("case", sorted(HEADS))
def test_head_apply_matches(case):
    _, tprior, _, tparams, x, values, truncated = _heads(case)
    ref = _jax_reference(case)
    td = TP.head_apply(tparams, torch.from_numpy(x), TP.prior_param_arrays(tprior))
    assert td.batch_shape == (B,)
    np.testing.assert_allclose(td.log_prob(torch.from_numpy(values)).numpy(), ref["log_prob"], **_tol(case))
    np.testing.assert_allclose(td.probs.numpy(), ref["probs"], rtol=1e-5, atol=1e-7)
    if isinstance(td, TD.Mixture):
        leaves = [leaf.expand(B) for c in td.distributions for leaf in c._leaves()]
        assert len(leaves) == len(ref["leaves"])
        for leaf_t, leaf_j in zip(leaves, ref["leaves"]):
            np.testing.assert_allclose(leaf_t.numpy(), leaf_j, rtol=1e-5, atol=1e-6)
        # the truncated heads take the kernel's branch
        assert (td._stacked_tnorm_params() is not None) == truncated
    # draws lie where the proposal puts mass
    draws = td.sample(torch.Generator().manual_seed(0))
    assert draws.shape == (B,) and bool(torch.isfinite(td.log_prob(draws)).all())


@pytest.mark.parametrize("case", sorted(HEADS))
def test_head_loss_gradients_match(case):
    _, tprior, _, tparams, x, values, truncated = _heads(case)
    ref = _jax_reference(case)
    for p in tensor_leaves(tparams):
        p.requires_grad_(True)
    tx = torch.from_numpy(x).requires_grad_(True)
    td = TP.head_apply(tparams, tx, TP.prior_param_arrays(tprior))
    loss = -torch.clamp(td.log_prob(torch.from_numpy(values)), min=-1e38).sum()
    loss.backward()
    assert float(loss.detach()) == pytest.approx(ref["loss"], rel=1e-5)
    tol = _tol(case)
    np.testing.assert_allclose(tx.grad.numpy(), ref["grad_x"], **tol)
    for tlayer, jlayer in zip(tparams["ff"]["layers"], ref["grad_layers"]):
        np.testing.assert_allclose(tlayer["w"].grad.numpy().T, jlayer["w"], **tol)
        np.testing.assert_allclose(tlayer["b"].grad.numpy(), jlayer["b"], **tol)


def test_unported_head_kinds_name_their_slice():
    """Every head kind of the JAX package is ported
    (``tests/test_torch_event_shaped.py`` holds the event-shaped and
    alternative heads): an unknown kind raises ValueError, as the JAX
    package's ``head_init`` does, and so do a categorical head without
    ``num_categories`` and an event-shaped head without ``event_dim``."""
    with pytest.raises(ValueError, match="Unknown proposal head kind"):
        TP.head_init(torch.Generator(), "no_such_kind", 4, "cpu")
    with pytest.raises(ValueError, match="Unknown proposal head kind"):
        TP.head_distribution({"kind": "no_such_kind", "mixture_components": 3}, torch.zeros((2, 9)), {})
    with pytest.raises(ValueError, match="num_categories"):
        TP.head_init(torch.Generator(), "categorical", 4, "cpu")
    for kind in ("mvn", "dirichlet", "lkj_cpc_normal"):
        with pytest.raises(ValueError, match="event_dim"):
            TP.head_init(torch.Generator(), kind, 4, "cpu")


def test_log_space_moments_are_exact():
    """The positive-support priors' log-space (mean, stddev) against 10^5
    draws' (``tests/test_proposals_extended.py``'s check, within 0.02)."""
    g = torch.Generator().manual_seed(2)
    for name in ("Gamma", "Exponential", "LogNormal", "Weibull", "Chi2", "HalfNormal", "InverseGamma", "Pareto"):
        t = getattr(TD, name)(**{k: float(v[3]) for k, v in PRIORS[name].items()})
        p = TP.prior_param_arrays(t)
        logs = torch.log(t.sample(g, (100_000,))).double()
        assert abs(float(p["log_loc"]) - float(logs.mean())) < 0.02, name
        assert abs(float(p["log_scale"]) - float(logs.std())) < 0.02, name
    assert math.isfinite(float(TP.prior_param_arrays(TD.HalfCauchy(1.0))["log_scale"]))
