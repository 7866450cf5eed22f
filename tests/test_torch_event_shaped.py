"""The event-shaped slice of the port against the JAX package, on the CPU:
Dirichlet, Multinomial, LKJCholesky and LKJCholeskyCPCNormal, the six
heads it adds (``mvn``, ``dirichlet``, ``lkj_cpc_normal`` and the
reference's alternative ``normal_normal``, ``uniform_beta`` and
``uniform_beta_mixture``), and IC on vector- and matrix-valued latents.

The distributions: ``log_prob`` of each class against the JAX package's
within 1e-5 (1 + |ref|), batched and unbatched, on and off the support,
with the same +inf, −inf and NaN entries; ``mean`` and ``variance``; 10^5
draws within 5 standard errors of the moments (an LKJ factor's implied
correlations against their Beta marginal), LKJ rows of unit norm within
1e-5; a Dirichlet at α = 1e-4 whose rows have no NaN and sum to 1 within
1e-5, and whose components that underflow to 0 score as the JAX package
scores them; the CPC-chart proposal's importance weights against
LKJCholesky(3, 1.5) averaging 1 within 0.1; the chart against the JAX
package's.

The heads: a JAX head carried into the port gives the same proposal
parameters and log-density (rtol 1e-5), and the same loss and gradients
with respect to its weights and its input (rtol 1e-5, atol 1e-6), at
values where log q is finite; a zeroed ``mvn`` or ``dirichlet`` head
proposes the prior itself, and a prior shared by the batch is read for
every row.

The paths, with networks carried from the JAX package (lstm_dim 16,
8-d observe embeddings): one training step's loss (rel 1e-5) and every
gradient (1e-5 relative in the 2-norm) for the MultivariateNormal,
Dirichlet and LKJ latents with the feedforward network and the LSTM; one
lockstep round of MultivariateNormal and Dirichlet sites (trace starts
and steady sites whose previous value has two columns) row by row against
the sequential step within 1e-4 (1 + |ref|); an interpreter batch with a
MultivariateNormal site taking the per-type loss, not the gather loss, in
both packages and with equal values; a save/load round trip serving
bit-equal on the batched tier; a Multinomial latent refused as the JAX
package refuses it; prior IS of the Dirichlet–Categorical and conjugate
MultivariateNormal models on both tiers within the JAX tests' limits.
"""

import math

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import pyprob_tpu
import pyprob_tpu_torch as pp
from pyprob_tpu import backend as JB
from pyprob_tpu import distributions as JD
from pyprob_tpu.distributions import lkj as JL
from pyprob_tpu.nn import proposals as JP
from pyprob_tpu.nn.dataset import Batch as JBatch, OnlineDataset as JOnline
from pyprob_tpu_torch import distributions as TD
from pyprob_tpu_torch import vectorized as V
from pyprob_tpu_torch.distributions import lkj as TL
from pyprob_tpu_torch.nn import Batch, PackedBatch
from pyprob_tpu_torch.nn import gather_loss as gl
from pyprob_tpu_torch.nn import proposals as TP
from pyprob_tpu_torch.nn.layers import map_tensors, tensor_leaves
from pyprob_tpu_torch.util import InferenceEngine as TEngine

import chip_smoke
from _torch_parity import (
    DIRICHLET_LATENT_OBSERVE,
    LKJ_LATENT_OBSERVE,
    MVN_LATENT_OBSERVE,
    JaxDirichletLatent,
    JaxLKJLatent,
    JaxMVNLatent,
    TorchDirCat,
    TorchDirichletLatent,
    TorchLKJLatent,
    TorchMVNConjugate,
    TorchMVNLatent,
    carry,
    carry_ff,
    jax_ff_network,
    jax_network,
    port_trace,
    unwrap_static,
)

torch.set_num_threads(2)
IC = TEngine.IMPORTANCE_SAMPLING_WITH_INFERENCE_NETWORK
B, H, K = 6, 5, 3


@pytest.fixture(autouse=True)
def _port_on_cpu():
    pp.set_device("cpu")
    pp.set_verbosity(0)
    pp.seed(0)
    yield


def _same(port, ref, tol=1e-5):
    """Equal +inf, −inf and NaN entries; finite ones within tol (1 + |ref|)."""
    port, ref = np.asarray(port, np.float64), np.asarray(ref, np.float64)
    assert port.shape == ref.shape
    np.testing.assert_array_equal(np.isnan(port), np.isnan(ref))
    np.testing.assert_array_equal(np.isposinf(port), np.isposinf(ref))
    np.testing.assert_array_equal(np.isneginf(port), np.isneginf(ref))
    fin = np.isfinite(ref)
    assert np.all(np.abs(port[fin] - ref[fin]) <= tol * (1 + np.abs(ref[fin])))


# ---------------------------------------------------------------------------
# the distributions
# ---------------------------------------------------------------------------

_rng = np.random.default_rng(11)
_L3 = TD.LKJCholesky(3, torch.tensor(1.5)).sample(torch.Generator().manual_seed(4), (5,)).numpy()
_OFF_L = np.array([[1.0, 0.0, 0.0], [0.6, -0.8, 0.0], [0.3, 0.4, 0.0]], np.float32)  # diagonal <= 0
# case: (JAX class, port class, args (arrays), values, batched?)
LOG_PROB_CASES = {
    "dirichlet": (
        lambda lib, a: lib.Dirichlet(a),
        [np.array([2.0, 0.5, 1.0], np.float32)],
        np.array([[0.2, 0.3, 0.5], [0.0, 0.5, 0.5], [0.5, 0.5, 0.0], [-0.1, 0.6, 0.5], [1.0, 0.0, 0.0]], np.float32),
    ),
    "dirichlet_batched": (
        lambda lib, a: lib.Dirichlet(a),
        [np.array([[2.0, 0.5, 1.0], [1e-4, 3.0, 1.0], [1.0, 1.0, 1.0], [0.3, 0.3, 7.0]], np.float32)],
        np.array([[0.2, 0.3, 0.5], [0.0, 0.5, 0.5], [0.5, 0.5, 0.0], [-0.1, 0.6, 0.5]], np.float32),
    ),
    "multinomial": (
        lambda lib, n, p: lib.Multinomial(n, probs=p),
        [np.float32(6.0), np.array([0.2, 0.3, 0.5], np.float32)],
        np.array([[1, 2, 3], [0, 0, 6], [6, 0, 0], [2.5, 1, 2.5], [-1, 3, 4]], np.float32),
    ),
    "multinomial_batched": (
        lambda lib, n, p: lib.Multinomial(n, probs=p),
        [np.array([6.0, 3.0, 10.0], np.float32), np.array([[0.2, 0.3, 0.5], [0.0, 0.5, 0.5], [0.9, 0.05, 0.05]], np.float32)],
        np.array([[1, 2, 3], [1, 1, 1], [10, 0, 0]], np.float32),
    ),
    "lkj": (
        lambda lib, eta: lib.LKJCholesky(3, eta),
        [np.float32(1.5)],
        np.concatenate([_L3, np.eye(3, dtype=np.float32)[None], _OFF_L[None]]),
    ),
    "lkj_batched": (
        lambda lib, eta: lib.LKJCholesky(3, eta),
        [np.array([0.5, 1.0, 2.0, 4.0, 1.5], np.float32)],
        _L3,
    ),
    "lkj_cpc_normal": (
        lambda lib, loc, ls: (JL if lib is JD else TL).LKJCholeskyCPCNormal(loc, ls, 3),
        [np.array([0.1, -0.4, 0.3], np.float32), np.array([0.0, -0.5, 0.2], np.float32)],
        np.concatenate([_L3, np.eye(3, dtype=np.float32)[None]]),
    ),
    "lkj_cpc_normal_batched": (
        lambda lib, loc, ls: (JL if lib is JD else TL).LKJCholeskyCPCNormal(loc, ls, 3),
        [_rng.normal(size=(5, 3)).astype(np.float32), _rng.normal(size=(5, 3)).astype(np.float32) * 0.3],
        _L3,
    ),
}


def _pair(case):
    make, args, values = LOG_PROB_CASES[case]
    j = make(JD, *[jnp.asarray(a) for a in args])
    t = make(TD, *[torch.from_numpy(np.asarray(a)) for a in args])
    return j, t, values


@pytest.mark.parametrize("case", sorted(LOG_PROB_CASES))
def test_log_prob_matches(case):
    j, t, values = _pair(case)
    assert t.batch_shape == tuple(j.batch_shape) and t.event_shape == tuple(j.event_shape)
    make, args, _ = LOG_PROB_CASES[case]

    @jax.jit
    def ref(v, *a):
        d = make(JD, *a)
        return d.log_prob(v), d.log_prob(v[:1], sum=True)

    lp, lp_sum = ref(jnp.asarray(values), *[jnp.asarray(a) for a in args])
    _same(t.log_prob(torch.from_numpy(values)).numpy(), np.asarray(lp))
    assert float(t.log_prob(torch.from_numpy(values[:1]), sum=True)) == pytest.approx(
        float(lp_sum), rel=1e-5, abs=1e-5
    )


@pytest.mark.parametrize("case", ["dirichlet", "dirichlet_batched", "multinomial", "multinomial_batched"])
def test_mean_and_variance_match(case):
    j, t, _ = _pair(case)
    np.testing.assert_allclose(t.mean.numpy(), np.asarray(j.mean), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(t.variance.numpy(), np.asarray(j.variance), rtol=1e-5, atol=1e-7)


def _within_5se(x, expected, what):
    """Each column's mean of ``x`` [n, ...] within 5 standard errors of
    ``expected``."""
    x = x.double().reshape(x.shape[0], -1)
    se = x.std(0) / math.sqrt(x.shape[0])
    err = (x.mean(0) - torch.as_tensor(expected, dtype=torch.float64).reshape(-1)).abs()
    assert bool((err <= 5 * se).all()), (what, err, se)


def test_draws_match_the_moments():
    g = torch.Generator().manual_seed(1)
    n = 20_000
    d = TD.Dirichlet(torch.tensor([2.0, 0.5, 1.0]))
    x = d.sample(g, (n,))
    assert x.shape == (n, 3) and float((x.sum(-1) - 1).abs().max()) <= 1e-5
    _within_5se(x, d.mean, "Dirichlet mean")
    _within_5se((x - d.mean) ** 2, d.variance, "Dirichlet variance")
    m = TD.Multinomial(10.0, probs=torch.tensor([0.2, 0.3, 0.5]))
    c = m.sample(g, (n,))
    assert bool((c.sum(-1) == 10).all()) and bool((c == c.round()).all())
    _within_5se(c, m.mean, "Multinomial mean")
    _within_5se((c - m.mean) ** 2, m.variance, "Multinomial variance")
    # LKJ(3, 1.5): each implied correlation is 2 Beta(2, 2) − 1, mean 0,
    # variance 1/5
    L = TD.LKJCholesky(3, 1.5).sample(g, (n,))
    assert L.shape == (n, 3, 3) and float((L.pow(2).sum(-1) - 1).abs().max()) <= 1e-5
    assert bool((torch.triu(L, diagonal=1) == 0).all()) and bool((torch.diagonal(L, dim1=-2, dim2=-1) > 0).all())
    W = L @ L.mT
    r = torch.stack([W[:, 1, 0], W[:, 2, 0], W[:, 2, 1]], -1)
    _within_5se(r, [0.0] * 3, "LKJ correlations")
    _within_5se(r * r, [0.2] * 3, "LKJ correlations' variance")


def test_small_concentration_dirichlet_rows_are_simplices():
    d = TD.Dirichlet(torch.full((3,), 1e-4))
    x = d.sample(torch.Generator().manual_seed(2), (20_000,))
    assert not bool(torch.isnan(x).any())
    assert float((x.sum(-1) - 1).abs().max()) <= 1e-5
    assert bool((x == 0).any())  # components underflow, rows do not
    # such values score as the JAX package scores them (+inf at the zeros)
    rows = x[:512].numpy()
    ref = jax.jit(lambda v: JD.Dirichlet(jnp.full((3,), 1e-4)).log_prob(v))(jnp.asarray(rows))
    _same(d.log_prob(torch.from_numpy(rows)).numpy(), np.asarray(ref))


def test_lkj_cpc_normal_density_is_exact():
    q = TL.LKJCholeskyCPCNormal(torch.zeros(3), torch.zeros(3), 3)
    p = TD.LKJCholesky(3, 1.5)
    L = q.sample(torch.Generator().manual_seed(3), (100_000,))
    lw = (p.log_prob(L) - q.log_prob(L)).double()
    assert abs(float(torch.exp(torch.logsumexp(lw, 0) - math.log(lw.numel()))) - 1.0) < 0.1


def test_cpc_chart_matches():
    z = np.random.default_rng(5).normal(size=(7, 6)).astype(np.float32) * 1.5
    L, logdet = TL._cpc_to_chol(torch.from_numpy(z), 4)
    jL, jlogdet, jback = jax.jit(
        lambda v: (lambda L, ld: (L, ld, JL._chol_to_cpc(JB.JAX, L, 4)))(*JL._cpc_to_chol(JB.JAX, v, 4))
    )(jnp.asarray(z))
    np.testing.assert_allclose(L.numpy(), np.asarray(jL), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(logdet.numpy(), np.asarray(jlogdet), rtol=1e-5, atol=1e-5)
    back = TL._chol_to_cpc(L, 4)
    np.testing.assert_allclose(back.numpy(), np.asarray(jback), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("name", ["MultivariateNormal", "Dirichlet", "LKJCholesky", "Multinomial"])
def test_head_kind_event_dim_and_prior_params_match(name):
    make = {
        "MultivariateNormal": lambda lib, a: lib.MultivariateNormal(a(np.ones(3)), scale_tril=a(np.tril(np.ones((3, 3))))),
        "Dirichlet": lambda lib, a: lib.Dirichlet(a(np.ones(4))),
        "LKJCholesky": lambda lib, a: lib.LKJCholesky(3, a(2.0)),
        "Multinomial": lambda lib, a: lib.Multinomial(a(5.0), probs=a(np.ones(3) / 3)),
    }[name]
    j = make(JD, lambda v: jnp.asarray(v, jnp.float32))
    t = make(TD, lambda v: torch.tensor(v, dtype=torch.float32))
    assert TP.head_kind_for(t) == JP.head_kind_for(j)
    assert TP.event_dim_for(t) == JP.event_dim_for(j)
    jp, tp = JP.prior_param_arrays(j), TP.prior_param_arrays(t)
    assert sorted(tp) == sorted(jp)
    for k in jp:
        np.testing.assert_array_equal(tp[k].numpy(), np.asarray(jp[k]))


# ---------------------------------------------------------------------------
# the heads
# ---------------------------------------------------------------------------


def _tril(rows):
    out = np.tril(rows.normal(size=(B, 3, 3)).astype(np.float32) * 0.4)
    idx = np.arange(3)
    out[:, idx, idx] = np.abs(out[:, idx, idx]) + 0.5
    return out


_hr = np.random.default_rng(21)
_MVN_LOC, _MVN_TRIL = _hr.normal(size=(B, 3)), _tril(_hr)
_DIR_CONC = _hr.uniform(0.3, 3.0, size=(B, 4))
# kind: (prior maker (lib, array), event_dim, values: inside the support,
# where log q is finite (at log q = −inf the JAX package's gradients are
# NaN), with the uniform heads' lower bound)
HEADS = {
    "mvn": (
        lambda lib, a: lib.MultivariateNormal(a(_MVN_LOC), scale_tril=a(_MVN_TRIL)),
        3, _hr.normal(size=(B, 3)) * 2.0,
    ),
    "dirichlet": (lambda lib, a: lib.Dirichlet(a(_DIR_CONC)), 4, _hr.dirichlet(np.ones(4), size=B)),
    "lkj_cpc_normal": (lambda lib, a: lib.LKJCholesky(3, a(np.full(B, 1.5))), 3, _L3[[0, 1, 2, 3, 4, 0]]),
    "normal_normal": (
        lambda lib, a: lib.Normal(a(np.linspace(-1, 1, B)), a(np.linspace(0.5, 2, B))),
        None, np.linspace(-3, 4, B),
    ),
    "uniform_beta": (
        lambda lib, a: lib.Uniform(a(np.linspace(-2, 0, B)), a(np.linspace(1, 3, B))),
        None, np.array([-2.0, -1.0, 0.2, 0.9, 2.0, 2.9]),
    ),
    "uniform_beta_mixture": (
        lambda lib, a: lib.Uniform(a(np.linspace(-2, 0, B)), a(np.linspace(1, 3, B))),
        None, np.array([-2.0, -1.0, 0.2, 0.9, 2.0, 2.5]),
    ),
}


def _head_setup(kind, seed=3):
    make, event_dim, values = HEADS[kind]
    jprior = make(JD, lambda v: jnp.asarray(v, jnp.float32))
    tprior = make(TD, lambda v: torch.tensor(v, dtype=torch.float32))
    jparams = JP.head_init(jax.random.PRNGKey(seed), kind, H, mixture_components=K, event_dim=event_dim)
    tparams = TP.head_from_numpy(unwrap_static(jparams), "cpu")
    x = np.random.default_rng(seed).normal(size=(B, H)).astype(np.float32)
    return jprior, tprior, jparams, tparams, x, np.asarray(values, np.float32)


def _proposal_params(d):
    """The proposal's parameters: its leaves, a mixture's components' leaves
    and mixing probabilities."""
    if type(d).__name__ == "Mixture":
        return [leaf for c in d.distributions for leaf in c._leaves()] + [d.probs]
    return list(d._leaves())


@pytest.mark.parametrize("kind", sorted(HEADS))
def test_head_matches(kind):
    jprior, tprior, jparams, tparams, x, values = _head_setup(kind)
    jpp = JP.prior_param_arrays(jprior)
    static = {"meta": jparams["meta"]}

    def run(ff, xx):
        d = JP.head_apply({"ff": ff, **static}, xx, jpp)
        lp = d.log_prob(jnp.asarray(values))
        return -jnp.sum(jnp.maximum(lp, -1e38)), (lp, _proposal_params(d))

    (jloss, (jlp, jleaves)), (gff, gx) = jax.jit(jax.value_and_grad(run, argnums=(0, 1), has_aux=True))(
        jparams["ff"], jnp.asarray(x))
    for p in tensor_leaves(tparams):
        p.requires_grad_(True)
    tx = torch.from_numpy(x).requires_grad_(True)
    td = TP.head_apply(tparams, tx, TP.prior_param_arrays(tprior))
    assert td.batch_shape == (B,)
    lp = td.log_prob(torch.from_numpy(values))
    np.testing.assert_allclose(lp.detach().numpy(), np.asarray(jlp), rtol=1e-5, atol=1e-5)
    tleaves = _proposal_params(td)
    assert len(tleaves) == len(jleaves)
    for a, b in zip(tleaves, jleaves):
        np.testing.assert_allclose(a.detach().expand(np.shape(b)).numpy(), np.asarray(b), rtol=1e-5, atol=1e-6)
    loss = -torch.clamp(lp, min=-1e38).sum()
    loss.backward()
    assert float(loss.detach()) == pytest.approx(float(jloss), rel=1e-5)
    tol = dict(rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(gx), **tol)
    for tlayer, jlayer in zip(tparams["ff"]["layers"], unwrap_static(gff)["layers"]):
        np.testing.assert_allclose(tlayer["w"].grad.numpy().T, jlayer["w"], **tol)
        np.testing.assert_allclose(tlayer["b"].grad.numpy(), jlayer["b"], **tol)
    # draws of the event's shape that the proposal scores finitely
    draws = td.sample(torch.Generator().manual_seed(0))
    assert draws.shape == (B,) + tuple(tprior.event_shape)
    assert bool(torch.isfinite(td.log_prob(draws)).all())


@pytest.mark.parametrize("kind", ["mvn", "dirichlet"])
def test_zeroed_head_is_the_prior(kind):
    _, tprior, _, tparams, x, _ = _head_setup(kind)
    tparams["ff"] = map_tensors(tparams["ff"], torch.zeros_like)
    d = TP.head_apply(tparams, torch.from_numpy(x), TP.prior_param_arrays(tprior))
    if kind == "mvn":
        assert isinstance(d, TD.MultivariateNormal)
        np.testing.assert_allclose(d.loc.numpy(), tprior.loc.numpy(), rtol=1e-6)
        np.testing.assert_allclose(d.scale_tril.numpy(), tprior.scale_tril.numpy(), rtol=1e-6)
    else:
        assert isinstance(d, TD.Dirichlet)
        np.testing.assert_allclose(d.concentration.numpy(), tprior.concentration.numpy() + 1e-6, rtol=1e-6)
    # a prior shared by the batch (unbatched parameters) is read for every row
    shared = TD.MultivariateNormal(torch.ones(3), scale_tril=torch.eye(3)) if kind == "mvn" else TD.Dirichlet(torch.ones(4))
    d = TP.head_apply(tparams, torch.from_numpy(x), TP.prior_param_arrays(shared))
    assert d.batch_shape == (B,)
    if kind == "mvn":
        np.testing.assert_array_equal(d.scale_tril.numpy(), np.broadcast_to(np.eye(3), (B, 3, 3)))


# ---------------------------------------------------------------------------
# the paths
# ---------------------------------------------------------------------------

ROWS = 32
OBS_DIM = 8
# model: (JAX class, port class, observe names, observe embeddings for the
# JAX network's pre-generation on prior traces, which hold no observed value)
MODELS = {
    "mvn": (JaxMVNLatent, TorchMVNLatent, MVN_LATENT_OBSERVE, None),
    "dirichlet": (JaxDirichletLatent, TorchDirichletLatent, DIRICHLET_LATENT_OBSERVE, None),
    "lkj": (JaxLKJLatent, TorchLKJLatent, LKJ_LATENT_OBSERVE, {"y": {"dim": OBS_DIM, "reshape": [2]}}),
}


def _carried(name, network):
    jcls, tcls, observe, embeddings = MODELS[name]
    kw = dict(observe_dim=OBS_DIM, observe_names=tuple(observe), vectorized=True, observe_embeddings=embeddings)
    if network == "lstm":
        jnet = jax_network(jcls(), **kw)
        return jnet, carry(jnet, tcls())
    jnet = jax_ff_network(jcls(), **kw)
    return jnet, carry_ff(jnet, tcls())


def _arrays(tree, path=()):
    if isinstance(tree, np.ndarray):
        return {path: tree}
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_arrays(v, path + (k,)))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_arrays(v, path + (i,)))
    return out


@pytest.mark.parametrize("network", ["ff", "lstm"])
@pytest.mark.parametrize("name", sorted(MODELS))
def test_training_step_matches(name, network):
    jnet, tnet = _carried(name, network)
    assert {tnet._params["proposal"][a]["meta"]["event_dim"] for a in tnet._head_meta} == {
        3 if name == "dirichlet" else 2}
    pp.seed(3)
    outputs, sites = V.run_training_batch(MODELS[name][1](), ROWS)
    packed, addrs, dist_names = tnet._pack_arrays_from_outputs(outputs, sites, ROWS)
    for p in tensor_leaves(tnet._params):
        p.requires_grad_(True)
    loss = float(tnet._loss_and_grad(PackedBatch(packed, ROWS, addrs, dist_names)))
    _, loss_fn = jnet._make_loss_for(addrs, dist_names)
    jpacked = jax.tree_util.tree_map(lambda t: jnp.asarray(t.contiguous().numpy()), packed)
    jloss, jgrads = jax.jit(jax.value_and_grad(loss_fn))(jnet._loss_params_subset(addrs, dist_names), jpacked)
    assert math.isfinite(loss) and loss == pytest.approx(float(jloss) / ROWS, rel=1e-5)
    port = _arrays(tnet.to_numpy(map_tensors(tnet._params, lambda t: t.grad)))
    ref = {k: v / ROWS for k, v in _arrays(unwrap_static(jgrads)).items()}
    assert port.keys() == ref.keys()
    diff = math.sqrt(sum(float(np.sum((port[p].astype(np.float64) - ref[p]) ** 2)) for p in ref))
    norm = math.sqrt(sum(float(np.sum(ref[p].astype(np.float64) ** 2)) for p in ref))
    assert diff <= 1e-5 * norm, (diff, norm)


def pair_body(pp):
    """A MultivariateNormal site, then a Dirichlet one: a lockstep round
    holds trace starts and steady sites whose previous value has two
    columns."""
    z = pp.sample(pp.distributions.MultivariateNormal(np.zeros(2), covariance_matrix=np.eye(2)))
    p = pp.sample(pp.distributions.Dirichlet(np.ones(3) * 2.0))
    pp.observe(pp.distributions.Normal(z[..., 0] + z[..., 1], 0.2), name="obs")
    pp.observe(pp.distributions.Categorical(probs=p), name="cat")
    return z


class JaxPair(pyprob_tpu.Model):
    def forward(self):
        return pair_body(pyprob_tpu)


class TorchPair(pp.Model):
    def forward(self):
        return pair_body(pp)


PAIR_OBSERVE = {"obs": 4.0, "cat": 2}


@pytest.mark.parametrize("network", ["ff", "lstm"])
def test_lockstep_round_matches_the_sequential_step(network):
    kw = dict(observe_dim=OBS_DIM, observe_names=tuple(PAIR_OBSERVE), vectorized=True)
    if network == "lstm":
        tnet = carry(jax_network(JaxPair(), **kw), TorchPair())
    else:
        tnet = carry_ff(jax_ff_network(JaxPair(), **kw), TorchPair())
    model = tnet._model
    traces = model.posterior(40, observe=PAIR_OBSERVE, vectorized=False, inference_engine=IC).get_values()
    errs = chip_smoke.lockstep_round_vs_sequential(tnet, PAIR_OBSERVE, chip_smoke.round_traces(traces))
    assert len(errs["rows"]) == 64
    # a feedforward network's buckets have no previous site
    assert {start for start, _ in errs["buckets"]} == ({True, False} if network == "lstm" else {True})
    for key in ("log_q", "head", "log_p", "carry"):
        assert errs[key] <= 1e-4 * (1 + errs[key + "_ref"]), (key, errs[key])
    assert errs["untouched"] == 0.0


def test_interpreter_batch_takes_the_per_type_loss():
    jm = JaxMVNLatent()
    jnet = jax_network(jm, observe_dim=OBS_DIM, observe_names=tuple(MVN_LATENT_OBSERVE), vectorized=False)
    pyprob_tpu.seed(2)
    jtraces = JOnline(jm).next_batch(4)
    jbatch = JBatch(jtraces)
    tnet = carry(jnet, TorchMVNLatent())
    batch = Batch([port_trace(t) for t in jtraces])
    # both networks would take the gather loss for any batch, were it not
    # for the event-shaped head
    jnet._gather_used = tnet._gather_used = True
    assert jnet._try_gather_loss_and_grad(jbatch) is None
    assert gl.pack_batch(tnet, tnet._gather_registry(), batch) is None
    assert tnet._try_gather_loss(batch) is None
    ok, jloss, _ = jnet._loss_and_grad(jbatch)
    for p in tensor_leaves(tnet._params):
        p.requires_grad_(True)
    assert ok and float(tnet._loss_and_grad(batch)) == pytest.approx(jloss, rel=1e-5)


@pytest.mark.parametrize("name,network", [("mvn", "lstm"), ("dirichlet", "ff"), ("lkj", "ff")])
def test_save_load_serves_bit_equal(name, network, tmp_path):
    _, tnet = _carried(name, network)
    model, observe = tnet._model, MODELS[name][2]
    path = str(tmp_path / "net.network")
    model.save_inference_network(path)
    loaded = MODELS[name][1]()
    loaded.load_inference_network(path)
    assert loaded._inference_network._head_meta == tnet._head_meta
    posts = []
    for m in (model, loaded):
        pp.seed(9)
        posts.append(m.posterior_results(256, observe=observe, vectorized=True, inference_engine=IC))
    np.testing.assert_array_equal(posts[0]._values, posts[1]._values)
    np.testing.assert_array_equal(posts[0].log_weights, posts[1].log_weights)
    assert posts[0].effective_sample_size == posts[1].effective_sample_size


def test_cached_proposal_step_keeps_no_batch_after_a_run():
    """The network keeps its batched proposal step between runs, but not the
    last chunk's LSTM carry and previous values."""
    _, tnet = _carried("mvn", "lstm")
    tnet._model.posterior_results(64, observe=MVN_LATENT_OBSERVE, vectorized=True, inference_engine=IC)
    step = tnet._vps_cache[1]
    (h, c), prev = step.get_state()
    assert h.shape[1] == 0 and c.shape[1] == 0 and prev is None
    # and the next run serves from it as before
    post = tnet._model.posterior_results(64, observe=MVN_LATENT_OBSERVE, vectorized=True, inference_engine=IC)
    assert tnet._vps_cache[1] is step and np.isfinite(post.log_weights).all()


def multinomial_body(pp):
    x = pp.sample(pp.distributions.Multinomial(5.0, probs=np.array([0.2, 0.3, 0.5])))
    pp.observe(pp.distributions.Normal(x[..., 0], 1.0), name="obs")
    return x


class JaxMultinomialLatent(pyprob_tpu.Model):
    def forward(self):
        return multinomial_body(pyprob_tpu)


class TorchMultinomialLatent(pp.Model):
    def forward(self):
        return multinomial_body(pp)


def test_multinomial_latent_is_refused():
    match = "Distribution currently unsupported: Multinomial"
    with pytest.raises(RuntimeError, match=match):
        jax_ff_network(JaxMultinomialLatent(), observe_names=("obs",), vectorized=False)
    with pytest.raises(RuntimeError, match=match):
        TorchMultinomialLatent().learn_inference_network(
            num_traces=64, observe_embeddings={"obs": {"dim": 4}}, batch_size=32
        )


@pytest.mark.parametrize("vectorized", [True, False])
def test_dirichlet_categorical_prior_is(vectorized):
    # counts (2, 1, 0) under a flat Dirichlet: posterior Dir(3, 2, 1)
    post = TorchDirCat().posterior_results(
        20000 if vectorized else 2000, observe={"o0": 0, "o1": 0, "o2": 1}, vectorized=vectorized
    )
    np.testing.assert_allclose(np.asarray(post.mean, np.float64), [0.5, 1 / 3, 1 / 6], atol=0.06)


@pytest.mark.parametrize("vectorized", [True, False])
def test_mvn_conjugate_prior_is(vectorized):
    # N(0, I) prior, N(x, I) likelihood, y = (2, 0): posterior N((1, 0), I/2)
    post = TorchMVNConjugate().posterior_results(
        20000 if vectorized else 2000, observe={"y": np.array([2.0, 0.0])}, vectorized=vectorized
    )
    np.testing.assert_allclose(np.asarray(post.mean, np.float64), [1.0, 0.0], atol=0.12)
    np.testing.assert_allclose(np.asarray(post.variance, np.float64), [0.5, 0.5], atol=0.12)


class TorchUniformCategorical(pp.Model):
    def forward(self):
        u = pp.sample(TD.Uniform(0.0, 1.0))
        pp.observe(TD.Categorical(probs=torch.stack([u, 1 - u], -1)), name="obs")
        return u


def test_categorical_observe_is_embedded_as_float():
    """A categorical observe's draws are integer indices; the packed batch
    gives the observe embedding float rows, as the JAX package's promotion
    does (the Dirichlet latent's path met it first)."""
    model = TorchUniformCategorical()
    model.learn_inference_network(num_traces=512, observe_embeddings={"obs": {"dim": 4}}, batch_size=256)
    outputs, sites = V.run_training_batch(model, 8)
    packed, _, _ = model._inference_network._pack_arrays_from_outputs(outputs, sites, 8)
    assert packed["obs"]["obs"].dtype == torch.float32
    assert math.isfinite(model._inference_network._history_train_loss[-1])
