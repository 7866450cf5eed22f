"""Variational inference (``pyprob_tpu_torch.inference.vi``) on the CPU,
against the JAX package.

(i) The three guides (meanfield, fullrank, RealNVP flow) at parameters
carried across from the JAX package's ``init_fn`` (``make_params``) with
every leaf perturbed (``guide_params_from_numpy``), on Banana (D = 2): the
importance log-weights log p(x(z), obs) + log|dx/dz| − log q(z) of the same
ε against the JAX ``draw_fn``'s, the ELBO of the same particles against the
JAX ``fit_fn``'s first value, its gradient against ``jax.grad`` of the
JAX ELBO written out in ``jnp`` (whose value is held to ``fit_fn``'s), and
the parameters after one Adam step (``torch.optim.Adam``) against optax's,
within 1e-4 (1 + |ref|) (float32
through six coupling layers); the flow's sample → log-density round trip
within 1e-4; the parameter bridge to numpy and back to the bit.  (ii) The
JAX tests' criteria (tests/test_vi.py) at the JAX tests' counts where a run
takes a few seconds on the CPU (GUM, the two guides on the hierarchy, the
bounded and positive supports, the enumerated model), the flow on GUM at
500 steps, the program cache and the errors.  Banana's flow-over-Gaussians
criterion at its 3,000 steps runs on the card (``chip_smoke.py``'s ``vi``).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pyprob_tpu_torch as pp
from pyprob_tpu.inference import hmc as jhmc
from pyprob_tpu.inference import vi as jvi
from pyprob_tpu_torch.inference import hmc, vi
from pyprob_tpu_torch.vectorized import _TraceabilityCache

from _torch_parity import (
    OBSERVE,
    POSTERIOR_MEAN,
    POSTERIOR_STDDEV,
    TorchGUM,
    banana_body,
    body_pair,
    hierarchy_body,
    mix_pair,
    mixture_posterior,
    positive_body,
    uniform_gum_body,
)

torch.set_num_threads(2)

VI = pp.InferenceEngine.VARIATIONAL_INFERENCE
GUM_LOG_Z = -8.2395


@pytest.fixture(autouse=True)
def _port_on_cpu():
    pp.set_device("cpu")
    pp.seed(0)
    pp.set_verbosity(1)
    _TraceabilityCache._cache.clear()
    yield


def _close(mine, ref, tol=1e-5):
    mine, ref = np.asarray(mine, np.float64), np.asarray(ref, np.float64)
    assert mine.shape == ref.shape, (mine.shape, ref.shape)
    excess = np.abs(mine - ref) - tol * (1 + np.abs(ref))
    assert np.all(excess <= 0), (float(excess.max()), mine, ref)


def banana_pair():
    return body_pair(banana_body, jnp.stack, torch_args=(lambda xs: torch.stack(xs, -1),))


# ---------------------------------------------------------------------------
# (i) the guides against the JAX package's
# ---------------------------------------------------------------------------


def _jax_neg_elbo(guide, params, eps, fm, obs):
    """The JAX package's negative ELBO at the particles eps [P, D]
    (pyprob_tpu/inference/vi.py: guide_sample, guide_entropy,
    guide_sample_logq, neg_elbo), written out in jnp so that jax.grad gives
    its gradient (Adam's first step, which the JAX fit_fn gives, sees only
    the gradient's sign)."""
    dim = eps.shape[-1]
    log_2pi = float(np.log(2.0 * np.pi))
    lj = lambda z: -jax.vmap(lambda v: fm.potential(v, obs))(z)  # noqa: E731
    if guide == "meanfield":
        z = params["mu"] + jnp.exp(params["log_sigma"]) * eps
        return -(jnp.mean(lj(z)) + jnp.sum(params["log_sigma"]) + 0.5 * dim * (1.0 + log_2pi))
    if guide == "fullrank":
        rows, cols = np.tril_indices(dim, k=-1)
        L = jnp.zeros((dim, dim)).at[rows, cols].set(params["tril"]) + jnp.diag(jnp.exp(params["log_diag"]))
        z = params["mu"] + eps @ L.T
        return -(jnp.mean(lj(z)) + jnp.sum(params["log_diag"]) + 0.5 * dim * (1.0 + log_2pi))
    z = params["mu"] + jnp.exp(params["log_sigma"]) * eps
    log_q = -0.5 * jnp.sum(eps * eps, -1) - 0.5 * dim * log_2pi - jnp.sum(params["log_sigma"])
    for i, layer in enumerate(params["layers"]):
        m = jnp.asarray([(j + i) % 2 for j in range(dim)], jnp.float32)
        out = jnp.tanh((z * m) @ layer["w1"] + layer["b1"]) @ layer["w2"] + layer["b2"]
        s_, t_ = jnp.tanh(out[:, :dim]) * 2.0, out[:, dim:]
        z = m * z + (1.0 - m) * (z * jnp.exp(s_) + t_)
        log_q = log_q - jnp.sum((1.0 - m) * s_, -1)
    return -jnp.mean(lj(z) - log_q)


@pytest.mark.parametrize("guide", ["meanfield", "fullrank", "flow"])
def test_guides_match_jax(guide):
    jm, tm = banana_pair()
    observe = {"w": 0.3}
    jobs = {k: jnp.asarray(v, jnp.float32) for k, v in observe.items()}
    tobs = {k: pp.util.to_tensor(v, "cpu") for k, v in observe.items()}
    P, N = 8, 64
    fit_fn, draw_fn, init_fn, _, dim = jvi._build_vi(jm, jobs, 1.0, guide, P, False, (), None)
    tfm = hmc._functionalize(tm, tobs, 1.0, "VARIATIONAL_INFERENCE", (), None)
    family = vi.Guide(guide, dim)
    assert tfm.dim == dim == 2
    # the JAX make_params at an encoded prior draw, every leaf perturbed
    rng = np.random.default_rng(3)
    leaves, treedef = jax.tree_util.tree_flatten(jax.tree.map(np.asarray, init_fn(jax.random.PRNGKey(0), jobs)))
    leaves = [(a + 0.1 * rng.normal(size=a.shape)).astype(np.float32) for a in leaves]
    params_np = jax.tree_util.tree_unflatten(treedef, leaves)
    params = vi.guide_params_from_numpy(params_np, "cpu")
    assert [p.shape for p in vi.guide_leaves(params)] == [a.shape for a in leaves]
    back = jax.tree_util.tree_leaves(vi.guide_params_to_numpy(params))
    assert all(np.array_equal(a, b) for a, b in zip(back, leaves))
    jparams = jax.tree.map(jnp.asarray, params_np)

    # the importance weights of the same ε (draw_one: split, then normal)
    keys = jax.random.split(jax.random.PRNGKey(1), N)
    _, ref_log_w = draw_fn(jparams, keys, jobs)
    eps = np.array(jax.vmap(lambda k: jax.random.normal(jax.random.split(k)[0], (dim,)))(keys))
    with torch.no_grad():
        z, log_q = family.sample_logq(params, torch.as_tensor(eps))
        log_w = -tfm.potential(z, tobs) - log_q
        _close(log_w.numpy(), np.asarray(ref_log_w), 1e-4)
        # the density of the draws (the flow's by its inverse)
        _close(family.log_prob(params, z).numpy(), log_q.numpy(), 1e-4)
        _close(family.sample(params, torch.as_tensor(eps)).numpy(), z.numpy())

    # the ELBO and one Adam step at the particles of fit_fn's first step
    key = jax.random.PRNGKey(2)
    ref_params, ref_elbos = fit_fn(1, 0.05, jparams, key, jobs)
    eps_fit = jax.random.normal(jax.random.split(key, 1)[0], (P, dim))
    elbo, grads = vi.elbo_and_grads(family, tfm, params, torch.as_tensor(np.asarray(eps_fit)), tobs)
    _close(float(elbo), float(ref_elbos[0]), 1e-4)
    # the gradient itself, against jax.grad of the JAX ELBO written in jnp
    # (whose value is held to fit_fn's first)
    jfm = jhmc._functionalize(jm, jobs, 1.0, False, "VARIATIONAL_INFERENCE", (), None)
    ref_neg, ref_grads = jax.value_and_grad(lambda p: _jax_neg_elbo(guide, p, eps_fit, jfm, jobs))(jparams)
    _close(-float(ref_neg), float(ref_elbos[0]), 1e-5)
    for mine, ref in zip(grads, jax.tree_util.tree_leaves(ref_grads)):
        _close(mine.numpy(), np.asarray(ref), 1e-4)
    opt = torch.optim.Adam(vi.guide_leaves(params), lr=0.05, betas=(0.9, 0.999), eps=1e-8)
    for leaf, grad in zip(vi.guide_leaves(params), grads):
        leaf.grad = grad
    opt.step()
    for mine, ref in zip(vi.guide_leaves(params), jax.tree_util.tree_leaves(ref_params)):
        _close(mine.detach().numpy(), np.asarray(ref), 1e-4)
    if guide != "flow":
        # the closed-form entropy is E[-log q]
        big = torch.randn((200_000, dim), generator=torch.Generator().manual_seed(0))
        with torch.no_grad():
            est = -family.log_prob(params, family.sample(params, big)).mean()
        assert abs(float(family.entropy(params)) - float(est)) < 0.01


# ---------------------------------------------------------------------------
# (ii) the JAX tests' criteria
# ---------------------------------------------------------------------------


def _late_elbo(post):
    # the mean of the last 100 steps' ELBO estimates: the JAX tests compare
    # the last step's alone, a 32-particle estimate that lay from -0.27 to
    # +0.099 from log Z over 16 JAX seeds on GUM, three within 0.012 of the
    # +0.1 bound; the mean of the last 100 lay within 0.025 of log Z in the
    # port (tests/vi_reference.py --paths gum_elbo)
    return float(np.mean(post.metadata[-1]["elbo_history"][-100:]))


def test_vi_gum_posterior_and_evidence():
    post = TorchGUM().posterior_results(4000, observe=OBSERVE, inference_engine=VI)
    assert abs(float(post.mean) - POSTERIOR_MEAN) < 0.1
    assert abs(float(post.stddev) - POSTERIOR_STDDEV) < 0.1
    assert float(post.effective_sample_size) > 0.9 * 4000
    assert abs(post.log_evidence - GUM_LOG_Z) < 0.05
    md = post.metadata[-1]
    assert md["guide"] == "meanfield" and md["latent_dim"] == 1 and np.isfinite(md["final_elbo"])
    assert _late_elbo(post) <= post.log_evidence + 0.1
    assert len(md["elbo_history"]) == 1500 and md["elbo_history"][-1] == md["final_elbo"]


def test_vi_fullrank_beats_meanfield_on_correlation():
    _, model = body_pair(hierarchy_body)
    posts = {g: model.posterior_results(4000, observe={"y": 2.0}, inference_engine=VI, guide=g)
             for g in ("meanfield", "fullrank")}
    for post in posts.values():
        assert abs(float(post.mean) - 2.0 / 3.0) < 0.08
        assert abs(post.log_evidence - (-2.135)) < 0.1
    assert posts["fullrank"].effective_sample_size > posts["meanfield"].effective_sample_size + 0.2 * 4000
    assert _late_elbo(posts["fullrank"]) > _late_elbo(posts["meanfield"])


@pytest.mark.parametrize("support", ["bounded", "positive"])
def test_vi_supports(support):
    if support == "bounded":
        _, bounded = body_pair(uniform_gum_body)
        post = bounded.posterior_results(4000, observe=OBSERVE, inference_engine=VI)
        vals = np.asarray(post.values_numpy(), np.float64)
        assert abs(float(post.mean) - 8.5) < 0.12 and abs(float(post.stddev) - 1.0) < 0.12
        assert vals.min() > 0.0 and vals.max() < 20.0
    else:
        _, positive = body_pair(positive_body)
        post = positive.posterior_results(4000, observe={"y": 2.0}, inference_engine=VI)
        assert np.asarray(post.values_numpy()).min() > 0.0 and abs(float(post.mean) - 1.76) < 0.1


def test_vi_enumerates_discrete_sites():
    # the JAX test holds the moments against 400,000-draw prior IS, here
    # against the closed form, at its 8,000 draws and tolerance
    _, model = mix_pair()
    mean, std, _ = mixture_posterior("mix")
    post = model.posterior_results(8000, observe={"y": 1.0}, inference_engine=VI)
    assert abs(float(post.mean) - mean) < 0.15 and abs(float(post.stddev) - std) < 0.15


def test_vi_flow_guide_on_gum():
    # the flow end to end at 500 steps (lr 0.01): the reweighted moments and
    # evidence at 4,000 draws within the GUM test's limits
    post = TorchGUM().posterior_results(4000, observe=OBSERVE, inference_engine=VI, guide="flow", vi_steps=500,
                                        learning_rate=0.01)
    assert abs(float(post.mean) - POSTERIOR_MEAN) < 0.1 and abs(float(post.stddev) - POSTERIOR_STDDEV) < 0.1
    assert abs(post.log_evidence - GUM_LOG_Z) < 0.05 and post.metadata[-1]["guide"] == "flow"


def test_vi_program_cache_reused_for_new_observation():
    model = TorchGUM()
    model.posterior_results(500, observe=OBSERVE, inference_engine=VI, vi_steps=200)
    n_cached = len(vi._vi_cache)
    post = model.posterior_results(500, observe={"obs0": -3.0, "obs1": -4.0}, inference_engine=VI, vi_steps=200)
    assert len(vi._vi_cache) == n_cached
    assert abs(float(post.mean) - (-2.75)) < 0.15


class _Discrete(pp.Model):
    def forward(self):
        k = pp.sample(pp.distributions.Categorical(probs=[0.3, 0.7]))
        pp.observe(pp.distributions.Normal(1.0 * k, 1.0), name="y")
        return k


class _Untraceable(pp.Model):
    def forward(self):
        mu = pp.sample(pp.distributions.Normal(0.0, 1.0))
        if float(mu) > 0:
            mu = mu + 0.0
        pp.observe(pp.distributions.Normal(mu, 1.0), name="y")
        return mu


def test_vi_errors():
    with pytest.raises(RuntimeError, match="no continuous latent"):
        _Discrete().posterior(num_traces=100, observe={"y": 1.0}, inference_engine=VI)
    with pytest.raises(RuntimeError, match="no interpreter tier"):
        _Untraceable().posterior(num_traces=100, observe={"y": 1.0}, inference_engine=VI)
    with pytest.raises(RuntimeError, match="observe"):
        TorchGUM().posterior(num_traces=100, inference_engine=VI)
    with pytest.raises(ValueError, match="guide"):
        TorchGUM().posterior(num_traces=100, observe=OBSERVE, inference_engine=VI, guide="radial")
    assert math.isclose(vi.Guide("fullrank", 1).make_params(torch.zeros(1))["log_diag"].item(), -1.0)


@pytest.mark.cuda
def test_fit_from_its_graph_equals_eager_steps():
    """Fifty fullrank VI steps on the card, all but the first two replayed
    from one CUDA graph (``hmc.run_steps``), equal fifty eager steps of the
    same code on the same draws to the bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (the CUDA kernels have no interpret mode)")
    pp.set_device("cuda")
    try:
        _, tm = body_pair(hierarchy_body)
        obs = {"y": pp.util.to_tensor(2.0, "cuda")}
        fm = hmc._functionalize(tm, obs, 1.0, "VARIATIONAL_INFERENCE", (), None, pp.util.generator("cuda"))
        family = vi.Guide("fullrank", fm.dim)
        start = torch.tensor([0.3, -0.2], device="cuda")
        got, history, graphed = vi.fit(family, fm, family.make_params(start), obs, 50, 0.05,
                                       torch.Generator("cuda").manual_seed(1), 16)
        assert graphed
        params = family.make_params(start)
        leaves = vi.guide_leaves(params)
        opt = torch.optim.Adam(leaves, lr=0.05, betas=(0.9, 0.999), eps=1e-8, capturable=True)
        gen, elbos = torch.Generator("cuda").manual_seed(1), []
        for _ in range(50):
            eps = torch.randn((16, fm.dim), generator=gen, device="cuda")
            elbo, grads = vi.elbo_and_grads(family, fm, params, eps, obs,
                                            lambda v: fm._eager_value_and_grad(v, obs, True))
            for leaf, grad in zip(leaves, grads):
                leaf.grad = grad
            opt.step()
            elbos.append(elbo)
        assert torch.equal(history, torch.stack(elbos))
        assert all(torch.equal(a, b) for a, b in zip(vi.guide_leaves(got), leaves))
    finally:
        pp.set_device("cpu")
