"""The port's MCMC engines (LMH and RMH) on the CPU: the interpreter chain
(``Model._mcmc_posterior``) and the batched parallel chains
(``pyprob_tpu_torch.inference.mcmc``), against the JAX package.

(i) Deterministic parity: the RMH transition log-ratio at Normal and
Uniform sites for given (old, new) values, and the acceptance log-ratio of
one batched step for given chain states, perturbed sites and proposals,
each against the same expression on the JAX package's distributions within
1e-6 (1 + |ref|).  (ii) ``ChainState``: save, load and resume, equal to
the bit.  (iii) Statistical parity (the RNG streams differ): the JAX
tests' criteria and counts for LMH and RMH on GUM, Marsaglia, HMM and
Branching on both tiers (tests/test_inference.py:135-157, :242-265,
:398-425, :502-525), tests/test_model.py:86-141, tests/test_vectorized.py:
80-103 and :165-305, tests/test_rejection.py:70-125 and :361-373, with
analytic or grid references where the JAX tests ran a large IS.  (iv) On
a card (``cuda`` marker, skipped here): a GP chain step on the card
against the CPU, and GaussianMixture's observe through kernel 1 at C x 40
rows against its plain version.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pyprob_tpu
import pyprob_tpu_torch as pp
from pyprob_tpu.inference import mcmc as jmcmc
from pyprob_tpu_torch import vectorized
from pyprob_tpu_torch.distributions import Empirical, Normal, Uniform
from pyprob_tpu_torch.inference import mcmc
from pyprob_tpu_torch.models import (
    Branching,
    BranchingCompiled,
    GaussianMixture,
    GaussianProcessRegression,
    GaussianUnknownMean,
    GaussianUnknownMeanMarsaglia,
    GaussianUnknownMeanMarsagliaRejection,
    HiddenMarkovModel,
)
from pyprob_tpu_torch.vectorized import _TraceabilityCache

from _torch_parity import HMM_INIT, HMM_MEANS, HMM_OBSERVE, HMM_T, OBSERVE, POSTERIOR_MEAN, POSTERIOR_STDDEV

torch.set_num_threads(2)

LMH = pp.InferenceEngine.LIGHTWEIGHT_METROPOLIS_HASTINGS
RMH = pp.InferenceEngine.RANDOM_WALK_METROPOLIS_HASTINGS
ENGINES = pytest.mark.parametrize("engine", [LMH, RMH], ids=["lmh", "rmh"])
# vectorized=False: the interpreter chain; None: the batched chains
TIERS = pytest.mark.parametrize("vectorized", [False, None], ids=["interpreter", "batched"])
MCMC_SAMPLES = 7000  # tests/test_inference.py:33
# tests/test_inference.py:346-364 (forward-backward marginals)
HMM_POSTERIOR_CORRECT = np.array([
    [0.3775, 0.3092, 0.3133], [0.0416, 0.4045, 0.5539], [0.0541, 0.2552, 0.6907],
    [0.0455, 0.2301, 0.7244], [0.1062, 0.1217, 0.7721], [0.0714, 0.1732, 0.7554],
    [0.9300, 0.0001, 0.0699], [0.4577, 0.0452, 0.4971], [0.0926, 0.2169, 0.6905],
    [0.1014, 0.1359, 0.7626], [0.0985, 0.1575, 0.7440], [0.1781, 0.2198, 0.6022],
    [0.0000, 0.9848, 0.0152], [0.1130, 0.1674, 0.7195], [0.0557, 0.1848, 0.7595],
    [0.2017, 0.0472, 0.7511], [0.2545, 0.0611, 0.6844],
])


@pytest.fixture(autouse=True)
def _port_on_cpu():
    pp.set_device("cpu")
    pp.seed(0)
    pp.set_verbosity(1)
    _TraceabilityCache._cache.clear()
    yield


def _check_gum(post, burn_in=0):
    """tests/test_inference.py:67-81 without the ESS floor."""
    if burn_in:
        post = post[burn_in:]
    mean, stddev = float(post.mean), float(post.stddev)
    kl = float(pyprob_tpu.distributions.Distribution.kl_divergence(
        pyprob_tpu.distributions.Normal(mean, max(stddev, 1e-3)),
        pyprob_tpu.distributions.Normal(7.25, math.sqrt(1 / 1.2)),
    ))
    assert abs(mean - 7.25) < 0.75
    assert abs(stddev - math.sqrt(1 / 1.2)) < 0.75
    assert kl < 0.25


def _check_hmm(post):
    """tests/test_inference.py:392-410: L2 < 3 and KL < 1 against the
    forward-backward marginals."""
    posterior_mean = np.asarray(post.mean)
    l2 = float(np.sum(np.sqrt(np.sum((posterior_mean - HMM_POSTERIOR_CORRECT) ** 2, axis=1))))
    kl = 0.0
    for p, q in zip(posterior_mean, HMM_POSTERIOR_CORRECT):
        p, q = np.clip(p, 1e-6, None), np.clip(q, 1e-6, None)
        p, q = p / p.sum(), q / q.sum()
        kl += float(np.sum(p * np.log(p / q)))
    assert l2 < 3, l2
    assert kl < 1, kl


def _branching_kl(post, true_post):
    """tests/test_inference.py:474-488."""

    def probs(emp):
        p = np.zeros(41)
        for v, w in zip(np.asarray(emp.values_numpy()).reshape(-1), emp.weights):
            if 0 <= int(v) <= 40:
                p[int(v)] += w
        p = p + 1e-9
        return p / p.sum()

    p, q = probs(post), probs(true_post)
    return float(np.sum(np.where(p > 1e-8, p * np.log(p / q), 0.0)))


# ---------------------------------------------------------------------------
# (i) deterministic parity
# ---------------------------------------------------------------------------

def _jax_rmh_log_ratio(jdist, old, old_lp, new, new_lp):
    a = jmcmc._RMH_ALPHA
    rev = jmcmc._rmh_kernel(jdist, jnp.asarray(new)).log_prob(jnp.asarray(old))
    fwd = jmcmc._rmh_kernel(jdist, jnp.asarray(old)).log_prob(jnp.asarray(new))
    log_q_rev = jnp.logaddexp(jnp.log(a) + rev, jnp.log(1 - a) + old_lp)
    log_q_fwd = jnp.logaddexp(jnp.log(a) + fwd, jnp.log(1 - a) + new_lp)
    return np.asarray(log_q_rev + new_lp - log_q_fwd - old_lp, np.float64)


def _close(mine, ref):
    mine, ref = np.asarray(mine, np.float64), np.asarray(ref, np.float64)
    with np.errstate(invalid="ignore"):  # inf - inf
        same = (mine == ref) | (np.abs(mine - ref) <= 1e-6 * (1 + np.abs(ref)))  # equal infinities too
    assert np.all(same), (mine, ref)


@pytest.mark.parametrize("site", ["normal", "uniform"])
def test_rmh_transition_log_ratio_matches_jax(site):
    rng = np.random.default_rng(1)
    if site == "normal":
        params = (1.0, math.sqrt(5.0))
        old = rng.normal(1.0, 3.0, 64).astype(np.float32)
        new = rng.normal(1.0, 3.0, 64).astype(np.float32)
        mine_d, ref_d = Normal(*params), pyprob_tpu.distributions.Normal(*params)
    else:
        params = (-1.0, 1.0)
        # the truncated kernel near both ends, and across the interval
        old = np.concatenate([rng.uniform(-1, 1, 60), [-0.999, 0.999, -1.0, 1.0]]).astype(np.float32)
        new = np.concatenate([rng.uniform(-1, 1, 60), [0.998, -0.9995, 0.0, -1.0]]).astype(np.float32)
        mine_d, ref_d = Uniform(*params), pyprob_tpu.distributions.Uniform(*params)
    old_lp = np.asarray(ref_d.log_prob(jnp.asarray(old)), np.float32)
    new_lp = np.asarray(ref_d.log_prob(jnp.asarray(new)), np.float32)
    ref = _jax_rmh_log_ratio(ref_d, old, old_lp, new, new_lp)
    # the batched tier's [C] form, the interpreter's 0-d tensor form and
    # its float64 host form
    batched = mcmc.rmh_log_ratio(
        mine_d, *(torch.from_numpy(a.copy()) for a in (old, old_lp, new, new_lp)), lambda lp: lp,
    )
    _close(batched.numpy(), ref)
    for o, ol, n, nl, r in zip(old[:16], old_lp[:16], new[:16], new_lp[:16], ref[:16]):
        _close(float(mcmc.rmh_log_ratio(mine_d, torch.tensor(o), float(ol), torch.tensor(n), float(nl), torch.sum)), r)
        _close(mcmc.rmh_log_ratio_scalar(mine_d, torch.tensor(o), float(ol), torch.tensor(n), float(nl)), r)


class _Chain(pp.Model):
    """a ~ N(0, 1), b ~ N(a, 0.5), u ~ Uniform(-2 + a, 2 + a), y ~ N(a + b + u,
    1): b's and u's parameters depend on a, so a move on a rescores them."""

    def forward(self):
        a = pp.sample(Normal(0.0, 1.0), address="a")
        b = pp.sample(Normal(a, 0.5), address="b")
        u = pp.sample(Uniform(a - 2.0, a + 2.0), address="u")
        pp.observe(Normal(a + b + u, 1.0), name="y")
        return a


def _jax_chain_log_alpha(engine, cur, j, proposal, y):
    """The acceptance log-ratio of one step, from the JAX package's
    distributions: Σ_{k ≠ j}(lp'_k − lp_k) + t_j + obs' − obs."""
    N, U = pyprob_tpu.distributions.Normal, pyprob_tpu.distributions.Uniform

    def sites(v):
        a, b, u = v
        return [N(0.0, 1.0), N(a, 0.5), U(a - 2.0, a + 2.0)], N(a + b + u, 1.0)

    new = list(cur)
    new[j] = proposal
    dists_cur, lik_cur = sites(cur)
    dists_new, lik_new = sites(new)
    lp_cur = [float(d.log_prob(jnp.float32(v))) for d, v in zip(dists_cur, cur)]
    lp_new = [float(d.log_prob(jnp.float32(v))) for d, v in zip(dists_new, new)]
    log_alpha = sum(lp_new[k] - lp_cur[k] for k in range(3) if k != j)
    log_alpha += float(lik_new.log_prob(jnp.float32(y))) - float(lik_cur.log_prob(jnp.float32(y)))
    if engine == RMH:
        # the sites before j are unchanged: site j's distribution is the same
        # in both states
        log_alpha += float(_jax_rmh_log_ratio(dists_new[j], cur[j], lp_cur[j], proposal, lp_new[j]))
    return log_alpha


@ENGINES
def test_batched_step_log_alpha_matches_jax(engine, monkeypatch):
    rng = np.random.default_rng(2)
    C = 48
    a = rng.normal(0, 1, C).astype(np.float32)
    b = (a + rng.normal(0, 0.5, C)).astype(np.float32)
    u = (a + rng.uniform(-1.9, 1.9, C)).astype(np.float32)
    j = np.arange(C) % 3
    proposal = np.where(j == 2, a + rng.uniform(-1.9, 1.9, C), rng.normal(0, 1.2, C)).astype(np.float32)
    y = 1.5
    model = _Chain()
    values = {s: torch.from_numpy(v) for s, v in zip("abu", (a, b, u))}
    full = {"a": "a__Normal__1", "b": "b__Normal__1", "u": "u__Uniform__1"}
    # the state's log-probs, as the chains hold them
    lps = {
        "a": Normal(0.0, 1.0).log_prob(values["a"]),
        "b": Normal(values["a"], 0.5).log_prob(values["b"]),
        "u": Uniform(values["a"] - 2.0, values["a"] + 2.0).log_prob(values["u"]),
    }
    out, _ = vectorized.run_traced(model, C, {"y": y}, pp.TraceMode.POSTERIOR, pp.InferenceEngine.IMPORTANCE_SAMPLING)
    assert set(full.values()) < set(out["values"])
    obs_lp = Normal(values["a"] + values["b"] + values["u"], 1.0).log_prob(torch.tensor(y))
    given = torch.from_numpy(proposal)
    monkeypatch.setattr(mcmc, "_draw", lambda distribution, n, generator: given)
    handler, _ = mcmc._replay_pass(
        model, engine, {"y": torch.tensor(y)},
        ({full[s]: values[s] for s in "abu"}, {full[s]: lps[s] for s in "abu"}),
        torch.from_numpy(j).long(), pp.util.generator("cpu"), (), {},
    )
    log_alpha = (handler.reused_log_prob_diff + handler.transition_term + handler.log_prob_observed - obs_lp).numpy()
    ref = np.array([
        _jax_chain_log_alpha(engine, (a[c], b[c], u[c]), int(j[c]), proposal[c], y) for c in range(C)
    ])
    _close(log_alpha, ref)


# ---------------------------------------------------------------------------
# (ii) ChainState
# ---------------------------------------------------------------------------

def test_chain_state_save_load_resume_bit_equal(tmp_path):
    m = GaussianUnknownMean()
    post = m.posterior_results(4096, observe=OBSERVE, inference_engine=RMH, num_chains=16)
    st = post.final_chain_state
    assert isinstance(st, pp.ChainState) and st.num_chains == 16
    fn = str(tmp_path / "chains")
    st.save(fn)
    back = pp.ChainState.load(fn)
    assert back.inference_engine == RMH and back.observe_fingerprint == st.observe_fingerprint
    for a in st.values:
        assert np.array_equal(back.values[a], st.values[a]) and np.array_equal(back.log_probs[a], st.log_probs[a])
    assert np.array_equal(back.log_prob_observed, st.log_prob_observed) and np.array_equal(back.result, st.result)
    runs = []
    for s in (st, back):
        pp.seed(7)
        runs.append(m.posterior_results(1024, observe=OBSERVE, inference_engine=RMH, initial_trace=s))
    assert np.array_equal(runs[0].values_numpy(), runs[1].values_numpy())
    assert runs[0].metadata[-1]["burn_in"] == 0 and runs[0].metadata[-1]["resumed"]
    # anything but a ChainState's plain data is refused
    with open(fn, "wb") as f:
        import pickle

        pickle.dump(Empirical(values=[1.0]), f)
    with pytest.raises(TypeError):
        pp.ChainState.load(fn)


# ---------------------------------------------------------------------------
# (iii) statistical parity
# ---------------------------------------------------------------------------

@TIERS
@ENGINES
def test_gum(engine, vectorized):
    # tests/test_inference.py:135-157
    post = GaussianUnknownMean().posterior_results(
        MCMC_SAMPLES, inference_engine=engine, observe=OBSERVE, vectorized=vectorized
    )
    assert ("compiled" in post.name) == (vectorized is None)
    _check_gum(post, burn_in=1500 if engine == LMH else 1000)


@TIERS
@ENGINES
def test_marsaglia(engine, vectorized):
    # tests/test_inference.py:242-265: the while loop on the interpreter,
    # its rejection_sample form on the batched tier (block-atomic moves)
    model = GaussianUnknownMeanMarsaglia() if vectorized is False else GaussianUnknownMeanMarsagliaRejection()
    post = model.posterior_results(MCMC_SAMPLES, inference_engine=engine, observe=OBSERVE, vectorized=vectorized)
    _check_gum(post, burn_in=1000)


@TIERS
@ENGINES
def test_hmm(engine, vectorized):
    # tests/test_inference.py:398-425
    post = HiddenMarkovModel(HMM_INIT, HMM_T, HMM_MEANS).posterior_results(
        MCMC_SAMPLES, observe=HMM_OBSERVE, inference_engine=engine, vectorized=vectorized
    )[700:]
    _check_hmm(post)


@TIERS
@ENGINES
def test_branching(engine, vectorized):
    # tests/test_inference.py:502-525: Branching branches on float(r), so
    # the batched chains run BranchingCompiled, whose posterior over r is
    # Branching's
    model = Branching() if vectorized is False else BranchingCompiled()
    post = model.posterior_results(MCMC_SAMPLES, inference_engine=engine, observe={"obs": 6}, vectorized=vectorized)
    assert _branching_kl(post, Branching().true_posterior()) < 0.75


def test_untraceable_model_falls_back_to_the_interpreter_chain():
    m = Branching()
    post = m.posterior_results(200, inference_engine=LMH, observe={"obs": 6})
    assert "compiled" not in post.name and _TraceabilityCache._cache[Branching] is False
    with pytest.raises(NotImplementedError, match="branches on sampled values"):
        m.posterior_results(200, inference_engine=LMH, observe={"obs": 6}, vectorized=True)


@TIERS
@ENGINES
def test_posterior_gum_3000(engine, vectorized):
    # tests/test_model.py:86-106
    post = GaussianUnknownMean().posterior_results(
        num_traces=3000, inference_engine=engine, observe=OBSERVE, vectorized=vectorized
    )[500:]
    assert abs(float(post.mean) - 7.25) < 0.75
    assert abs(float(post.stddev) - math.sqrt(1 / 1.2)) < 0.75


def test_interpreter_stop_resume_and_thinning():
    # tests/test_model.py:108-134
    m = GaussianUnknownMean()
    post1 = m.posterior(num_traces=1000, inference_engine=RMH, observe=OBSERVE, vectorized=False)
    post2 = m.posterior(
        num_traces=1000, inference_engine=RMH, observe=OBSERVE, initial_trace=post1[-1], vectorized=False
    )
    combined = Empirical(concat_empiricals=[post1, post2])
    vals = [float(t.result) for t in combined.get_values()[500:]]
    assert abs(float(np.mean(vals)) - 7.25) < 0.8
    thinned = m.posterior(num_traces=1000, inference_engine=LMH, observe=OBSERVE, thinning_steps=10, vectorized=False)
    assert thinned.length == 100
    meta = thinned.metadata[-1]
    assert meta["thinning_steps"] == 10 and 0 < meta["num_traces_accepted"] <= 1000


@TIERS
def test_marsaglia_rmh_3000(vectorized):
    # tests/test_model.py:137-145
    model = GaussianUnknownMeanMarsaglia() if vectorized is False else GaussianUnknownMeanMarsagliaRejection()
    post = model.posterior_results(
        num_traces=3000, inference_engine=RMH, observe=OBSERVE, vectorized=vectorized
    )[500:]
    assert abs(float(post.mean) - 7.25) < 0.8


@ENGINES
def test_batched_gum_50000(engine):
    # tests/test_vectorized.py:80-101
    post = GaussianUnknownMean().posterior_results(50000, observe=OBSERVE, vectorized=True, inference_engine=engine)
    tol = 0.75 if engine == LMH else 0.3
    assert abs(float(post.mean) - POSTERIOR_MEAN) < tol
    assert abs(float(post.stddev) - POSTERIOR_STDDEV) < tol


def test_batched_per_chain_resume(tmp_path):
    # tests/test_vectorized.py:165-217
    m = GaussianUnknownMean()
    post1 = m.posterior_results(num_traces=20000, observe=OBSERVE, vectorized=True, inference_engine=RMH)
    st = post1.final_chain_state
    assert isinstance(st, pp.ChainState) and st.num_chains >= 1
    fn = str(tmp_path / "chains.pkl")
    st.save(fn)
    st2 = pp.ChainState.load(fn)
    assert st2.num_chains == st.num_chains
    post2 = m.posterior_results(num_traces=20000, observe=OBSERVE, vectorized=True, initial_trace=st2,
                                inference_engine=RMH)
    assert abs(float(post2.mean) - POSTERIOR_MEAN) < 0.3
    assert abs(float(post2.stddev) - POSTERIOR_STDDEV) < 0.3
    assert post2.final_chain_state.num_chains == st.num_chains
    # each chain continues from its own state: the first step's candidates
    # start where the saved chains stood
    assert post2.metadata[-1]["burn_in"] == 0
    # a changed observation: one rescore pass re-anchors the chains
    obs_new = {"obs0": 0.0, "obs1": 1.0}
    true_mean_new = (1.0 / 5.0 + (0.0 + 1.0) / 2.0) / (1.0 / 5.0 + 2.0 / 2.0)
    post3 = m.posterior_results(num_traces=20000, observe=obs_new, vectorized=True, initial_trace=st2,
                                inference_engine=RMH)
    assert abs(float(post3.mean) - true_mean_new) < 0.4
    assert post3.metadata[-1]["burn_in"] > 0


def test_batched_resume_keeps_each_chains_state():
    # one LMH step from a resumed state (GUM accepts about 1 % of them):
    # nearly every chain's first kept value is its own saved value
    m = GaussianUnknownMean()
    st = m.posterior_results(8192, observe=OBSERVE, inference_engine=LMH, num_chains=64).final_chain_state
    assert len(np.unique(st.result)) > 8
    chains = m.posterior_results(64, observe=OBSERVE, inference_engine=LMH, initial_trace=st, return_chains=True)
    same = [float(chain.values_numpy()[0]) == float(st.result[c]) for c, chain in enumerate(chains)]
    assert np.mean(same) > 0.8


def test_chain_state_mismatch_and_interpreter_refusal():
    # tests/test_vectorized.py:220-275
    class Other(pp.Model):
        def forward(self):
            a = pp.sample(Normal(0.0, 1.0), address="completely_different")
            pp.observe(Normal(a, 1.0), name="obs0")
            return a

    st = GaussianUnknownMean().posterior_results(
        num_traces=4000, observe=OBSERVE, vectorized=True, inference_engine=LMH
    ).final_chain_state
    with pytest.raises(ValueError):
        Other().posterior_results(num_traces=4000, observe={"obs0": 1.0}, vectorized=True, initial_trace=st,
                                  inference_engine=LMH)
    with pytest.raises((ValueError, TypeError)):
        GaussianUnknownMeanMarsaglia().posterior_results(
            num_traces=100, observe=OBSERVE, vectorized=None, initial_trace=st, inference_engine=LMH
        )
    with pytest.raises(TypeError):
        GaussianUnknownMean().posterior_results(
            num_traces=100, observe=OBSERVE, vectorized=False, initial_trace=st, inference_engine=LMH
        )


def test_chain_knobs_route_through_posterior():
    # tests/test_vectorized.py:278-305
    m = GaussianUnknownMean()
    p = m.posterior_results(num_traces=8000, observe=OBSERVE, vectorized=True, inference_engine=RMH,
                            num_chains=32, burn_in=16)
    assert p.final_chain_state.num_chains == 32 and p.metadata[-1]["burn_in"] == 16
    assert p.length == 32 * 250
    chains = m.posterior_results(num_traces=4000, observe=OBSERVE, vectorized=True, inference_engine=RMH,
                                 num_chains=8, return_chains=True)
    assert len(chains) == 8 and all(c.final_chain_state is chains[0].final_chain_state for c in chains)
    thinned = m.posterior_results(num_traces=4000, observe=OBSERVE, vectorized=True, inference_engine=RMH,
                                  num_chains=8, thinning_steps=10)
    assert thinned.length == 8 * 50
    with pytest.warns(UserWarning, match="batched MCMC tier"):
        m.posterior_results(num_traces=50, observe=OBSERVE, vectorized=False, inference_engine=RMH, num_chains=4)
    with pytest.raises(NotImplementedError, match="distributed slice"):
        m.posterior_results(num_traces=50, observe=OBSERVE, inference_engine=RMH, mesh=object())


def test_batched_trace_valued_posterior():
    # posterior() on the batched chains gives traces of the kept states,
    # built by one replay pass: their values are the kept results
    m = GaussianUnknownMean()
    pp.seed(3)
    traces = m.posterior(2048, observe=OBSERVE, inference_engine=RMH, num_chains=8)
    pp.seed(3)
    results = m.posterior_results(2048, observe=OBSERVE, inference_engine=RMH, num_chains=8)
    assert traces.length == results.length
    t = traces[5]
    assert t.length_controlled == 1 and len(t.variables_observed) == 2
    assert np.isfinite(float(t.log_prob_observed))
    got = np.array([float(traces[i].result) for i in range(0, traces.length, 97)])
    assert np.array_equal(got, results.values_numpy()[:: 97].astype(np.float64).reshape(-1))


def test_file_backed_results(tmp_path):
    # both tiers' results into an Empirical file, reopened equal to the
    # memory result from the same seed
    m = GaussianUnknownMean()
    for label, kwargs in (("batched", {"num_chains": 8}), ("interpreter", {"vectorized": False})):
        fn = str(tmp_path / label)
        runs = []
        for file_name in (None, fn):
            pp.seed(5)
            runs.append(m.posterior_results(1024, inference_engine=RMH, observe=OBSERVE, file_name=file_name,
                                            **kwargs))
        runs[1].close()
        back = Empirical(file_name=fn, file_read_only=True)
        assert back.length == runs[0].length == 1024
        assert np.array_equal(back.values_numpy(), runs[0].values_numpy())
        back.close()


@pytest.fixture(scope="module")
def marsaglia_rejection():
    return GaussianUnknownMeanMarsagliaRejection()


@ENGINES
def test_rejection_block_chains(engine, marsaglia_rejection):
    # tests/test_rejection.py:70-85: block-atomic moves on the batched tier
    post = marsaglia_rejection.posterior_results(num_traces=20000, observe=OBSERVE, inference_engine=engine,
                                                 vectorized=True)
    assert "compiled" in post.name
    assert abs(float(post.mean) - POSTERIOR_MEAN) < 0.3
    assert abs(float(post.stddev) - POSTERIOR_STDDEV) < 0.25


def test_rejection_block_interpreter_converges(marsaglia_rejection):
    # tests/test_rejection.py:88-95
    post = marsaglia_rejection.posterior_results(num_traces=3000, observe=OBSERVE, inference_engine=LMH,
                                                 vectorized=False)[1000:]
    assert abs(float(post.mean) - POSTERIOR_MEAN) < 0.5


class _OuterLatentBlock(pp.Model):
    """tests/test_rejection.py:98-111: an outer latent and a block; a move on
    mu replays the stored block value and rechecks the predicate."""

    def forward(self):
        mu = pp.sample(Normal(0.0, 2.0))

        def attempt():
            e = pp.sample(Normal(0.0, 1.0))
            return e, e * e < 4.0

        e = pp.rejection_sample(attempt)
        pp.observe(Normal(mu + e, 0.5), name="obs0")
        return mu


def _outer_block_truth(obs=3.0):
    """mu's posterior mean and stddev by grid integration over (mu, e)."""
    mu = np.linspace(-8, 12, 2001)[:, None]
    e = np.linspace(-2, 2, 801)[None, :]
    log_p = -0.5 * (mu / 2.0) ** 2 - 0.5 * e**2 - 0.5 * ((obs - mu - e) / 0.5) ** 2
    p = np.exp(log_p - log_p.max()).sum(axis=1)
    p /= p.sum()
    m = float((p * mu[:, 0]).sum())
    return m, float(np.sqrt((p * (mu[:, 0] - m) ** 2).sum()))


def test_outer_latent_with_block():
    # tests/test_rejection.py:114-125, the 200,000-trace IS reference by grid
    truth_mean, truth_std = _outer_block_truth()
    lmh = _OuterLatentBlock().posterior_results(num_traces=30000, observe={"obs0": 3.0}, inference_engine=LMH,
                                                vectorized=True)
    assert "compiled" in lmh.name
    assert abs(float(lmh.mean) - truth_mean) < 0.2
    assert abs(float(lmh.stddev) - truth_std) < 0.2


class _DependentBlock(pp.Model):
    """tests/test_rejection.py:344-356: p(b | a) changes when a move redraws
    a, so the ratio rescores b."""

    def forward(self):
        def attempt():
            a = pp.sample(Normal(0.0, 1.0))
            b = pp.sample(Normal(a, 0.5))
            return (a, b), a * a < 100.0

        a, b = pp.rejection_sample(attempt)
        pp.observe(Normal(b, 0.5), name="obs0")
        return a


def test_dependent_block_sites_rescored():
    # tests/test_rejection.py:359-373; the 300,000-trace IS reference is
    # analytic: y | a ~ N(a, sqrt(0.5)), so a | y=2 ~ N(4/3, sqrt(1/3))
    lmh = _DependentBlock().posterior_results(num_traces=30000, observe={"obs0": 2.0}, vectorized=True,
                                              inference_engine=LMH)
    assert abs(float(lmh.mean) - 4.0 / 3.0) < 0.15
    assert abs(float(lmh.stddev) - math.sqrt(1.0 / 3.0)) < 0.15


def test_interpreter_block_with_stored_values_that_fail_is_rejected():
    # a move on mu that leaves the replayed block values failing their
    # predicate can only be rejected: the transition term is -inf
    m = _OuterLatentBlock()
    post = m.posterior(500, observe={"obs0": 3.0}, inference_engine=LMH, vectorized=False)
    assert post.length == 500 and post.metadata[-1]["num_traces_accepted"] > 0
    for t in post.get_values():
        mu, e = t.variables_controlled
        assert float(e.value) ** 2 < 4.0


# ---------------------------------------------------------------------------
# (iv) on a card
# ---------------------------------------------------------------------------

def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _gp_log_likelihood(device, C=64, N=256):
    """log p(y | ℓ') of one GP chain step whose chains all perturb the
    log-lengthscale to given proposals."""
    pp.set_device(device)
    model = GaussianProcessRegression(np.linspace(0, 4, N), learn=("lengthscale",), noise=0.2)
    y = model.synthesize(rng=3, lengthscale=1.0)
    rng = np.random.default_rng(4)
    cur = torch.tensor(rng.normal(0, 1, C), dtype=torch.float32, device=device)
    prop = torch.tensor(rng.normal(0, 1, C), dtype=torch.float32, device=device)
    mcmc_draw = mcmc._draw
    mcmc._draw = lambda distribution, n, generator: prop
    out, _ = vectorized.run_traced(model, C, {"y": y}, pp.TraceMode.POSTERIOR, pp.InferenceEngine.IMPORTANCE_SAMPLING)
    (addr,) = [a for a in out["values"] if "log_lengthscale" in a]
    lp = Normal(0.0, 1.0).log_prob(cur)
    try:
        handler, _ = mcmc._replay_pass(
            model, LMH, {"y": torch.as_tensor(y, dtype=torch.float32, device=device)}, ({addr: cur}, {addr: lp}),
            torch.zeros(C, dtype=torch.long, device=device), pp.util.generator(device), (), {},
        )
    finally:
        mcmc._draw = mcmc_draw
    return handler.log_prob_observed.double().cpu().numpy()


@pytest.mark.cuda
def test_gp_chain_step_card_vs_cpu():
    _need_card()
    got = {device: _gp_log_likelihood(device) for device in ("cuda", "cpu")}
    assert np.all(np.isfinite(got["cuda"]))
    # chip_smoke.py's GP_LOGLIK_ATOL (gp_card_vs_cpu)
    assert np.abs(got["cuda"] - got["cpu"]).max() <= 0.05


@pytest.mark.cuda
def test_gaussian_mixture_observe_kernel_at_chain_rows():
    _need_card()
    from pyprob_tpu_torch.ops import kernels as K

    pp.set_device("cuda")
    C, D = 1024, 40
    model = GaussianMixture(num_components=2, num_data=D)
    y = model.synthesize([-2.0, 2.0], rng=0)
    before = K.mixture_normal_log_prob.launches
    post = model.posterior_results(C * 4, observe={"y": y}, inference_engine=RMH, num_chains=C, burn_in=0)
    steps = post.metadata[-1]["num_steps"]
    assert K.mixture_normal_log_prob.launches - before >= steps
    g = torch.Generator(device="cuda").manual_seed(0)
    mus = 3.0 * torch.randn((C, 2), generator=g, device="cuda")
    rows = C * D
    inputs = [
        torch.as_tensor(y, dtype=torch.float32, device="cuda").repeat(C).contiguous(),
        mus.unsqueeze(1).expand(C, D, 2).reshape(rows, 2).contiguous(),
        torch.full((rows, 2), 0.6, device="cuda"),
        torch.full((rows, 2), -math.log(2.0), device="cuda"),
    ]
    out, ref = K.mixture_normal_log_prob(*inputs), K.mixture_normal_log_prob_plain(*inputs)
    assert torch.all((out - ref).abs() <= 1e-5 * (1 + ref.abs()))
