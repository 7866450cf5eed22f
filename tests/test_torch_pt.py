"""Parallel tempering (``pyprob_tpu_torch.inference.pt``) and the tempered
potential of the gradient engines' base on the CPU, against the JAX package.

(i) ``_FunctionalModel.potential_parts`` (per discrete combination, the log
prior with the Jacobian and the log likelihood) and ``value_and_grad_beta``
(the tempered potential -logsumexp_G(lp + β·ll) and its gradient, each row
at its own β) at fixed z from a numpy seed, against JAX
``fm.potential_parts`` and ``jax.value_and_grad`` of the same expression,
for GUM, a Categorical-enumerated model, DepMix (a continuous site whose
prior depends on the enumerated latent; tests/test_pt.py:187-215) and
GaussianMixture (its observe on kernel 1's plain version here): within
1e-5 (1 + |ref|), as PR 20's gradient tests.  (ii) ``pt_transition`` given
its momenta and its two uniform vectors against a float64 numpy
transcription of the JAX package's ensemble transition
(pyprob_tpu/inference/pt.py:167-265) on models whose parts and gradients
are written out in numpy: the same accept and swap decisions, positions
within 1e-4 (1 + |ref|) after 10 leapfrogs in float32.  (iii) The JAX
tests' criteria (tests/test_pt.py, tests/test_gradient_resume.py:122-140)
at reduced counts, each stating its count, and the errors.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pyprob_tpu_torch as pp
from pyprob_tpu.inference import hmc as jhmc
from pyprob_tpu_torch.inference import hmc, pt
from pyprob_tpu_torch.vectorized import _TraceabilityCache

from _torch_parity import (
    OBSERVE,
    POSTERIOR_MEAN,
    POSTERIOR_STDDEV,
    JaxGUM,
    TorchGUM,
    bimodal_body,
    body_pair,
    depmix_pair,
    hierarchy_body,
    mix_pair,
    mixture_posterior,
)

torch.set_num_threads(2)

PT = pp.InferenceEngine.PARALLEL_TEMPERING
HMC = pp.InferenceEngine.HAMILTONIAN_MONTE_CARLO


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


def _models():
    from pyprob_tpu.models import GaussianMixture as JGM
    from pyprob_tpu_torch.models import GaussianMixture as TGM

    gmm = {"num_components": 2, "obs_stddev": 0.6, "num_data": 40}
    y = JGM(**gmm).synthesize([-2.0, 2.0], rng=0)
    return {
        "gum": ((JaxGUM(), TorchGUM()), OBSERVE),
        "mix": (mix_pair(), {"y": 1.0}),
        "depmix": (depmix_pair(), {"y": 1.0}),
        "gmm": ((JGM(**gmm), TGM(**gmm)), {"y": y}),
    }


def _functional_pair(jm, tm, observe):
    jobs = {k: jnp.asarray(v, jnp.float32) for k, v in observe.items()}
    tobs = {k: pp.util.to_tensor(v, "cpu") for k, v in observe.items()}
    jfm = jhmc._functionalize(jm, jobs, 1.0, False, "PARALLEL_TEMPERING", (), None)
    tfm = hmc._functionalize(tm, tobs, 1.0, "PARALLEL_TEMPERING", (), None)
    return jfm, jobs, tfm, tobs


# ---------------------------------------------------------------------------
# (i) potential_parts and the tempered potential
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", list(_models()))
def test_potential_parts_and_tempered_gradient_match_jax(name):
    (jm, tm), observe = _models()[name]
    jfm, jobs, tfm, tobs = _functional_pair(jm, tm, observe)
    assert tfm.dim == jfm.dim
    rng = np.random.default_rng(17)
    z = rng.normal(size=(6, jfm.dim)).astype(np.float32)
    if name == "gmm":
        z = z + np.array([-2.0, 2.0], np.float32)
    beta = np.array([0.0, 0.02, 0.2, 0.5, 0.9, 1.0], np.float32)

    def tempered(v, b):
        lp, ll = jfm.potential_parts(v, jobs)
        return -jax.scipy.special.logsumexp(lp + b * ll)

    jlp, jll = jax.jit(jax.vmap(lambda v: jfm.potential_parts(v, jobs)))(jnp.asarray(z))
    ju, jg = jax.jit(jax.vmap(jax.value_and_grad(tempered)))(jnp.asarray(z), jnp.asarray(beta))
    with torch.no_grad():
        tlp, tll = tfm.potential_parts(torch.as_tensor(z), tobs)
    _close(tlp.numpy(), jlp)
    _close(tll.numpy(), jll)
    assert tlp.shape == (6, tfm.num_combos)
    tu, tg, lp, ll = tfm.value_and_grad_beta(torch.as_tensor(z), torch.as_tensor(beta), tobs)
    _close(tu.numpy(), ju)
    _close(tg.numpy(), jg)
    _close(lp.numpy(), jlp)
    # at β = 1 the tempered potential is the potential
    with torch.no_grad():
        _close(tu.numpy()[-1], tfm.potential(torch.as_tensor(z[-1:]), tobs).numpy()[0])


# ---------------------------------------------------------------------------
# (ii) one ensemble transition against a float64 numpy transcription
# ---------------------------------------------------------------------------


def _norm_lp(x, m, s):
    return -0.5 * ((x - m) / s) ** 2 - math.log(s) - 0.5 * math.log(2 * math.pi)


class _NumpyHierarchy:
    """Parts and their z-derivatives of hierarchy_body at y, float64:
    z [n, 2] -> lp, ll [n, 1]; dlp, dll [n, 1, 2]."""

    G = 1

    def __init__(self, y):
        self.y = y

    def parts(self, z):
        x1, x2 = z[:, 0], z[:, 1]
        lp = _norm_lp(x1, 0.0, 1.0) + _norm_lp(x2, x1, 1.0)
        ll = _norm_lp(self.y, x2, 1.0)
        dlp = np.stack([-x1 + (x2 - x1), -(x2 - x1)], -1)
        dll = np.stack([np.zeros_like(x1), self.y - x2], -1)
        return lp[:, None], ll[:, None], dlp[:, None], dll[:, None]


class _NumpyDepMix:
    """The same for depmix_body (G = 2 enumerated combinations, D = 1)."""

    G = 2

    def __init__(self, y):
        self.y = y

    def parts(self, z):
        x = z[:, 0]
        lp = np.stack([math.log(p) + _norm_lp(x, c, 1.0) for p, c in ((0.3, -3.0), (0.7, 3.0))], -1)
        ll = np.stack([_norm_lp(self.y, x, 0.5)] * 2, -1)
        dlp = np.stack([-(x - c) for c in (-3.0, 3.0)], -1)[..., None]
        dll = np.stack([(self.y - x) / 0.25] * 2, -1)[..., None]
        return lp, ll, dlp, dll


def _np_pot(lp, ll, beta):
    a = lp + beta[:, None] * ll
    m = a.max(-1, keepdims=True)
    return -(m[:, 0] + np.log(np.exp(a - m).sum(-1)))


def _np_value_and_grad(model, z, beta):
    lp, ll, dlp, dll = model.parts(z)
    a = lp + beta[:, None] * ll
    w = np.exp(a - a.max(-1, keepdims=True))
    w = w / w.sum(-1, keepdims=True)
    g = -np.sum(w[..., None] * (dlp + beta[:, None, None] * dll), 1)
    return _np_pot(lp, ll, beta), g, lp, ll


def _np_pt_transition(model, z, g, betas, eps, inv_mass, p0, u_acc, u_swap, t, steps):
    """pyprob_tpu/inference/pt.py's chain_step for C ensembles, float64:
    the replica HMC moves, then the even/odd swap sweep with the general
    tempered-energy acceptance, then the gradient at each replica's β."""
    C, K, D = z.shape
    zr, gr = z.reshape(C * K, D), g.reshape(C * K, D)
    br = np.tile(betas, C)
    er, mr = eps.reshape(-1, 1), inv_mass.reshape(C * K, D)
    lp, ll = model.parts(zr)[:2]
    u = _np_pot(lp, ll, br)
    p = p0.reshape(C * K, D) - 0.5 * er * gr
    zl = zr
    for i in range(steps):
        zl = zl + er * mr * p
        ul, gl, lpl, lll = _np_value_and_grad(model, zl, br)
        p = p - (0.5 * er if i == steps - 1 else er) * gl
    kin = lambda q: 0.5 * np.sum(mr * q * q, -1)  # noqa: E731
    log_alpha = (u - ul) + (kin(p0.reshape(C * K, D)) - kin(p))
    accept = np.log(u_acc.reshape(-1)) < log_alpha
    zr = np.where(accept[:, None], zl, zr)
    lp = np.where(accept[:, None], lpl, lp).reshape(C, K, -1)
    ll = np.where(accept[:, None], lll, ll).reshape(C, K, -1)
    Z = zr.reshape(C, K, D)
    ks = np.arange(K - 1)
    active = (ks % 2) == (t % 2)
    swaps = np.zeros((C, K - 1), bool)
    for c in range(C):
        e_self = _np_pot(lp[c], ll[c], betas)
        e_lo_hi = _np_pot(lp[c, ks + 1], ll[c, ks + 1], betas[ks])
        e_hi_lo = _np_pot(lp[c, ks], ll[c, ks], betas[ks + 1])
        log_a = (e_self[ks] + e_self[ks + 1]) - (e_lo_hi + e_hi_lo)
        swaps[c] = active & (np.log(u_swap[c]) < log_a)
        perm = np.arange(K)
        perm[ks] = np.where(swaps[c], ks + 1, perm[ks])
        perm[ks + 1] = np.where(swaps[c], ks, perm[ks + 1])
        Z[c], lp[c], ll[c] = Z[c][perm], lp[c][perm], ll[c][perm]
    g = _np_value_and_grad(model, Z.reshape(C * K, D), br)[1]
    alpha = np.minimum(1.0, np.exp(log_alpha))
    return Z, g.reshape(C, K, D), accept.reshape(C, K), alpha.reshape(C, K), swaps


@pytest.mark.parametrize("name", ["hierarchy", "depmix"])
def test_pt_transition_matches_numpy(name):
    if name == "hierarchy":
        _, tm = body_pair(hierarchy_body)
        observe, ref_model = {"y": 2.0}, _NumpyHierarchy(2.0)
    else:
        _, tm = depmix_pair()
        observe, ref_model = {"y": 1.0}, _NumpyDepMix(1.0)
    tobs = {k: pp.util.to_tensor(v, "cpu") for k, v in observe.items()}
    fm = hmc._functionalize(tm, tobs, 1.0, "PARALLEL_TEMPERING", (), None)
    C, K, D, G = 3, 4, fm.dim, fm.num_combos
    assert G == ref_model.G
    rng = np.random.default_rng(23)
    betas = pt.ladder(K, torch.zeros(()))
    z = rng.normal(size=(C, K, D)).astype(np.float32)
    inv_mass = rng.uniform(0.5, 1.5, size=(C, K, D)).astype(np.float32)
    p0 = (rng.normal(size=(C, K, D)) / np.sqrt(inv_mass)).astype(np.float32)
    eps = rng.uniform(0.1, 1.0, size=(C, K)).astype(np.float32)
    u_acc = rng.uniform(size=(C, K)).astype(np.float32)
    u_swap = rng.uniform(size=(C, K - 1)).astype(np.float32)
    beta_rows = betas.expand(C, K).reshape(-1)
    _, g, lp, ll = fm.value_and_grad_beta(torch.as_tensor(z).reshape(-1, D), beta_rows, tobs)
    decisions = []
    for t in (0, 1):
        got = pt.pt_transition(
            fm, tobs, torch.as_tensor(z), lp.reshape(C, K, G), ll.reshape(C, K, G), g.reshape(C, K, D), betas,
            torch.as_tensor(eps), torch.as_tensor(inv_mass), torch.as_tensor(p0), torch.as_tensor(u_acc),
            torch.as_tensor(u_swap), t, 10,
        )
        ref_z, ref_g, ref_accept, ref_alpha, ref_swaps = _np_pt_transition(
            ref_model, z.astype(np.float64), g.reshape(C, K, D).numpy().astype(np.float64), betas.numpy().astype(
                np.float64), eps.astype(np.float64), inv_mass.astype(np.float64), p0.astype(np.float64), u_acc,
            u_swap, t, 10,
        )
        _close(got[4].numpy(), ref_alpha, 1e-4)
        np.testing.assert_array_equal(got[5].numpy(), ref_swaps)
        np.testing.assert_array_equal(got[6].numpy(), (np.arange(K - 1) % 2) == t)
        _close(got[0].numpy(), ref_z, 1e-4)
        _close(got[3].numpy(), ref_g, 1e-4)
        # the carried parts are the parts of the returned positions
        with torch.no_grad():
            lp2, ll2 = fm.potential_parts(got[0].reshape(-1, D), tobs)
        _close(got[1].reshape(-1, G).numpy(), lp2.numpy())
        _close(got[2].reshape(-1, G).numpy(), ll2.numpy())
        decisions.append((ref_accept, ref_swaps))
    # the draws exercise both outcomes of both decisions
    accepts = np.stack([a for a, _ in decisions])
    swaps = np.stack([s for _, s in decisions])
    assert accepts.any() and not accepts.all() and swaps.any() and not swaps.all()


# ---------------------------------------------------------------------------
# (iii) the JAX tests' criteria at reduced counts, resumes, errors
# ---------------------------------------------------------------------------


def test_pt_hops_modes_hmc_cannot():
    # tests/test_pt.py:28-92 runs one ensemble for 8,000 kept transitions
    # and 8 ensembles of 1,000.  Here 16 ensembles of 150 kept transitions
    # after 100 of burn-in (2,400 draws, step-major: ensemble c's are
    # c::16): every ensemble crossed in 4 of 4 seeds; 14 of 16 must
    _, model = body_pair(bimodal_body)
    post = model.posterior_results(2400, observe={"y": 16.0}, inference_engine=PT, num_chains=16, burn_in=100)
    allv = np.asarray(post.values_numpy(), np.float64).ravel()
    assert 0.3 < float(np.mean(allv > 0)) < 0.7
    assert abs(float(np.mean(np.abs(allv))) - 4.0) < 0.15
    shares = [float(np.mean(allv[c::16] > 0)) for c in range(16)]
    assert sum(0.1 < s < 0.9 for s in shares) >= 14, shares
    md = post.metadata[-1]
    assert md["swap_acceptance_rate"] > 0.2 and md["num_temperatures"] == 8
    assert set(md) >= {"acceptance_rate", "final_step_size", "swap_acceptance_rate", "num_temperatures",
                       "leapfrog_steps", "num_chains", "burn_in"}
    # every HMC chain stays in its mode (the JAX test's 8 chains, 150 kept
    # draws each after 100 of burn-in here)
    for c in model.posterior_results(1200, observe={"y": 16.0}, inference_engine=HMC, num_chains=8, burn_in=100,
                                     return_chains=True):
        frac = float(np.mean(np.asarray(c.values_numpy(), np.float64) > 0))
        assert min(frac, 1 - frac) < 0.02


def test_pt_unimodal_correctness():
    # tests/test_pt.py:106-117 at a fifth of its draws (1,600 of 8 chains,
    # burn-in 100, K = 6): the mean's Monte Carlo error is about 0.04, so
    # 0.15 (the JAX test's 0.1 widened for the count) is about 4 of them
    post = TorchGUM().posterior_results(1600, observe=OBSERVE, inference_engine=PT, num_chains=8, burn_in=100,
                                        num_temperatures=6)
    assert abs(float(post.mean) - POSTERIOR_MEAN) < 0.15
    assert abs(float(post.stddev) - POSTERIOR_STDDEV) < 0.15
    assert post.length == 1600 and post.metadata[-1]["num_temperatures"] == 6


@pytest.mark.parametrize("name", ["mix", "depmix"])
def test_pt_enumerates_discrete_sites(name):
    # tests/test_pt.py:138-160, 187-215 (12,000 draws of 4 ensembles, K = 4)
    # at 1,600 draws of 8 ensembles, burn-in 100, against the analytic
    # mixture posterior; 0.15 for the JAX tests' 0.12 and 0.1 at a seventh
    # of the draws (Monte Carlo error about 0.05)
    _, model = mix_pair() if name == "mix" else depmix_pair()
    mean, std, _ = mixture_posterior(name)
    post = model.posterior_results(1600, observe={"y": 1.0}, inference_engine=PT, num_chains=8, burn_in=100,
                                   num_temperatures=4)
    assert abs(float(post.mean) - mean) < 0.15 and abs(float(post.stddev) - std) < 0.15


def test_pt_resume_replica_ladder():
    # tests/test_gradient_resume.py:122-140 at 800 draws of 16 ensembles
    model = TorchGUM()
    post = model.posterior_results(800, observe=OBSERVE, inference_engine=PT, num_chains=16, num_temperatures=4,
                                   burn_in=60)
    state = post.final_gradient_state
    assert state.z.ndim == 3 and state.z.shape[1:] == (4, 1)
    assert state.step_size.shape == (16, 4) and state.inv_mass.shape == (16, 4, 1)
    post2 = model.posterior_results(800, observe=OBSERVE, inference_engine=PT, num_temperatures=4,
                                    initial_trace=state)
    assert abs(float(post2.mean) - POSTERIOR_MEAN) < 0.2
    assert post2.metadata[-1]["burn_in"] == 0 and post2.metadata[-1]["num_chains"] == 16
    hmc_state = model.posterior_results(64, observe=OBSERVE, inference_engine=HMC, num_chains=8,
                                        burn_in=10).final_gradient_state
    with pytest.raises(RuntimeError, match="rank"):
        model.posterior_results(100, observe=OBSERVE, inference_engine=PT, num_temperatures=4,
                                initial_trace=hmc_state)
    with pytest.raises(RuntimeError, match="rank"):
        model.posterior_results(100, observe=OBSERVE, inference_engine=HMC, initial_trace=state)
    with pytest.raises(RuntimeError, match="replicas"):
        model.posterior_results(100, observe=OBSERVE, inference_engine=PT, num_temperatures=6, initial_trace=state)
    with pytest.raises(RuntimeError, match="GradientChainState"):
        model.posterior_results(100, observe=OBSERVE, inference_engine=PT, initial_trace="no")


class _Disc(pp.Model):
    def forward(self):
        k = pp.sample(pp.distributions.Categorical(probs=[0.5, 0.5]))
        pp.observe(pp.distributions.Normal(1.0 * k, 1.0), name="y")
        return k


class _NotTraceable(pp.Model):
    def forward(self):
        while True:
            x = pp.sample(pp.distributions.Uniform(0.0, 1.0))
            if float(x) < 0.5:
                break
        pp.observe(pp.distributions.Normal(float(x), 1.0), name="y")
        return x


def test_pt_errors():
    with pytest.raises(ValueError, match="num_temperatures"):
        TorchGUM().posterior_results(100, observe=OBSERVE, inference_engine=PT, num_temperatures=1)
    with pytest.raises(RuntimeError, match="no continuous latent"):
        _Disc().posterior_results(100, observe={"y": 1.0}, inference_engine=PT)
    with pytest.raises(RuntimeError, match="no interpreter tier"):
        _NotTraceable().posterior(num_traces=100, observe={"y": 0.1}, inference_engine=PT)
    with pytest.raises(RuntimeError, match="observe"):
        TorchGUM().posterior(num_traces=100, inference_engine=PT)


# ---------------------------------------------------------------------------
# on a card (skipped here)
# ---------------------------------------------------------------------------


@pytest.mark.cuda
def test_tempered_move_from_its_graph_equals_the_eager_move():
    """The hierarchy's tempered HMC move (10 leapfrogs and the acceptance)
    replayed from its CUDA graph equals the eager move to the bit, for two
    sets of draws through one graph; GaussianMixture's move (kernels 1 and
    1b in every potential) is not captured, and launches kernel 1b once a
    leapfrog."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (the CUDA kernels have no interpret mode)")
    from pyprob_tpu_torch.models import GaussianMixture
    from pyprob_tpu_torch.ops import kernels as K

    pp.set_device("cuda")
    try:
        _, tm = body_pair(hierarchy_body)
        obs = {"y": pp.util.to_tensor(2.0, "cuda")}
        fm = hmc._functionalize(tm, obs, 1.0, "PARALLEL_TEMPERING", (), None, pp.util.generator("cuda"))
        R, D = 96, fm.dim
        gen = torch.Generator("cuda").manual_seed(0)
        beta = pt.ladder(8, torch.zeros((), device="cuda")).repeat(R // 8)
        for _ in range(3):
            z = torch.randn((R, D), generator=gen, device="cuda")
            _, g, lp, ll = fm.value_and_grad_beta(z, beta, obs)
            draws = (torch.full((R,), 0.3, device="cuda"), torch.ones_like(z),
                     torch.randn((R, D), generator=gen, device="cuda"), torch.rand((R,), generator=gen, device="cuda"))
            got = fm.tempered_move(z, lp, ll, g, beta, *draws, 10, obs)
            want = hmc.tempered_hmc_transition(lambda v, b: fm._eager_tempered(v, b, obs), z, lp, ll, g, beta,
                                               *draws, 10)
            assert all(torch.equal(a, b) for a, b in zip(got, want))
        assert fm._graphs[((R, D), "move", 10)] is not None
        gm = GaussianMixture(num_components=2, obs_stddev=0.6, num_data=40)
        y = {"y": torch.as_tensor(gm.synthesize([-2.0, 2.0], rng=0), dtype=torch.float32, device="cuda")}
        fm = hmc._functionalize(gm, y, 1.0, "PARALLEL_TEMPERING", (), None, pp.util.generator("cuda"))
        z = torch.zeros((16, 2), device="cuda") + torch.tensor([-2.0, 2.0], device="cuda")
        beta = torch.ones((16,), device="cuda")
        _, g, lp, ll = fm.value_and_grad_beta(z, beta, y)
        before = K.mixture_normal_log_prob_backward.launches
        fm.tempered_move(z, lp, ll, g, beta, torch.full((16,), 0.01, device="cuda"), torch.ones_like(z),
                         torch.zeros_like(z), torch.full((16,), 0.5, device="cuda"), 10, y)
        assert fm._graphs[((16, 2), "move", 10)] is None
        assert K.mixture_normal_log_prob_backward.launches == before + 10
    finally:
        pp.set_device("cpu")
