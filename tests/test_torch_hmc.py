"""The gradient engines' base and HMC (``pyprob_tpu_torch.inference.hmc``)
on the CPU, against the JAX package (``pyprob_tpu.inference.hmc``).

(i) The transforms and their log-Jacobians for every family of
``_to_x`` / ``_to_z`` (bounded, positive, Pareto, unbounded, Dirichlet's
stick-breaking, LKJCholesky's partial correlations), over a batch of rows,
against the JAX functions vmapped: within 1e-5 (1 + |ref|).  (ii) The
potential and its gradient at fixed z (numpy draws, the same flat layout:
sorted addresses) against JAX ``_functionalize(...).potential`` and
``jax.grad`` of it, for GUM, UniformGUM, the hierarchy, a positive
support, MixedDiscrete (enumeration), Dirichlet–Categorical, an
LKJCholesky latent and GaussianMixture with and without ``learn_weights``
(the mixture's kernel path on its plain version here): within 1e-5 (1 +
|ref|).  (iii) The warmup arithmetic (``_da_update``, ``_welford_*``,
``_warmup_adapt``) over sequences of steps against the JAX functions
vmapped over chains: within 1e-5 (1 + |ref|).  (iv) One HMC transition
given its momentum and uniform against the JAX package's leapfrog
arithmetic on ``fm.potential`` with ``jax.grad``: within 1e-4 (1 + |ref|)
after 10 leapfrogs.  (v) The panel-Cholesky autograd Function
(``ops.blocked_linalg.PanelCholesky``; its forward on the tile kernel's
plain version here) against ``torch.linalg.cholesky``'s autograd in
float64, and, as the GP potential's gradient, against ``jax.grad`` of the
JAX package's GP potential at N = 128 and 192: within 2e-3 (1 + |ref|)
(float32 factors of covariances of condition number ~10^3).  (vi) Short
statistical runs (16 chains, a few thousand draws; wider limits than the
JAX tests'), resumes, pickling, a changed observation, and the errors.
"""

import math
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pyprob_tpu
import pyprob_tpu_torch as pp
from pyprob_tpu.inference import hmc as jhmc
from pyprob_tpu_torch.inference import hmc
from pyprob_tpu_torch.ops import blocked_linalg
from pyprob_tpu_torch.vectorized import _TraceabilityCache

from _torch_parity import (
    OBSERVE,
    POSTERIOR_MEAN,
    POSTERIOR_STDDEV,
    JaxDirCat,
    JaxGUM,
    JaxLKJLatent,
    TorchDirCat,
    TorchGUM,
    TorchLKJLatent,
)

torch.set_num_threads(2)

HMC = pp.InferenceEngine.HAMILTONIAN_MONTE_CARLO
NUTS = pp.InferenceEngine.NO_U_TURN_SAMPLER
JD, TD = pyprob_tpu.distributions, pp.distributions


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


# ---------------------------------------------------------------------------
# (i) transforms
# ---------------------------------------------------------------------------

# (name, constructor args, unconstrained shape of one value)
FAMILIES = [
    ("Normal", (0.5, 2.0), ()),
    ("Uniform", (-1.0, 3.0), ()),
    ("TruncatedNormal", (0.3, 1.2, -0.5, 2.0), ()),
    ("Beta", (2.0, 3.0, -1.0, 4.0), ()),
    ("Exponential", (1.5,), ()),
    ("Gamma", (2.0, 3.0), ()),
    ("Weibull", (1.5, 2.0), ()),
    ("LogNormal", (0.2, 0.7), ()),
    ("HalfNormal", (2.0,), ()),
    ("HalfCauchy", (1.3,), ()),
    ("Chi2", (3.0,), ()),
    ("InverseGamma", (3.0, 2.0), ()),
    ("Pareto", (1.5, 3.0), ()),
    ("Laplace", (0.1, 1.4), ()),
    ("StudentT", (4.0, 0.5, 2.0), ()),
    ("VonMises", (0.3, 2.0), ()),
    ("Cauchy", (0.0, 1.0), ()),
    ("Gumbel", (0.5, 2.0), ()),
    ("Logistic", (0.5, 2.0), ()),
    ("MultivariateNormal", (np.zeros(3), np.eye(3)), (3,)),
    ("Dirichlet", (np.array([2.0, 3.0, 4.0]),), (2,)),
    ("LKJCholesky", (3, 1.5), (3,)),
]


@pytest.mark.parametrize("name,params,zshape", FAMILIES, ids=[f[0] for f in FAMILIES])
def test_transforms_match_jax(name, params, zshape):
    rng = np.random.default_rng(len(name))
    z = (1.5 * rng.normal(size=(64,) + zshape)).astype(np.float32)
    jdist, tdist = getattr(JD, name)(*params), getattr(TD, name)(*params)
    jx, jld = jax.vmap(lambda v: jhmc._to_x(jdist, v))(jnp.asarray(z))
    tx, tld = hmc._to_x(tdist, torch.as_tensor(z))
    _close(tx.numpy(), jx)
    _close(tld.numpy(), jld)
    assert tld.shape == (64,)
    # the inverse on the JAX package's support values
    jz = jax.vmap(lambda v: jhmc._to_z(jdist, v))(jx)
    tz = hmc._to_z(tdist, torch.as_tensor(np.array(jx)))
    _close(tz.numpy(), jz)
    xshape = tuple(np.asarray(jx).shape[1:])
    assert hmc._unconstrained_shape(tdist, xshape) == jhmc._unconstrained_shape(jdist, xshape) == zshape


def test_transform_errors():
    with pytest.raises(NotImplementedError, match="batched LKJCholesky"):
        hmc._unconstrained_shape(TD.LKJCholesky(2, 1.0), (3, 2, 2))
    with pytest.raises(NotImplementedError, match="requires continuous sample sites; Poisson"):
        hmc._to_x(TD.Poisson(3.0), torch.zeros(4))


# ---------------------------------------------------------------------------
# (ii) potentials and gradients
# ---------------------------------------------------------------------------


def uniform_gum_body(pp):
    mu = pp.sample(pp.distributions.Uniform(0.0, 20.0))
    lik = pp.distributions.Normal(mu, math.sqrt(2.0))
    pp.observe(lik, name="obs0")
    pp.observe(lik, name="obs1")
    return mu


def hierarchy_body(pp):
    x1 = pp.sample(pp.distributions.Normal(0.0, 1.0))
    x2 = pp.sample(pp.distributions.Normal(x1, 1.0))
    pp.observe(pp.distributions.Normal(x2, 1.0), name="y")
    return x1


def scale_body(pp):
    s = pp.sample(pp.distributions.Exponential(1.0))
    for i in range(3):
        pp.observe(pp.distributions.Normal(0.0, s), name=f"y{i}")
    return s


def mixed_discrete_body(pp, where):
    mu = pp.sample(pp.distributions.Normal(0.0, 5.0))
    k = pp.sample(pp.distributions.Categorical(probs=[0.5, 0.5]))
    pp.observe(pp.distributions.Normal(mu + where(k == 0, -2.0, 2.0), 1.0), name="y")
    return mu


def _pair(body, *jax_args, torch_args=None):
    """The JAX package's and the port's model of one shared body (equal
    addresses)."""
    torch_args = jax_args if torch_args is None else torch_args

    class J(pyprob_tpu.Model):
        def forward(self):
            return body(pyprob_tpu, *jax_args)

    class T(pp.Model):
        def forward(self):
            return body(pp, *torch_args)

    return J(), T()


SCALE_OBSERVE = {"y0": 1.5, "y1": -2.0, "y2": 1.0}


def _models():
    from pyprob_tpu.models import GaussianMixture as JGM
    from pyprob_tpu_torch.models import GaussianMixture as TGM

    y = JGM(num_components=2, obs_stddev=0.6, num_data=40).synthesize([-2.0, 2.0], rng=0)
    gmm = {"num_components": 2, "obs_stddev": 0.6, "num_data": 40}
    return {
        "gum": ((JaxGUM(), TorchGUM()), OBSERVE),
        "uniform_gum": (_pair(uniform_gum_body), OBSERVE),
        "hierarchy": (_pair(hierarchy_body), {"y": 3.0}),
        "positive": (_pair(scale_body), SCALE_OBSERVE),
        "mixed_discrete": (_pair(mixed_discrete_body, jnp.where, torch_args=(torch.where,)), {"y": 1.0}),
        "dirichlet_categorical": ((JaxDirCat(), TorchDirCat()), {"o0": 0, "o1": 0, "o2": 1}),
        "lkj": ((JaxLKJLatent(), TorchLKJLatent()), {"y": np.array([2.2, 2.18])}),
        "gmm": ((JGM(**gmm), TGM(**gmm)), {"y": y}),
        "gmm_learn_weights": ((JGM(learn_weights=True, **gmm), TGM(learn_weights=True, **gmm)), {"y": y}),
    }


MODELS = list(_models())


def _functional_pair(jm, tm, observe, engine="HAMILTONIAN_MONTE_CARLO"):
    jobs = {k: jnp.asarray(v, jnp.float32) for k, v in observe.items()}
    tobs = {k: pp.util.to_tensor(v, "cpu") for k, v in observe.items()}
    jfm = jhmc._functionalize(jm, jobs, 1.0, False, engine, (), None)
    tfm = hmc._functionalize(tm, tobs, 1.0, engine, (), None)
    return jfm, jobs, tfm, tobs


def _jax_potentials(fm, obs, z):
    """The JAX potential, its gradient and the potential without the
    Jacobian at the rows of z, vmapped in one compiled call."""

    def one(v):
        u, g = jax.value_and_grad(fm.potential)(v, obs)
        return u, g, fm.potential_nojac(v, obs)

    return [np.asarray(a) for a in jax.jit(jax.vmap(one))(jnp.asarray(z))]


@pytest.mark.parametrize("name", MODELS)
def test_potential_and_gradient_match_jax(name):
    (jm, tm), observe = _models()[name]
    jfm, jobs, tfm, tobs = _functional_pair(jm, tm, observe)
    assert tfm.dim == jfm.dim
    rng = np.random.default_rng(7)
    z = rng.normal(size=(6, jfm.dim)).astype(np.float32)
    ju, jg, jn = _jax_potentials(jfm, jobs, z)
    tu, tg = tfm.value_and_grad(torch.as_tensor(z), tobs)
    _close(tu.numpy(), ju)
    _close(tg.numpy(), jg)
    # the same potential without the Jacobian (MAP's)
    with torch.no_grad():
        _close(tfm.potential_nojac(torch.as_tensor(z), tobs).numpy(), jn)
    if name == "mixed_discrete":
        assert tfm.num_combos == 2 and tfm.disc_addrs == sorted(jfm.discrete)


# ---------------------------------------------------------------------------
# (iii) warmup arithmetic
# ---------------------------------------------------------------------------


def test_warmup_arithmetic_matches_jax():
    C, D, burn_in = 5, 3, 40
    rng = np.random.default_rng(3)
    eps0 = rng.uniform(0.05, 0.5, C).astype(np.float32)
    jda = jax.vmap(jhmc._da_init)(jnp.asarray(eps0))
    tda = hmc._da_init(torch.as_tensor(eps0))
    for a, b in zip(tda, jda):
        _close(a.numpy(), b)
    jwf = jax.vmap(lambda _: jhmc._welford_init(D))(jnp.arange(C))
    twf = hmc._welford_init(C, D, torch.zeros(1))
    jmass, tmass = jnp.ones((C, D)), torch.ones((C, D))
    adapt = jax.jit(jhmc._warmup_adapt, static_argnames=("target_accept", "batched"))
    for t in range(burn_in + 6):
        z = rng.normal(size=(C, D)).astype(np.float32) * np.array([0.1, 1.0, 10.0], np.float32)
        alpha = rng.uniform(size=C).astype(np.float32)
        jda, jwf, jmass = adapt(
            jda, jwf, jmass, jnp.asarray(z), jnp.asarray(alpha), jnp.int32(t), jnp.int32(burn_in),
            target_accept=0.8, batched=True,
        )
        tda, twf, tmass = hmc._warmup_adapt(tda, twf, tmass, torch.as_tensor(z), torch.as_tensor(alpha), t,
                                            burn_in, 0.8)
        for a, b in zip(tda + twf, tuple(jda) + tuple(jwf)):
            _close(a.numpy(), b)
        _close(tmass.numpy(), jmass)
    # the mass matrix took the middle window's variances
    assert np.all(np.abs(np.log(tmass.numpy().mean(0) / [0.01, 1.0, 100.0])) < 1.0)
    # the update and variance alone
    jd = jax.vmap(jhmc._da_update, in_axes=(0, 0, None))(jda, jnp.asarray(alpha), 0.75)
    for a, b in zip(hmc._da_update(tda, torch.as_tensor(alpha), 0.75), jd):
        _close(a.numpy(), b)
    _close(hmc._welford_variance(twf).numpy(), jax.vmap(jhmc._welford_variance)(jwf))


# ---------------------------------------------------------------------------
# (iv) one HMC transition given its draws
# ---------------------------------------------------------------------------


def _jax_transitions(fm, obs, z, p0, uniform, eps, inv_mass, steps):
    """The JAX package's chain step arithmetic (pyprob_tpu/inference/hmc.py,
    make_chain_step) for each chain with the given momentum and uniform,
    vmapped over the chains in one compiled call."""
    grad = jax.grad(fm.potential)

    def one(z, p0, uniform, eps, inv_mass):
        g = grad(z, obs)
        u = fm.potential(z, obs)

        def kinetic(p):
            return 0.5 * jnp.sum(inv_mass * p * p)

        p = p0 - 0.5 * eps * g
        zl = z
        for i in range(steps):
            zl = zl + eps * inv_mass * p
            gl = grad(zl, obs)
            p = p - (0.5 * eps if i == steps - 1 else eps) * gl
        u_new = fm.potential(zl, obs)
        log_alpha = (u - u_new) + (kinetic(p0) - kinetic(p))
        log_alpha = jnp.where(jnp.isnan(log_alpha), -jnp.inf, log_alpha)
        accept = jnp.log(uniform) < log_alpha
        return jnp.where(accept, zl, z), accept, jnp.minimum(1.0, jnp.exp(log_alpha))

    out = jax.jit(jax.vmap(one))(*(jnp.asarray(a) for a in (z, p0, uniform, eps, inv_mass)))
    return [np.asarray(a) for a in out]


@pytest.mark.parametrize("name", ["hierarchy", "gmm_learn_weights"])
def test_hmc_transition_matches_jax(name):
    (jm, tm), observe = _models()[name]
    jfm, jobs, tfm, tobs = _functional_pair(jm, tm, observe)
    C, D = 4, jfm.dim
    rng = np.random.default_rng(11)
    z = (0.5 * rng.normal(size=(C, D))).astype(np.float32)
    if name.startswith("gmm"):
        z[:, :2] = np.array([-2.0, 2.0]) + 0.3 * rng.normal(size=(C, 2))
    inv_mass = rng.uniform(0.5, 1.5, size=(C, D)).astype(np.float32)
    p0 = (rng.normal(size=(C, D)) / np.sqrt(inv_mass)).astype(np.float32)
    uniform = rng.uniform(size=C).astype(np.float32)
    eps = np.array([0.01, 0.03, 0.05, 0.2], np.float32)
    zt = torch.as_tensor(z)
    u, g = tfm.value_and_grad(zt, tobs)
    got_z, _, _, alpha, accept = hmc.hmc_transition(
        lambda v: tfm.value_and_grad(v, tobs), zt, u, g, torch.as_tensor(eps), torch.as_tensor(inv_mass),
        torch.as_tensor(p0), torch.as_tensor(uniform), 10,
    )
    ref_z, ref_accept, ref_alpha = _jax_transitions(jfm, jobs, z, p0, uniform, eps, inv_mass, 10)
    np.testing.assert_array_equal(accept.numpy(), ref_accept)
    _close(got_z.numpy(), ref_z, 1e-4)
    _close(alpha.numpy(), ref_alpha, 1e-4)


# ---------------------------------------------------------------------------
# (v) the panel Cholesky under autograd
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("N", [128, 192])
def test_panel_cholesky_backward(N, monkeypatch):
    from pyprob_tpu.models import GaussianProcessRegression as JGP
    from pyprob_tpu_torch.models import GaussianProcessRegression as TGP

    rng = np.random.default_rng(N)
    X = rng.normal(size=(2, N, N + 3))
    a64 = torch.as_tensor(X @ np.swapaxes(X, 1, 2) / N + np.eye(N))
    a = a64.float().requires_grad_(True)
    L = blocked_linalg.PanelCholesky.apply(a)
    w = torch.as_tensor(rng.normal(size=(2, N, N)))
    (L * w.float()).sum().backward()
    ref = a64.clone().requires_grad_(True)
    (torch.linalg.cholesky(ref) * w).sum().backward()
    _close(L.detach().numpy(), torch.linalg.cholesky(a64).numpy(), 2e-3)
    _close(a.grad.numpy(), ref.grad.numpy(), 2e-3)
    # the GP potential's gradient, its Cholesky through the Function (the
    # panel path, taken on the CPU here), against jax.grad of the JAX
    # package's GP potential
    monkeypatch.setattr(blocked_linalg, "_use_panels", lambda m: m.dim() >= 2 and m.shape[-1] >= 128)
    calls = []
    real = blocked_linalg.PanelCholesky.apply
    monkeypatch.setattr(blocked_linalg.PanelCholesky, "apply", lambda m: calls.append(m.shape) or real(m))
    x = np.linspace(0, 4, N)
    jm = JGP(x, learn=("lengthscale",), noise=0.2)
    tm = TGP(x, learn=("lengthscale",), noise=0.2)
    y = jm.synthesize(rng=3, lengthscale=1.0)
    jfm, jobs, tfm, tobs = _functional_pair(jm, tm, {"y": y})
    z = np.array([[-0.5], [0.0], [0.4]], np.float32)
    tu, tg = tfm.value_and_grad(torch.as_tensor(z), tobs)
    assert calls and calls[-1] == (3, N, N)
    ju, jg, _ = _jax_potentials(jfm, jobs, z)
    _close(tu.numpy(), ju, 2e-3)
    _close(tg.numpy(), jg, 2e-3)


def test_panel_cholesky_double_backward():
    """A Hessian-vector product through ``PanelCholesky`` (its backward is
    differentiable) against ``torch.linalg.cholesky``'s in float64, within
    2e-3 (1 + |ref|)."""
    rng = np.random.default_rng(0)
    X = rng.normal(size=(1, 130, 133))
    a64 = torch.as_tensor(X @ np.swapaxes(X, 1, 2) / 130 + np.eye(130))
    w, v = (torch.as_tensor(rng.normal(size=(1, 130, 130))) for _ in range(2))

    def hvp(chol, a):
        a = a.clone().requires_grad_(True)
        (g,) = torch.autograd.grad((chol(a) * w.to(a.dtype)).sum(), a, create_graph=True)
        return torch.autograd.grad((g * v.to(a.dtype)).sum(), a)[0]

    _close(hvp(blocked_linalg.PanelCholesky.apply, a64.float()).numpy(), hvp(torch.linalg.cholesky, a64).numpy(), 2e-3)


def test_panel_path_without_grad_keeps_its_bits():
    """Without autograd ``cholesky`` runs the plain panel loop: the Function's
    forward gives the same bits."""
    rng = np.random.default_rng(0)
    X = rng.normal(size=(2, 130, 131)).astype(np.float32)
    a = torch.as_tensor(X @ np.swapaxes(X, 1, 2) / 130 + np.eye(130, dtype=np.float32))
    assert torch.equal(blocked_linalg.panel_cholesky(a), blocked_linalg.PanelCholesky.apply(a.requires_grad_(True)))


# ---------------------------------------------------------------------------
# (vi) whole runs, resumes and errors
# ---------------------------------------------------------------------------


def test_hmc_gum_posterior():
    """tests/test_hmc.py:34-44 at 1,600 traces of 16 chains."""
    post = TorchGUM().posterior_results(1600, observe=OBSERVE, inference_engine=HMC, num_chains=16)
    assert abs(float(post.mean) - POSTERIOR_MEAN) < 0.15
    assert abs(float(post.stddev) - POSTERIOR_STDDEV) < 0.15
    md = post.metadata[-1]
    assert 0.5 < md["acceptance_rate"] <= 1.0 and md["final_step_size"] > 0
    assert md["leapfrog_steps"] == 10 and md["burn_in"] == 200 and md["num_chains"] == 16
    assert "batched" in post.name and post.length == 1600


def test_hmc_simplex_and_discrete_decode():
    """tests/test_hmc.py:286-298 (Dirichlet–Categorical: the posterior
    Dirichlet(3, 2, 1)'s mean within 0.05) and :189-224 (MixedDiscrete's
    Categorical drawn from its exact conditional at decode: P(k = 1 | y)
    within 0.08), at 1,600 traces of 16 chains, 5 leapfrogs a step."""
    _, tm = _pair(mixed_discrete_body, torch_args=(torch.where,))
    post = tm.posterior(1600, observe={"y": 1.0}, inference_engine=HMC, num_chains=16, burn_in=50,
                        leapfrog_steps=5)
    ks = [int(v.value) for t in post.get_values() for v in t.variables if "Categorical" in v.address]
    l0, l1 = -((1.0 + 2.0) ** 2) / 52.0, -((1.0 - 2.0) ** 2) / 52.0
    assert abs(np.mean(ks) - math.exp(l1) / (math.exp(l0) + math.exp(l1))) < 0.08
    dc = TorchDirCat().posterior_results(1600, observe={"o0": 0, "o1": 0, "o2": 1}, inference_engine=HMC,
                                         num_chains=16, burn_in=50, leapfrog_steps=5)
    xs = np.asarray(dc.values_numpy(), np.float64)
    assert np.allclose(xs.sum(-1), 1.0, atol=1e-5) and xs.min() > 0
    assert np.allclose(xs.mean(0), [1 / 2, 1 / 3, 1 / 6], atol=0.05)


@pytest.mark.parametrize("engine", [HMC, NUTS], ids=["hmc", "nuts"])
def test_resume_pickle_and_changed_observation(engine):
    """tests/test_gradient_resume.py:30-86 at 800 traces of 16 chains (HMC
    at 5 leapfrogs a step): the state's shapes, a resume without warmup at
    the carried step size, a pickle round trip, and a changed observation
    rescored (the new posterior's mean 2.25 within 0.3)."""
    m = TorchGUM()
    knobs = {"leapfrog_steps": 5} if engine == HMC else {}
    post = m.posterior_results(800, observe=OBSERVE, inference_engine=engine, num_chains=16, burn_in=60, **knobs)
    state = post.final_gradient_state
    assert state.num_chains == 16 and state.dim == 1 and state.z.shape == (16, 1)
    assert np.all(state.step_size > 0) and np.all(state.inv_mass > 0)
    state = pickle.loads(pickle.dumps(state))
    post2 = m.posterior_results(800, observe=OBSERVE, inference_engine=engine, initial_trace=state, **knobs)
    meta = post2.metadata[-1]
    assert meta["burn_in"] == 0 and meta["num_chains"] == 16
    assert abs(meta["final_step_size"] - float(np.mean(state.step_size))) < 1e-5
    assert abs(float(post2.mean) - POSTERIOR_MEAN) < 0.2
    # the carried mass matrix is kept (no warmup window to commit another)
    np.testing.assert_array_equal(post2.final_gradient_state.inv_mass, state.inv_mass)
    post3 = m.posterior_results(800, observe={"obs0": 2.0, "obs1": 3.0}, inference_engine=engine,
                                initial_trace=state, burn_in=50, **knobs)
    assert abs(float(post3.mean) - 2.25) < 0.3


class _Disc(pp.Model):
    def forward(self):
        k = pp.sample(TD.Categorical(probs=[0.5, 0.5]))
        pp.observe(TD.Normal(1.0 * k, 1.0), name="y")
        return k


class _NotTraceable(pp.Model):
    def forward(self):
        while True:
            x = pp.sample(TD.Uniform(0.0, 1.0))
            if float(x) < 0.5:
                break
        pp.observe(TD.Normal(float(x), 1.0), name="y")
        return x


class _Rejection(pp.Model):
    def forward(self):
        def attempt():
            x = pp.sample(TD.Uniform(-1.0, 1.0))
            return x, x * x < 0.5

        x = pp.rejection_sample(attempt)
        pp.observe(TD.Normal(x, 1.0), name="y")
        return x


class _PoissonLatent(pp.Model):
    def forward(self):
        k = pp.sample(TD.Poisson(3.0))
        mu = pp.sample(TD.Normal(0.0, 1.0))
        pp.observe(TD.Normal(mu + k, 1.0), name="y")
        return mu


class _ManyBernoulli(pp.Model):
    def forward(self):
        mu = pp.sample(TD.Normal(0.0, 1.0))
        for _ in range(11):
            mu = mu + pp.sample(TD.Bernoulli(0.5))
        pp.observe(TD.Normal(mu, 1.0), name="y")
        return mu


class _NoLatent(pp.Model):
    def forward(self):
        pp.observe(TD.Normal(0.0, 1.0), name="y")
        return 0.0


def test_errors():
    y = {"y": 1.0}
    for engine in (HMC, NUTS):
        with pytest.raises(RuntimeError, match="no continuous latent"):
            _Disc().posterior_results(100, observe=y, inference_engine=engine)
        for vectorized in (None, False):
            with pytest.raises(RuntimeError, match="no interpreter tier"):
                _NotTraceable().posterior(100, observe={"y": 0.1}, inference_engine=engine, vectorized=vectorized)
    with pytest.raises(NotImplementedError, match="rejection_sample"):
        _Rejection().posterior_results(100, observe=y, inference_engine=HMC)
    with pytest.raises(NotImplementedError, match="continuous or enumerable"):
        _PoissonLatent().posterior_results(100, observe=y, inference_engine=HMC)
    with pytest.raises(NotImplementedError, match="enumeration cap"):
        _ManyBernoulli().posterior_results(100, observe=y, inference_engine=NUTS)
    with pytest.raises(RuntimeError, match="no latent"):
        _NoLatent().posterior_results(100, observe=y, inference_engine=HMC)
    with pytest.raises(RuntimeError, match="requires observe"):
        TorchGUM().posterior_results(100, inference_engine=HMC)
    with pytest.raises(NotImplementedError, match="distributed slice"):
        TorchGUM().posterior_results(100, observe=OBSERVE, inference_engine=HMC, mesh=object())
    with pytest.raises(NotImplementedError, match="distributed slice"):
        hmc.vectorized_hmc_posterior(TorchGUM(), 100, observe=OBSERVE, mesh=object())
    with pytest.raises(RuntimeError, match="GradientChainState"):
        TorchGUM().posterior_results(100, observe=OBSERVE, inference_engine=HMC, initial_trace="not a state")
    two = hmc.GradientChainState(np.zeros((4, 2)), np.ones((4, 2)), np.full(4, 0.1), "HAMILTONIAN_MONTE_CARLO")
    with pytest.raises(RuntimeError, match="latent dim"):
        TorchGUM().posterior_results(100, observe=OBSERVE, inference_engine=HMC, initial_trace=two)
    ladder = hmc.GradientChainState(np.zeros((4, 3, 1)), np.ones((4, 3, 1)), np.full((4, 3), 0.1), "PT")
    with pytest.raises(RuntimeError, match="rank"):
        TorchGUM().posterior_results(100, observe=OBSERVE, inference_engine=NUTS, initial_trace=ladder)


# ---------------------------------------------------------------------------
# on a card (skipped here)
# ---------------------------------------------------------------------------


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (the CUDA kernels have no interpret mode)")


def test_capture_decision_reads_every_counted_kernel():
    """The CUDA-graph decision (``_counted_launches``) sees a launch of
    every wrapper in ``ops.counted_kernels``, and that list holds every
    wrapper of the ops modules that counts its launches."""
    from pyprob_tpu_torch import ops

    registry = ops.counted_kernels()
    counting = {id(fn) for module in (ops.kernels, ops.tile_chol, ops.mvn_logpdf, ops.blocked_linalg)
                for fn in vars(module).values() if callable(fn) and hasattr(fn, "launches")}
    assert counting == {id(fn) for fn in registry.values()}
    for name, fn in registry.items():
        before = hmc._counted_launches()
        fn.launches += 1
        try:
            assert hmc._counted_launches() != before, name
        finally:
            fn.launches -= 1


@pytest.mark.cuda
def test_gradients_on_the_card_match_the_cpu():
    """GaussianMixture with learn_weights (kernels 1 and 1b) and the GP at
    N = 256 (the panel path, kernel 4 under PanelCholesky) at fixed z: the
    potential and gradient on the card against the CPU's plain versions,
    within 1e-4 and 2e-3 (1 + |cpu|) (chip_smoke.py's GRADIENT tolerances)."""
    _need_card()
    from pyprob_tpu_torch.models import GaussianMixture, GaussianProcessRegression
    from pyprob_tpu_torch.ops import kernels as K, tile_chol

    gm = GaussianMixture(num_components=2, obs_stddev=0.6, num_data=40, learn_weights=True)
    gp = GaussianProcessRegression(np.linspace(0, 4, 256), learn=("lengthscale",), noise=0.2)
    cases = (
        (gm, gm.synthesize([-2.0, 2.0], rng=0), np.random.default_rng(1).normal(size=(256, 3)), 1e-4),
        (gp, gp.synthesize(rng=3, lengthscale=1.0), np.linspace(-2, 2, 64).reshape(-1, 1), 2e-3),
    )
    for model, y, z, tol in cases:
        got = {}
        before = (K.mixture_normal_log_prob_backward.launches, tile_chol.chol_inv_tile.launches)
        for device in ("cuda", "cpu"):
            pp.set_device(device)
            obs = {"y": torch.as_tensor(y, dtype=torch.float32, device=device)}
            fm = hmc._functionalize(model, obs, 1.0, "HAMILTONIAN_MONTE_CARLO", (), None,
                                    pp.util.generator(device))
            u, g = fm.value_and_grad(torch.as_tensor(z, dtype=torch.float32, device=device), obs)
            got[device] = (u.cpu().numpy(), g.cpu().numpy())
        assert (K.mixture_normal_log_prob_backward.launches, tile_chol.chol_inv_tile.launches) != before
        for a, b in zip(got["cuda"], got["cpu"]):
            _close(a, b, tol)
    pp.set_device("cpu")


@pytest.mark.cuda
def test_captured_potential_equals_the_eager_one():
    """EightSchools' potential and gradient on the card, replayed from its
    CUDA graph, equal the eager replay's to the bit, for two batches of z
    through one graph; GaussianMixture's (kernels 1 and 1b) is not
    captured."""
    _need_card()
    from pyprob_tpu_torch.models import EightSchools, GaussianMixture

    pp.set_device("cuda")
    es = EightSchools()
    obs = {k: pp.util.to_tensor(v, "cuda") for k, v in es.observes().items()}
    fm = hmc._functionalize(es, obs, 1.0, "NO_U_TURN_SAMPLER", (), None, pp.util.generator("cuda"))
    for seed in (0, 1):
        z = torch.randn((78, fm.dim), generator=torch.Generator("cuda").manual_seed(seed), device="cuda")
        u, g = fm.value_and_grad(z, obs)
        ue, ge = fm._eager_value_and_grad(z, obs, True)
        assert torch.equal(u, ue) and torch.equal(g, ge)
    assert fm._graphs[((78, fm.dim), True)] is not None
    gm = GaussianMixture(num_components=2, obs_stddev=0.6, num_data=40)
    y = {"y": torch.as_tensor(gm.synthesize([-2.0, 2.0], rng=0), dtype=torch.float32, device="cuda")}
    fm = hmc._functionalize(gm, y, 1.0, "NO_U_TURN_SAMPLER", (), None, pp.util.generator("cuda"))
    fm.value_and_grad(torch.zeros((16, 2), device="cuda"), y)
    assert fm._graphs[((16, 2), True)] is None
    pp.set_device("cpu")
