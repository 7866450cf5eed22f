"""The port's NUTS (``pyprob_tpu_torch.inference.nuts``) on the CPU.

(i) Transitions given their draws against a float64 numpy NUTS written
here, recursive in the tree (Hoffman and Gelman, arXiv:1111.4246: a
subtree of height h is two subtrees of height h − 1, each checked for a
U-turn when complete, the second not built when the first failed) with
the generalized criterion on momentum sums and the JAX package's
multinomial sampling: progressive over the leaves of a subtree (leaf i of
doubling j replaces the subtree's proposal when log u_ji < log w_i − log
Σ_{k≤i} w_k), biased between the tree and each new subtree (Stan's
variant).  On a 2-D correlated Gaussian potential, for 16 chains at
several step sizes, a tree-depth cap that binds and step sizes that
diverge: the same chosen state (within 1e-4 (1 + |ref|)), tree depth and
divergence flag.  (ii) The JAX tests' criteria on GUM and UniformGUM at
smaller counts (tests/test_nuts.py), with the metadata (replays, host
syncs).  The runs' RNG streams differ from the JAX
package's, so whole runs are held statistically.
"""

import math

import numpy as np
import pytest
import torch

import pyprob_tpu_torch as pp
from pyprob_tpu_torch.distributions import Normal, Uniform
from pyprob_tpu_torch.inference import nuts
from pyprob_tpu_torch.vectorized import _TraceabilityCache

from _torch_parity import OBSERVE, POSTERIOR_MEAN, POSTERIOR_STDDEV, TorchGUM

torch.set_num_threads(2)

NUTS = pp.InferenceEngine.NO_U_TURN_SAMPLER
DELTA_MAX = 1000.0
# a correlated 2-D Gaussian potential U(z) = ½ zᵀ A z
A = np.array([[2.0, 1.2], [1.2, 1.5]])


@pytest.fixture(autouse=True)
def _port_on_cpu():
    pp.set_device("cpu")
    pp.seed(0)
    pp.set_verbosity(1)
    _TraceabilityCache._cache.clear()
    yield


def _ref_transition(z, p0, eps, inv_mass, dirs, tree_u, leaf_u, max_depth):
    """One chain's recursive multinomial NUTS transition in float64: returns
    (chosen z, tree depth, diverged)."""

    def grad(x):
        return A @ x

    def pot(x):
        return 0.5 * x @ A @ x

    def kinetic(p):
        return 0.5 * np.sum(inv_mass * p * p)

    def turning(p_first, p_last, rho):
        v = inv_mass * rho
        return v @ p_first <= 0 or v @ p_last <= 0

    h0 = pot(z) + kinetic(p0)

    def build(x, p, g, d, height, j, sub):
        """Subtree of 2**height leaves from edge (x, p, g); ``sub`` holds the
        doubling's progressive sample and leaf counter.  Returns (edge x,
        p, g, p_first, p_last, rho, ok)."""
        if height == 0:
            i = sub["leaves"]
            sub["leaves"] += 1
            ph = p - 0.5 * d * eps * g
            xn = x + d * eps * inv_mass * ph
            gn = grad(xn)
            pn = ph - 0.5 * d * eps * gn
            h = pot(xn) + kinetic(pn)
            if np.isnan(h):
                h = np.inf
            log_w = h0 - h
            new_lsw = np.logaddexp(sub["lsw"], log_w)
            if math.log(leaf_u[j][i]) < log_w - new_lsw:
                sub["prop"] = xn
            sub["lsw"] = new_lsw
            if h - h0 > DELTA_MAX:
                sub["diverging"] = True
                return xn, pn, gn, pn, pn, pn, False
            return xn, pn, gn, pn, pn, pn, True
        x1, p1, g1, f1, l1, r1, ok1 = build(x, p, g, d, height - 1, j, sub)
        if not ok1:
            return x1, p1, g1, f1, l1, r1, False
        x2, p2, g2, f2, l2, r2, ok2 = build(x1, p1, g1, d, height - 1, j, sub)
        rho = r1 + r2
        if not ok2:
            return x2, p2, g2, f1, l2, rho, False
        return x2, p2, g2, f1, l2, rho, not turning(f1, l2, rho)

    left = right = (z, p0, grad(z))
    prop = z
    r_sum = p0.copy()
    log_sum_w = 0.0
    depth, diverged = 0, False
    for j in range(max_depth):
        d = dirs[j]
        edge = right if d > 0 else left
        sub = {"leaves": 0, "lsw": -np.inf, "prop": edge[0], "diverging": False}
        x, p, g, _, _, rho, ok = build(*edge, d, j, j, sub)
        depth += 1
        diverged = diverged or sub["diverging"]
        if not ok:
            break
        if math.log(tree_u[j]) < sub["lsw"] - log_sum_w:
            prop = sub["prop"]
        r_sum = r_sum + rho
        log_sum_w = np.logaddexp(log_sum_w, sub["lsw"])
        if d > 0:
            right = (x, p, g)
        else:
            left = (x, p, g)
        if turning(left[1], right[1], r_sum):
            break
    return prop, depth, diverged


@pytest.mark.parametrize("eps,max_depth", [(0.1, 10), (0.35, 10), (0.9, 10), (0.05, 3), (3.0, 10), (40.0, 10)],
                         ids=["eps0.1", "eps0.35", "eps0.9", "capped", "unstable", "diverging"])
def test_transition_matches_recursive_reference(eps, max_depth):
    C, D = 16, 2
    rng = np.random.default_rng(int(eps * 100) + max_depth)
    z = rng.normal(size=(C, D))
    inv_mass = rng.uniform(0.5, 2.0, size=(C, D))
    p0 = rng.normal(size=(C, D)) / np.sqrt(inv_mass)
    dirs = np.where(rng.uniform(size=(max_depth, C)) < 0.5, 1.0, -1.0)
    tree_u = rng.uniform(size=(max_depth, C))
    leaf_u = rng.uniform(size=(max_depth, 1 << (max_depth - 1), C))
    At = torch.tensor(A, dtype=torch.float32)

    def value_and_grad(v):
        return 0.5 * torch.einsum("ci,ij,cj->c", v, At, v), v @ At

    t = lambda a: torch.tensor(a, dtype=torch.float32)  # noqa: E731
    zt = t(z)
    u, g = value_and_grad(zt)
    counters = {}
    got_z, _, _, accept_stat, depth, diverged = nuts.nuts_transition(
        value_and_grad, zt, u, g, torch.full((C,), eps), t(inv_mass), t(p0), t(dirs), t(tree_u),
        lambda j, i: t(leaf_u[j, i]), max_depth, counters,
    )
    for c in range(C):
        ref_z, ref_depth, ref_div = _ref_transition(
            z[c], p0[c], eps, inv_mass[c], dirs[:, c], tree_u[:, c], leaf_u[:, :, c], max_depth
        )
        assert int(depth[c]) == ref_depth, (c, int(depth[c]), ref_depth)
        assert bool(diverged[c]) == ref_div, c
        np.testing.assert_allclose(got_z[c].numpy(), ref_z, rtol=1e-4, atol=1e-4)
    assert torch.all((accept_stat >= 0) & (accept_stat <= 1))
    # lockstep: every leaf is one replay of all chains, at most 2^depth - 1
    # of the deepest chain (fewer when every chain stops inside the last
    # subtree), and one host sync a leaf and a doubling at most
    assert int(depth.max()) <= counters["replays"] <= (1 << int(depth.max())) - 1
    assert counters["host_syncs"] <= counters["replays"] + max_depth
    if eps == 40.0:
        assert bool(diverged.all())
    if max_depth == 3:
        assert int(depth.max()) == 3


def test_trailing_ones():
    assert [nuts._trailing_ones(i) for i in range(8)] == [0, 1, 0, 2, 0, 1, 0, 3]


def test_nuts_gum_posterior():
    """tests/test_nuts.py:29-44 at 1,600 traces of 16 chains."""
    post = TorchGUM().posterior_results(1600, observe=OBSERVE, inference_engine=NUTS, num_chains=16)
    assert abs(float(post.mean) - POSTERIOR_MEAN) < 0.15
    assert abs(float(post.stddev) - POSTERIOR_STDDEV) < 0.15
    md = post.metadata[-1]
    assert 0.6 < md["acceptance_rate"] <= 1.0
    assert md["final_step_size"] > 0
    assert 1.0 <= md["mean_tree_depth"] <= md["max_tree_depth"]
    assert md["divergences"] >= 0 and md["num_chains"] == 16
    assert 1 <= md["replays_per_transition"] <= md["max_replays_per_transition"] < 1 << md["max_tree_depth"]
    assert md["host_syncs"] > 0


class UniformGUM(pp.Model):
    def forward(self):
        mu = pp.sample(Uniform(0.0, 20.0))
        lik = Normal(mu, math.sqrt(2.0))
        pp.observe(lik, name="obs0")
        pp.observe(lik, name="obs1")
        return mu


def test_nuts_bounded_support_and_knobs():
    """tests/test_nuts.py:100-126: the bounded support's posterior N(8.5, 1)
    (limits 0.2 at 1,600 traces, burn-in 100), and max_tree_depth /
    target_accept / step_size passing through."""
    post = UniformGUM().posterior_results(
        1600, observe=OBSERVE, inference_engine=NUTS, num_chains=16, max_tree_depth=6, target_accept=0.9,
        step_size=0.5, burn_in=100,
    )
    assert abs(float(post.mean) - 8.5) < 0.2
    assert abs(float(post.stddev) - 1.0) < 0.2
    vals = np.asarray(post.get_values(), dtype=np.float64)
    assert vals.min() > 0.0 and vals.max() < 20.0
    md = post.metadata[-1]
    assert md["max_tree_depth"] == 6 and md["max_replays_per_transition"] <= 63
