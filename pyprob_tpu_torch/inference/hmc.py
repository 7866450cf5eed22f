"""Hamiltonian Monte Carlo over the program's continuous latent sites, and
the base the gradient engines share (counterpart of
``pyprob_tpu/inference/hmc.py``).

Replaying ``forward`` with every controlled site substituted turns the
joint log-density into a function of the latents, and autograd
differentiates it through the program, distribution parameters that
depend on earlier sites included.  Latents live in UNCONSTRAINED space:
bounded supports (Uniform, TruncatedNormal, Beta with its low/high) map
through a scaled sigmoid, positive supports through exp, Pareto through
its scale times exp, Dirichlet through stick-breaking and LKJCholesky
through tanh partial correlations, with the log-Jacobians folded into the
potential.  Enumerable discrete sites (Categorical, Bernoulli) are
marginalized out of the potential (a logsumexp over the support grid) and
redrawn from their exact conditional p(d | z, obs) when the kept draws
are decoded; other discrete sites raise, pointing to LMH/RMH.

The JAX package writes each closure for one chain and ``vmap``s it.  Here
the potential of C chains is ONE batched replay of ``forward`` over the
``[C]`` chains (over ``[C·G]`` rows when G discrete combinations are
enumerated, then a logsumexp over G) under ``_TransformedReplayHandler``,
run with autograd on (the batched tier runs without it): the potential is
``[C]`` and ``torch.autograd.grad(potential.sum(), z)`` gives every
chain's gradient ``[C, D]`` at once, the chains being independent.  The
chain step is a Python loop of transitions over all C chains; each
leapfrog is one replay forward and backward, the acceptance a
``torch.where`` (no host sync a step).  On a card that replay is
host-bound, so its forward and backward are captured once as a CUDA graph
and replayed (``_FunctionalModel.value_and_grad``) where the potential
launches none of the hand-written kernels; one that does (GaussianMixture's
observe: kernels 1 and 1b; the GP's panel Cholesky: kernel 4) runs
eagerly, each launch through its wrapper.  Warmup is Stan's: dual-averaging
step-size adaptation (arXiv:1111.4246 §3.2) toward a target acceptance
and a diagonal mass matrix from Welford accumulation over the middle
warmup window, every value carrying the chain dimension (step sizes
``[C]``, inverse mass ``[C, D]``).

The flat latent vector's layout is the JAX package's ``ravel_pytree`` of
a dict: the continuous sites in sorted address order, each raveled in C
order, so the two packages' vectors are interchangeable.
"""

from __future__ import annotations

import math
import time
import warnings

import numpy as np
import torch
import torch.nn.functional as F

from .. import util
from ..distributions import (
    Bernoulli,
    Beta,
    Binomial,
    Categorical,
    Cauchy,
    Chi2,
    Dirichlet,
    Empirical,
    Exponential,
    Gamma,
    Geometric,
    Gumbel,
    HalfCauchy,
    HalfNormal,
    InverseGamma,
    Laplace,
    LKJCholesky,
    Logistic,
    LogNormal,
    Mixture,
    Multinomial,
    MultivariateNormal,
    NegativeBinomial,
    Normal,
    Pareto,
    Poisson,
    StudentT,
    TruncatedNormal,
    Uniform,
    VonMises,
    Weibull,
)
from ..distributions.empirical import values_of
from ..util import InferenceEngine, PriorInflation, TraceMode
from ..vectorized import (
    _BATCH_LIMIT,
    SiteRecord,
    VectorizedHandler,
    _materialize_traces,
    _run_batched,
    _skips_batched_tier,
    _TraceabilityCache,
    run_forward,
    run_traced,
)
from .mcmc import _empirical_of_kept, _host, _tree

_BOUNDED = (Uniform, TruncatedNormal, Beta)
_POSITIVE = (Exponential, Gamma, Weibull, LogNormal, HalfNormal, HalfCauchy, Chi2, InverseGamma)
_UNBOUNDED = (Normal, Laplace, StudentT, VonMises, MultivariateNormal, Mixture, Cauchy, Gumbel, Logistic)
# discrete families whose draws are float-typed here (integer-typed in the
# JAX package, whose dtype check refuses them)
_DISCRETE = (Poisson, Binomial, Geometric, NegativeBinomial, Multinomial)

_MAX_ENUMERATION = 1024

_NO_INTERPRETER_TIER = (
    "{engine} requires a model that runs on the batched tier (its gradients come from "
    "one replay of forward over the chains); model {name!r} does not run there, and "
    "{engine} has no interpreter tier. Use LMH/RMH or SMC instead."
)


def no_interpreter_tier(engine_name, model):
    """The error of a gradient engine on a model that does not run on the
    batched tier (the JAX package's "requires a jax-traceable model")."""
    return RuntimeError(_NO_INTERPRETER_TIER.format(engine=engine_name, name=model.name))


class Untraceable(Exception):
    """The structure probe found that the model does not run on the batched
    tier."""


def _mesh_later():
    return NotImplementedError(
        "mesh= (chains or draws over several cards) is not ported yet; it comes with the distributed slice"
    )


# ---------------------------------------------------------------------------
# transforms: every function takes and returns values with a leading [n]
# particle dimension; the log-Jacobians are summed to one per particle
# ---------------------------------------------------------------------------


def _per_row(x, like):
    """Sum ``x`` (broadcastable to ``like``'s shape [n, ...]) to one value
    a row, [n]."""
    return torch.broadcast_to(x, like.shape).reshape(like.shape[0], -1).sum(1)


def _stick_offsets(k, like):
    """Stan's stick-breaking offsets: z_i = 0 maps to the uniform simplex."""
    return -torch.log(torch.arange(k - 1, 0, -1, dtype=like.dtype, device=like.device))


def _simplex_to_x(z):
    """Stick-breaking: z [n, ..., K-1] unconstrained -> x [n, ..., K] on the
    simplex, plus log|dx/dz| [n] (Stan reference manual §10.7), in log
    space so tiny sticks stay finite."""
    k = z.shape[-1] + 1
    zs = z + _stick_offsets(k, z)
    log_u = F.logsigmoid(zs)
    log_1mu = F.logsigmoid(-zs)
    # log remainder before each stick: [0, cumsum(log(1-u))]
    log_rem = torch.cat([torch.zeros_like(z[..., :1]), torch.cumsum(log_1mu, -1)], -1)
    x = torch.cat([torch.exp(log_u + log_rem[..., :-1]), torch.exp(log_rem[..., -1:])], -1)
    return x, _per_row(log_u + log_1mu + log_rem[..., :-1], z)


def _simplex_to_z(x):
    """Inverse stick-breaking: x [n, ..., K] -> z [n, ..., K-1]."""
    k = x.shape[-1]
    head = x[..., :-1]
    rem = 1.0 - torch.cat([torch.zeros_like(x[..., :1]), torch.cumsum(head[..., :-1], -1)], -1)
    u = torch.clamp(head / torch.clamp(rem, min=1e-30), 1e-6, 1.0 - 1e-6)
    return torch.log(u) - torch.log1p(-u) - _stick_offsets(k, x)


def _chol_corr_to_x(z, d):
    """z [n, d(d-1)/2] -> the lower Cholesky factor L [n, d, d] of a
    correlation matrix through tanh canonical partial correlations (Stan
    manual §10.12), plus log|dL/dz| [n].  The index loops are static; each
    row is built out of place, so autograd sees every entry."""
    n = z.shape[0]
    zero = torch.zeros((n,), dtype=z.dtype, device=z.device)
    rows = [torch.stack([zero + 1.0] + [zero] * (d - 1), -1)]
    logdet = zero
    idx = 0
    for i in range(1, d):
        entries = []
        s = zero
        for _ in range(i):
            w = torch.tanh(z[:, idx])
            rem = torch.clamp(1.0 - s, min=1e-30)
            l = w * torch.sqrt(rem)
            # dL_ij/dz_idx = sqrt(rem) * sech^2 = sqrt(rem) * (1 - w^2)
            logdet = logdet + 0.5 * torch.log(rem) + torch.log1p(-(w * w))
            s = s + l * l
            entries.append(l)
            idx += 1
        diag = torch.sqrt(torch.clamp(1.0 - s, min=1e-30))
        rows.append(torch.stack(entries + [diag] + [zero] * (d - 1 - i), -1))
    return torch.stack(rows, -2), logdet


def _chol_corr_to_z(L, d):
    """Inverse: L [n, d, d] -> the [n, d(d-1)/2] unconstrained partial
    correlations."""
    out = []
    for i in range(1, d):
        s = torch.zeros_like(L[:, 0, 0])
        for j in range(i):
            rem = torch.clamp(1.0 - s, min=1e-30)
            w = torch.clamp(L[:, i, j] / torch.sqrt(rem), -1.0 + 1e-6, 1.0 - 1e-6)
            out.append(torch.atanh(w))
            s = s + L[:, i, j] * L[:, i, j]
    return torch.stack(out, -1)


def _unconstrained_shape(dist, x_shape):
    """Shape of a site's unconstrained image for one particle's value shape
    ``x_shape`` (simplex sites drop a dim; Cholesky-correlation sites ravel
    to d(d-1)/2)."""
    if isinstance(dist, Dirichlet):
        return tuple(x_shape[:-1]) + (x_shape[-1] - 1,)
    if isinstance(dist, LKJCholesky):
        if len(x_shape) != 2:
            raise NotImplementedError(
                "batched LKJCholesky sample sites are not supported in the "
                "gradient engines — sample one factor per site"
            )
        d = x_shape[-1]
        return (d * (d - 1) // 2,)
    return tuple(x_shape)


def _param(value, like):
    return util.to_tensor(value, like.device)


def _to_x(dist, z):
    """Unconstrained z [n, ...] -> support x [n, ...], plus log|dx/dz| [n]."""
    if isinstance(dist, Dirichlet):
        return _simplex_to_x(z)
    if isinstance(dist, LKJCholesky):
        return _chol_corr_to_x(z, dist.dim)
    if isinstance(dist, _BOUNDED):
        low, high = _param(dist.low, z), _param(dist.high, z)
        x = low + (high - low) * torch.sigmoid(z)
        logdet = torch.log(high - low) + F.logsigmoid(z) + F.logsigmoid(-z)
        return x, _per_row(logdet, x)
    if isinstance(dist, _POSITIVE):
        return torch.exp(z), _per_row(z, z)
    if isinstance(dist, Pareto):
        # lower-bounded at scale m > 0: x = m * exp(z)
        m = _param(dist.scale, z)
        x = m * torch.exp(z)
        return x, _per_row(z + torch.log(m), x)
    if isinstance(dist, _UNBOUNDED):
        return z, torch.zeros((z.shape[0],), dtype=z.dtype, device=z.device)
    raise NotImplementedError(
        f"HAMILTONIAN_MONTE_CARLO requires continuous sample sites; "
        f"{dist.name} is not supported — use LMH/RMH for discrete "
        f"latents."
    )


def _to_z(dist, x):
    """Support x [n, ...] -> unconstrained z [n, ...] (chain initialization)."""
    if isinstance(dist, Dirichlet):
        return _simplex_to_z(x)
    if isinstance(dist, LKJCholesky):
        return _chol_corr_to_z(x, dist.dim)
    if isinstance(dist, _BOUNDED):
        low, high = _param(dist.low, x), _param(dist.high, x)
        u = torch.clamp((x - low) / (high - low), 1e-6, 1.0 - 1e-6)
        return torch.log(u) - torch.log1p(-u)
    if isinstance(dist, _POSITIVE):
        return torch.log(torch.clamp(x, min=1e-30))
    if isinstance(dist, Pareto):
        m = _param(dist.scale, x)
        return torch.log(torch.clamp(x / m, min=1.0 + 1e-6))
    if isinstance(dist, _UNBOUNDED):
        return x
    raise NotImplementedError(dist.name)


# ---------------------------------------------------------------------------
# the transformed replay
# ---------------------------------------------------------------------------


class _TransformedReplayHandler(VectorizedHandler):
    """Replay every controlled site from unconstrained values (decode), or
    record the unconstrained image of given support values (encode), over
    ``num_particles`` rows.  ``replay`` maps each latent address to its
    ``[n, ...]`` values: unconstrained for continuous sites, support values
    when encoding, and the given integers for the enumerated discrete
    sites in ``discrete`` (no transform, no Jacobian; their density still
    enters ``log_prob_total``, so a logsumexp over a discrete grid
    marginalizes them exactly).  ``logdet`` [n] accumulates the
    transforms' log-Jacobians.  Nothing here detaches: under autograd the
    potential's gradient flows into the replayed values."""

    def __init__(self, num_particles, generator, observed, root_function_name, replay, encode=False,
                 likelihood_importance=1.0, discrete=frozenset()):
        super().__init__(
            num_particles=num_particles,
            generator=generator,
            trace_mode=TraceMode.POSTERIOR,
            inference_engine=InferenceEngine.IMPORTANCE_SAMPLING,
            observed=observed,
            root_function_name=root_function_name,
            likelihood_importance=likelihood_importance,
        )
        self._replay = replay
        self._encode = encode
        self._discrete = discrete
        self.logdet = torch.zeros((num_particles,), dtype=util.dtype(), device=self.device)
        self.z_values = {}

    def sample(self, distribution, name=None, address=None, control=True, mask=None):
        if name is not None and name in self.observed:
            return super().sample(distribution, name=name, address=address, control=control, mask=mask)
        if mask is not None:
            raise NotImplementedError(
                "sample(mask=) sites are not ported yet; they come with the Markov/SMC slice"
            )
        base, full, instance = self._make_address(address, distribution.address_suffix)
        if full not in self._replay:
            raise RuntimeError(
                f"the gradient engines' replay has no value for site {full}: the model met other "
                "sites than in its structure probe"
            )
        if full in self._discrete:
            value = self._replay[full]
        elif self._encode:
            value = self._replay[full]
            self.z_values[full] = _to_z(distribution, value)
        else:
            value, ld = _to_x(distribution, self._replay[full])
            self.logdet = self.logdet + ld
        log_prob = self._per_particle(distribution.log_prob(value))
        self.log_prob_total = self.log_prob_total + log_prob
        self._record(
            SiteRecord(
                address_base=base, address=full, instance=instance, name=name, control=True,
                observed=False, distribution=distribution,
            ),
            value,
            log_prob,
        )
        return value

    def rejection_sample(self, attempt_fn, max_attempts=None):
        raise NotImplementedError(
            "the gradient engines do not support rejection_sample blocks "
            "(the acceptance indicator makes the potential discontinuous)"
        )


def _run_transformed(model, num_particles, observed, replay, encode, likelihood_importance, args, kwargs,
                     discrete=frozenset(), generator=None):
    handler = _TransformedReplayHandler(
        num_particles,
        generator if generator is not None else util.generator(),
        observed,
        model.forward.__code__.co_name,
        replay,
        encode=encode,
        likelihood_importance=likelihood_importance,
        discrete=discrete,
    )
    result = run_forward(model, handler, args, kwargs)
    return result, handler


class _FunctionalModel:
    """The flat-latent-vector functions the gradient engines share, each
    over a leading ``[C]`` dimension of chains (or starts, or draws):

    potential(z [C, D], obs)        -> [C]: -log p(x(z), obs) - log|dx/dz|,
                                       enumerable discrete sites
                                       marginalized (logsumexp over G)
    potential_nojac(z, obs)         -> [C]: the same without the Jacobian
                                       (MAP's convention)
    value_and_grad(z, obs)          -> (potential [C], gradient [C, D])
    encode(C, obs, generator)       -> z [C, D] of C fresh prior draws
    decode(z [S, D], obs, ...)      -> the kept draws' outputs (results or
                                       traces); discrete sites drawn from
                                       their exact conditional
    plus dim, sites, num_combos (G, the enumerated discrete combinations;
    1 without discrete sites) and disc_addrs.
    """

    def __init__(self, **kw):
        for k, v in kw.items():
            setattr(self, k, v)
        # (z's shape, jac) -> captured graph of the potential and its
        # gradient on a card, or None where the potential is not captured
        self._graphs = {}

    def _eager_value_and_grad(self, z, obs, jac):
        with torch.enable_grad():
            z = z.detach().requires_grad_(True)
            u = (self.potential if jac else self.potential_nojac)(z, obs)
            (g,) = torch.autograd.grad(u.sum(), z)
        return u.detach(), g

    def value_and_grad(self, z, obs, jac=True):
        """(potential [C], its gradient [C, D]).  On a card the replay is
        host-bound (hundreds of small launches from Python a potential), so
        its forward and backward are captured once as a CUDA graph per
        (z's shape, jac, observation) and replayed: the same kernels on the
        same inputs, the same bits.  A potential that launches any of the
        hand-written kernels (``ops.counted_kernels``) is not captured and
        runs eagerly, so every launch of those passes through its wrapper
        and its count; so does one whose capture fails."""
        if not z.is_cuda:
            return self._eager_value_and_grad(z, obs, jac)
        key = (tuple(z.shape), jac)
        entry = self._graphs.get(key, False)
        if entry is False or (entry is not None and entry["obs"] is not obs):
            # the first call at this shape runs eagerly and decides
            before = _counted_launches()
            out = self._eager_value_and_grad(z, obs, jac)
            launched = _counted_launches() != before
            self._graphs[key] = None if launched else _capture_value_and_grad(self, z, obs, jac)
            return out
        if entry is None:
            return self._eager_value_and_grad(z, obs, jac)
        entry["z"].copy_(z)
        entry["graph"].replay()
        return entry["u"].clone(), entry["g"].clone()


def _counted_launches():
    from ..ops import counted_kernels

    return tuple(fn.launches for fn in counted_kernels().values())


def _capture_value_and_grad(fm, z, obs, jac):
    """A CUDA graph of ``fm``'s potential and gradient at inputs shaped as
    z (after an eager call, which made the constants the replay reads,
    ``util.to_tensor``, and one warm-up call on a side stream); None when
    the capture failed (the eager path)."""
    static_z = z.detach().clone()
    current = torch.cuda.current_stream(z.device)
    side = torch.cuda.Stream(device=z.device)
    side.wait_stream(current)
    with torch.cuda.stream(side):
        fm._eager_value_and_grad(static_z, obs, jac)
    current.wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.graph(graph):
            u, g = fm._eager_value_and_grad(static_z, obs, jac)
    except RuntimeError as e:
        util.log_print(f"[pyprob_tpu_torch] the potential was not captured as a CUDA graph ({e}); it runs eagerly")
        torch.cuda.synchronize(z.device)
        return None
    return {"graph": graph, "z": static_z, "u": u, "g": g, "obs": obs}


def _functionalize(model, observed, likelihood_importance, engine_name, args, kwargs, generator=None):
    """Probe the model once (two particles on the batched tier) and build
    its _FunctionalModel.  Continuous latents are transformed to
    unconstrained space and raveled into one flat D-vector; discrete
    latents with enumerable support (Categorical / Bernoulli, grid capped
    at _MAX_ENUMERATION combinations) are marginalized.  A model that does
    not run on the batched tier raises NotImplementedError from the probe
    (``Untraceable``; the callers mark its class and return None, and the
    entry points raise ``no_interpreter_tier``)."""
    generator = generator if generator is not None else util.generator()
    device = generator.device
    try:
        with torch.no_grad():
            probe, handler = run_traced(
                model, 2, observed, TraceMode.POSTERIOR, InferenceEngine.IMPORTANCE_SAMPLING,
                likelihood_importance=likelihood_importance, generator=generator, args=args, kwargs=kwargs,
            )
    except NotImplementedError as e:
        raise Untraceable(str(e)) from e
    sites = handler.sites
    latent_addrs = [s.address for s in sites if s.control and not s.observed]
    if not latent_addrs:
        raise RuntimeError(f"{engine_name} found no latent (controlled) sites")
    if any(getattr(s, "rejection", False) for s in sites):
        raise NotImplementedError(
            f"{engine_name} does not support rejection_sample blocks "
            "(the acceptance indicator makes the potential discontinuous); "
            "use IS/IC/SMC or interpreter-tier LMH/RMH instead."
        )
    values = probe["values"]
    shapes = {a: tuple(values[a].shape[1:]) for a in latent_addrs}
    cont_addrs, disc_addrs, disc_supports = [], [], {}
    dist_by_addr = {s.address: s.distribution for s in sites}
    for a in latent_addrs:
        dist = dist_by_addr[a]
        dt = values[a].dtype
        # enumerable discrete first: Bernoulli samples are float-dtyped
        if isinstance(dist, Categorical):
            disc_addrs.append(a)
            disc_supports[a] = int(dist.num_categories)
        elif isinstance(dist, Bernoulli):
            disc_addrs.append(a)
            disc_supports[a] = 2
        elif dt.is_floating_point and not isinstance(dist, _DISCRETE):
            cont_addrs.append(a)
        else:
            raise NotImplementedError(
                f"{engine_name} requires continuous or enumerable "
                f"(Categorical/Bernoulli) sample sites; {a} "
                f"({dist.name}) has dtype {dt} — use LMH/RMH "
                f"instead."
            )
    if not cont_addrs:
        raise RuntimeError(
            f"{engine_name} found no continuous latent sites (all-discrete "
            f"programs: use LMH/RMH or importance sampling)"
        )

    # enumeration grid over the product of discrete element supports
    grid, num_combos = None, 1
    if disc_addrs:
        elem_sizes = []
        for a in disc_addrs:
            elem_sizes.extend([disc_supports[a]] * int(np.prod(shapes[a], dtype=np.int64)))
        num_combos = int(np.prod(elem_sizes))
        if num_combos > _MAX_ENUMERATION:
            raise NotImplementedError(
                f"{engine_name}: {num_combos} discrete support combinations "
                f"exceed the enumeration cap ({_MAX_ENUMERATION}) — use "
                f"LMH/RMH instead."
            )
        meshes = np.meshgrid(*[np.arange(n) for n in elem_sizes], indexing="ij")
        flat_cols = [m.reshape(-1) for m in meshes]
        grid, e = {}, 0
        for a in disc_addrs:
            n_elem = int(np.prod(shapes[a], dtype=np.int64))
            cols = np.stack(flat_cols[e : e + n_elem], axis=-1).reshape((num_combos,) + shapes[a])
            grid[a] = torch.as_tensor(cols, device=device).to(values[a].dtype)
            e += n_elem
    discrete_set = frozenset(disc_addrs)

    # ravel_pytree's layout: sorted addresses, each raveled in C order
    layout, dim = [], 0
    for a in sorted(cont_addrs):
        zshape = _unconstrained_shape(dist_by_addr[a], shapes[a])
        size = int(np.prod(zshape, dtype=np.int64))
        layout.append((a, dim, size, zshape))
        dim += size

    def unravel(z):
        n = z.shape[0]
        return {a: z[:, off : off + size].reshape((n,) + zshape) for a, off, size, zshape in layout}

    def ravel(parts):
        n = next(iter(parts.values())).shape[0]
        return torch.cat([parts[a].reshape(n, size) for a, _, size, _ in layout], -1)

    root = model.forward.__code__.co_name

    def replay_rows(z, combos):
        """The replay dict of z [n, D] against every discrete combination:
        [n·G] rows, chain-major (row c·G + g)."""
        replay = unravel(z)
        if grid is None:
            return replay, z.shape[0]
        n = z.shape[0]
        replay = {a: v.repeat_interleave(num_combos, 0) for a, v in replay.items()}
        for a in disc_addrs:
            replay[a] = grid[a].repeat((n,) + (1,) * (grid[a].dim() - 1)) if combos is None else combos[a]
        return replay, n * (num_combos if combos is None else 1)

    def logjoint_rows(z, obs, jac=True):
        """[n, G] log joints (un-marginalized; G = 1 without discrete sites)."""
        replay, rows = replay_rows(z, None)
        _, handler = _run_transformed(
            model, rows, obs, replay, False, likelihood_importance, args, kwargs,
            discrete=discrete_set, generator=generator,
        )
        lj = handler.log_prob_total + handler.logdet if jac else handler.log_prob_total
        return lj.reshape(z.shape[0], num_combos)

    def potential(z, obs):
        lj = logjoint_rows(z, obs)
        return -(lj[:, 0] if grid is None else torch.logsumexp(lj, -1))

    def potential_nojac(z, obs):
        lj = logjoint_rows(z, obs, jac=False)
        return -(lj[:, 0] if grid is None else torch.logsumexp(lj, -1))

    def encode(num, obs, gen=None):
        gen = gen if gen is not None else generator
        with torch.no_grad():
            out, _ = run_traced(
                model, num, obs, TraceMode.POSTERIOR, InferenceEngine.IMPORTANCE_SAMPLING,
                likelihood_importance=likelihood_importance, generator=gen, args=args, kwargs=kwargs,
            )
            x = {a: out["values"][a] for a in latent_addrs}
            _, h = _run_transformed(
                model, num, obs, x, True, likelihood_importance, args, kwargs,
                discrete=discrete_set, generator=gen,
            )
            return ravel({a: h.z_values[a] for a in cont_addrs})

    def conditional_draws(z, obs, gen):
        """Each row's discrete combination drawn from p(d | z, obs) ∝
        exp(log joint(z, d)) (Gumbel-max over the grid), in chunks of at
        most _BATCH_LIMIT replay rows."""
        per = max(1, _BATCH_LIMIT // num_combos)
        picks = []
        with torch.no_grad():
            for b in range(0, z.shape[0], per):
                lj = logjoint_rows(z[b : b + per], obs)
                u = torch.rand(lj.shape, generator=gen, dtype=lj.dtype, device=lj.device)
                u = torch.clamp(u, min=torch.finfo(lj.dtype).tiny)
                picks.append(torch.argmax(lj - torch.log(-torch.log(u)), -1))
        gidx = torch.cat(picks)
        return {a: grid[a][gidx] for a in disc_addrs}

    def decode(z, obs, results_only, gen=None):
        """One batched replay of the draws z [S, D] (in chunks of at most
        _BATCH_LIMIT, as the batched tier runs): (outputs, dists, sites,
        sizes) as ``vectorized._run_batched`` returns them."""
        gen = gen if gen is not None else generator
        with torch.no_grad():
            replay = unravel(z)
            if grid is not None:
                replay.update(conditional_draws(z, obs, gen))

            def make_handler(n, begin, g, observed_):
                return _TransformedReplayHandler(
                    n, g, observed_, root, {a: v[begin : begin + n] for a, v in replay.items()},
                    likelihood_importance=likelihood_importance, discrete=discrete_set,
                )

            outputs, dists, sites_, _, sizes = _run_batched(
                model, z.shape[0], obs, TraceMode.POSTERIOR, InferenceEngine.IMPORTANCE_SAMPLING,
                PriorInflation.DISABLED, likelihood_importance, args=args, kwargs=kwargs,
                fetch=["result"] if results_only else None, make_handler=make_handler,
            )
        return outputs, dists, sites_, sizes

    return _FunctionalModel(
        potential=potential,
        potential_nojac=potential_nojac,
        encode=encode,
        decode=decode,
        dim=dim,
        sites=sites,
        num_combos=num_combos,
        disc_addrs=disc_addrs,
    )


def _decoded_empirical(fm, z, observed, map_func, results_only, file_name, log_weights=None,
                       effective_sample_size=None):
    """An Empirical of the decoded draws z [S, D]: one array of results
    (``posterior_results``), or the draws' traces mapped by ``map_func``,
    built as the batched tier builds them; uniform weights unless
    ``log_weights`` (float64 [S]) is given."""
    S = z.shape[0]
    lw = np.zeros(S) if log_weights is None else np.asarray(log_weights, np.float64)
    outputs, dists, sites, sizes = fm.decode(z, observed, results_only)
    if results_only:
        values = _tree(_host, outputs["result"])
        if not isinstance(values, np.ndarray):
            values = [_tree(lambda r: r[i], values) for i in range(S)]
    else:
        values = _materialize_traces(sites, outputs, dists, sizes)
        for tr, w in zip(values, lw):
            tr.log_importance_weight = float(w)
        if map_func is not None:
            values = [map_func(t) for t in values]
    values = values_of(values)
    if isinstance(values, np.ndarray):
        return Empirical.from_arrays(values, lw, effective_sample_size=effective_sample_size, file_name=file_name)
    return Empirical(values=values, log_weights=lw, effective_sample_size=effective_sample_size,
                     file_name=file_name)


# ---------------------------------------------------------------------------
# warmup: dual averaging and Welford, every value with a chain dimension
# ---------------------------------------------------------------------------

# dual-averaging constants (arXiv:1111.4246 §3.2, Stan defaults)
_DA_GAMMA = 0.05
_DA_T0 = 10.0
_DA_KAPPA = 0.75
_LOG_10 = math.log(10.0)


def _da_init(eps0):
    """(mu, log_eps, log_eps_bar, h_bar, m) dual-averaging state, each [C]."""
    log_eps0 = torch.log(eps0)
    zeros = torch.zeros_like(log_eps0)
    return (log_eps0 + _LOG_10, log_eps0, log_eps0, zeros, zeros)


def _da_update(da, alpha, target_accept):
    mu, log_eps, log_eps_bar, h_bar, m = da
    m = m + 1.0
    h_bar = (1.0 - 1.0 / (m + _DA_T0)) * h_bar + (target_accept - alpha) / (m + _DA_T0)
    log_eps = mu - torch.sqrt(m) / _DA_GAMMA * h_bar
    w = m ** (-_DA_KAPPA)
    log_eps_bar = w * log_eps + (1.0 - w) * log_eps_bar
    return (mu, log_eps, log_eps_bar, h_bar, m)


def _da_restart(da):
    """Restart averaging around the current step size (after a mass-matrix
    update the old average is for the wrong metric)."""
    _, log_eps, _, _, _ = da
    zeros = torch.zeros_like(log_eps)
    return (log_eps + _LOG_10, log_eps, log_eps, zeros, zeros)


def _welford_init(num_chains, dim, like):
    zeros = torch.zeros((num_chains, dim), dtype=like.dtype, device=like.device)
    return (torch.zeros((num_chains,), dtype=like.dtype, device=like.device), zeros, zeros)


def _welford_update(wf, z):
    n, mean, m2 = wf
    n = n + 1.0
    delta = z - mean
    mean = mean + delta / n[:, None]
    m2 = m2 + delta * (z - mean)
    return (n, mean, m2)


def _welford_variance(wf):
    """Regularized sample variance (Stan's shrinkage toward 1e-3)."""
    n, _, m2 = wf
    n = n[:, None]
    var = m2 / torch.clamp(n - 1.0, min=1.0)
    return torch.where(n > 1.0, (n / (n + 5.0)) * var + 1e-3 * (5.0 / (n + 5.0)), torch.ones_like(var))


def _warmup_adapt(da, wf, inv_mass, z, alpha, t, burn_in, target_accept):
    """One step of the shared warmup schedule: dual-averaging step size
    during burn-in, Welford mass accumulation over the middle warmup
    window, mass committed and averaging restarted at the window end.  The
    step ``t`` and ``burn_in`` are Python ints (the step loop is Python), so
    the JAX package's ``where``s are branches here.  One departure: with
    ``burn_in`` 0 (a resume) no mass is committed, where the JAX package
    commits the empty accumulator's variance (ones) at t = 0 and so drops
    the carried mass matrix.  Returns (da, wf, inv_mass)."""
    if t < burn_in:
        da = _da_update(da, alpha, target_accept)
    win_start, win_end = burn_in // 4, (3 * burn_in) // 4
    if win_start <= t < win_end:
        wf = _welford_update(wf, z)
    if t == win_end and burn_in > 0:
        inv_mass = _welford_variance(wf)
        da = _da_restart(da)
    return da, wf, inv_mass


class GradientChainState:
    """Warm-start snapshot of a gradient-engine run (HMC/NUTS): final
    unconstrained positions, the adapted diagonal mass matrix and the
    dual-averaged step size of every chain.  Returned as
    ``posterior.final_gradient_state`` and accepted via
    ``posterior(..., initial_trace=state)`` — resuming skips warmup
    (``burn_in`` defaults to 0) and rescoring against a CHANGED
    observation happens automatically (the potential/gradient at the
    stored positions are recomputed from the new observe values).
    Plain numpy arrays: pickles to disk."""

    def __init__(self, z, inv_mass, step_size, engine_name):
        # HMC/NUTS: z/inv_mass [C, D], step_size [C]
        self.z = np.asarray(z)
        self.inv_mass = np.asarray(inv_mass)
        self.step_size = np.asarray(step_size)
        self.engine_name = engine_name

    @property
    def num_chains(self):
        return int(self.z.shape[0])

    @property
    def dim(self):
        return int(self.z.shape[-1])

    def __repr__(self):
        return (
            f"GradientChainState({self.engine_name}, chains="
            f"{self.num_chains}, dim={self.dim}, mean step size "
            f"{float(np.mean(self.step_size)):.4g})"
        )


# ---------------------------------------------------------------------------
# the shared driver
# ---------------------------------------------------------------------------


def _gradient_mcmc_posterior(model, engine_name, engine_label, transition, target_accept, metadata_extra,
                             num_traces, observe, map_func, file_name, num_chains, burn_in, thinning_steps,
                             step_size, likelihood_importance, mesh, return_chains, args, kwargs,
                             initial_state=None, summarize=None):
    """Shared driver for the gradient-based chain engines (HMC, NUTS):
    resolve the chain geometry, run C chains of ``burn_in`` + kept
    transitions, decode the kept draws and materialize an Empirical (or
    per-chain Empiricals for ``return_chains``).  ``transition(fm, obs, z,
    u, g, eps, inv_mass, generator)`` advances every chain one step and
    returns (z, u, g, alpha [C], stats dict of [C] tensors to sum over the
    kept steps); ``summarize(sums, kept steps)``, when given, turns those
    sums into metadata.  ``initial_state``: a ``GradientChainState`` from a
    previous run's ``posterior.final_gradient_state``.  Returns None for a
    model that does not run on the batched tier (the caller raises)."""
    if mesh is not None:
        raise _mesh_later()
    if _skips_batched_tier(model, fallback=True):
        return None
    if not observe:
        raise RuntimeError(f"{engine_name} requires observe={{...}} values")
    if any(v is None for v in observe.values()):
        raise RuntimeError(f"Observe has missing value(s): {observe}")
    t0 = time.time()
    device = util.device()
    generator = util.generator(device)
    observed = {k: util.to_tensor(v, device) for k, v in observe.items()}
    if initial_state is not None:
        if num_chains is not None and num_chains != initial_state.num_chains:
            warnings.warn(
                f"num_chains={num_chains} ignored: the warm-start state "
                f"carries {initial_state.num_chains} chains."
            )
        num_chains = initial_state.num_chains
    elif num_chains is None:
        num_chains = int(min(max(1, num_traces // 256), 1024))
    C = int(num_chains)
    if burn_in is None:
        # warm start: the chains are already equilibrated and adapted
        burn_in = 0 if initial_state is not None else 200
    burn_in = int(burn_in)
    thinning_steps = 1 if thinning_steps is None else int(thinning_steps)
    step_size = 0.1 if step_size is None else float(step_size)
    keep_steps = -(-num_traces // C) * thinning_steps
    total_steps = burn_in + keep_steps
    results_only = getattr(map_func, "__name__", "") == "trace_result"

    try:
        fm = _functionalize(model, observed, likelihood_importance, engine_name, args, kwargs, generator)
    except Untraceable as e:
        util.log_print(f"[pyprob_tpu_torch] model {model.name!r} does not run on the batched tier ({e}); "
                       f"{engine_label} has no interpreter tier.")
        _TraceabilityCache.mark(model, False)
        return None
    _TraceabilityCache.mark(model, True)
    dim = fm.dim
    if initial_state is not None:
        if initial_state.dim != dim:
            raise RuntimeError(
                f"warm-start state has latent dim {initial_state.dim} "
                f"but the model's unconstrained space is {dim}-"
                f"dimensional"
            )
        if initial_state.z.ndim != 2:
            raise RuntimeError(
                f"warm-start state rank {initial_state.z.ndim} does "
                f"not fit {engine_name} (expects rank 2: HMC/NUTS carry [C, D]; "
                "PT carries a replica ladder [C, K, D])"
            )
        z = torch.as_tensor(initial_state.z, device=device).to(util.dtype())
        inv_mass = torch.as_tensor(initial_state.inv_mass, device=device).to(util.dtype())
        eps0 = torch.as_tensor(initial_state.step_size, device=device).to(util.dtype())
    else:
        z = fm.encode(C, observed)
        inv_mass = torch.ones((C, dim), dtype=util.dtype(), device=device)
        eps0 = torch.full((C,), step_size, dtype=util.dtype(), device=device)
    # the potential and gradient recompute here, so a changed observation
    # is rescored automatically
    u, g = fm.value_and_grad(z, observed)
    da = _da_init(eps0)
    wf = _welford_init(C, dim, z)
    acc_sum = torch.zeros((C,), dtype=util.dtype(), device=device)
    stat_sums = {}
    kept = []
    t_steps = time.time()
    for t in range(total_steps):
        # warmup uses the live step size; sampling uses the averaged one
        eps = torch.exp(da[1] if t < burn_in else da[2])
        z, u, g, alpha, stats = transition(fm, observed, z, u, g, eps, inv_mass, generator)
        da, wf, inv_mass = _warmup_adapt(da, wf, inv_mass, z, alpha, t, burn_in, target_accept)
        if t >= burn_in:
            acc_sum = acc_sum + alpha
            for k, v in stats.items():
                stat_sums[k] = stat_sums.get(k, 0) + v
            if (t - burn_in) % thinning_steps == 0:
                kept.append(z)
    final_eps = torch.exp(da[2])
    step_seconds = time.time() - t_steps
    post_steps = max(total_steps - burn_in, 1)
    stats = {
        "acceptance_rate": float(acc_sum.mean()) / post_steps,
        "final_step_size": float(final_eps.mean()),
    }
    if summarize is not None:
        stats.update(summarize(stat_sums, post_steps))
    final_state = GradientChainState(
        z=_host(z), inv_mass=_host(inv_mass), step_size=_host(final_eps), engine_name=engine_name,
    )
    # [kept, C, D] flattened step-major (index = step * C + chain)
    z_kept = torch.stack(kept).reshape(-1, dim)
    if return_chains:
        outputs, _, _, _ = fm.decode(z_kept, observed, True)
        results = _tree(_host, outputs["result"])
        steps_kept = len(kept)
        chains = []
        for c in range(C):
            vals = _tree(lambda r: r[c::C], results)
            chain = _empirical_of_kept(vals, steps_kept, None)
            chain.final_gradient_state = final_state
            chains.append(chain)
        return chains
    z_kept = z_kept[:num_traces]
    emp = _decoded_empirical(fm, z_kept, observed, map_func, results_only, file_name)
    emp.final_gradient_state = final_state
    accept_rate = stats["acceptance_rate"]
    duration = time.time() - t0
    emp.rename(
        f"Posterior, {engine_label} (batched, {C} chains), "
        f"samples: {emp.length:,}, acceptance: {accept_rate:.2f}"
    )
    emp.add_metadata(
        op="posterior",
        num_traces=num_traces,
        inference_engine=f"InferenceEngine.{engine_name}",
        num_chains=C,
        burn_in=burn_in,
        thinning_steps=thinning_steps,
        acceptance_rate=accept_rate,
        final_step_size=stats["final_step_size"],
        vectorized=True,
        step_seconds=step_seconds,
        transitions=C * total_steps,
        potential_graph=any(e is not None for e in fm._graphs.values()),
        **metadata_extra,
        **{k: v for k, v in stats.items() if k not in ("acceptance_rate", "final_step_size")},
    )
    if util.verbosity() > 1:
        extra = "".join(f", {k} {v:,.4g}" for k, v in stats.items() if k not in ("acceptance_rate", "final_step_size"))
        util.log_print(
            f"[{engine_label}] {emp.length:,} samples ({C} chains x {total_steps} steps) in "
            f"{duration:.3f}s ({C * total_steps / max(step_seconds, 1e-9):,.0f} transitions/s), "
            f"acceptance {accept_rate:.2f}{extra}"
        )
    return emp


# ---------------------------------------------------------------------------
# HMC
# ---------------------------------------------------------------------------


def hmc_transition(value_and_grad, z, u, g, eps, inv_mass, p0, uniform, leapfrog_steps):
    """One HMC transition of every chain, given its draws: the momentum p0
    [C, D] (~ N(0, M), M⁻¹ = ``inv_mass``) and the acceptance uniform
    [C].  ``value_and_grad(z)`` gives the potential [C] and its gradient
    [C, D]; each leapfrog is one call.  Returns (z, u, g, alpha [C],
    accepted [C]); a NaN energy error rejects."""
    eps = eps[:, None]

    def kinetic(p):
        return 0.5 * torch.sum(inv_mass * p * p, -1)

    p = p0 - 0.5 * eps * g
    zl, ul, gl = z, u, g
    for i in range(leapfrog_steps):
        zl = zl + eps * inv_mass * p
        ul, gl = value_and_grad(zl)
        scale = 0.5 * eps if i == leapfrog_steps - 1 else eps
        p = p - scale * gl
    log_alpha = (u - ul) + (kinetic(p0) - kinetic(p))
    log_alpha = torch.where(torch.isnan(log_alpha), torch.full_like(log_alpha, -math.inf), log_alpha)
    accept = torch.log(uniform) < log_alpha
    z = torch.where(accept[:, None], zl, z)
    u = torch.where(accept, ul, u)
    g = torch.where(accept[:, None], gl, g)
    alpha = torch.clamp(torch.exp(log_alpha), max=1.0)
    return z, u, g, alpha, accept


def vectorized_hmc_posterior(model, num_traces, observe=None, map_func=None, file_name=None, num_chains=None,
                             burn_in=None, thinning_steps=None, leapfrog_steps=None, target_accept=None,
                             step_size=None, likelihood_importance=1.0, mesh=None, return_chains=False,
                             initial_state=None, args=(), kwargs=None):
    """HMC posterior: C parallel chains on the batched tier.  Returns an
    Empirical of ``num_traces`` (uniform-weight) samples with
    acceptance-rate metadata (and ``final_gradient_state`` for warm
    resumes), or None if the model does not run on the batched tier (HMC
    has no interpreter tier)."""
    leapfrog_steps = 10 if leapfrog_steps is None else int(leapfrog_steps)
    target_accept = 0.75 if target_accept is None else float(target_accept)

    def transition(fm, obs, z, u, g, eps, inv_mass, generator):
        C, D = z.shape
        p0 = torch.randn((C, D), generator=generator, dtype=z.dtype, device=z.device) / torch.sqrt(inv_mass)
        uniform = torch.rand((C,), generator=generator, dtype=z.dtype, device=z.device)
        z, u, g, alpha, _ = hmc_transition(
            lambda v: fm.value_and_grad(v, obs), z, u, g, eps, inv_mass, p0, uniform, leapfrog_steps
        )
        return z, u, g, alpha, {}

    return _gradient_mcmc_posterior(
        model=model,
        engine_name="HAMILTONIAN_MONTE_CARLO",
        engine_label="HMC",
        transition=transition,
        target_accept=target_accept,
        metadata_extra={"leapfrog_steps": leapfrog_steps},
        num_traces=num_traces,
        observe=observe,
        map_func=map_func,
        file_name=file_name,
        num_chains=num_chains,
        burn_in=burn_in,
        thinning_steps=thinning_steps,
        step_size=step_size,
        likelihood_importance=likelihood_importance,
        mesh=mesh,
        return_chains=return_chains,
        args=args,
        kwargs=kwargs,
        initial_state=initial_state,
    )
