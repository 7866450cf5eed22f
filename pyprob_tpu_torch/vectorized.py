"""Batched execution tier: N particles per ``forward`` call.

Counterpart of ``pyprob_tpu/vectorized.py``.  The JAX package traces
``forward`` once under ``jax.vmap``; here ``forward`` runs once per chunk
of particles with a handler installed in ``state`` that draws an explicit
``[N]`` tensor at every ``sample`` site and accumulates ``[N]`` log-weights
on the device.  Data-dependent Python control flow on those tensors fails
as it fails under ``vmap``, and such models raise (the interpreter tier
that would run them is not ported yet).  Rejection loops written with
``rejection_sample`` do run here: the block becomes a masked retry loop
over the batch (``VectorizedHandler.rejection_sample``).  Results stay on
the device until the end of a run; the ESS and log Z of a result come from
the ``log_weight_stats`` kernel over the run's ``[N]`` log-weights.
"""

from __future__ import annotations

import math
import time
import warnings

import numpy as np
import torch

from . import state, util
from .address import extract_address
from .distributions import Categorical, Empirical, Normal
from .ops import kernels
from .trace import Trace, Variable
from .util import InferenceEngine, PriorInflation, TraceMode

_INTERPRETER_LATER = (
    "the interpreter tier (one trace at a time on the host) is not ported "
    "yet; it comes with the interpreter slice"
)

# Particles per forward call.  Bounds device memory: at lstm_dim 512 the
# LSTM gates of one chunk are [2^18, 2048] float32, 2 GiB.
_BATCH_LIMIT = 1 << 18

# Learned per-model chunk caps after a device OOM (keyed by model
# identity, as in the JAX package): programs that are heavy per particle
# (an [N, N] Cholesky per particle) exhaust device memory far below
# _BATCH_LIMIT; once a size fails, later calls start from the working cap.
_oom_batch_limit = {}

_REJECTION_MAX_ATTEMPTS = 64
# mixture weight on the learned proposal for rejection-retry attempts
# (defensive importance sampling, Hesterberg 1995)
_REJECTION_DEFENSIVE_PI = 0.5


def _draw(distribution, n, generator):
    """One draw per particle: [n] values from a scalar or [n]-batched
    distribution."""
    shape = (n,) if distribution.batch_shape == () else ()
    return distribution._sample(generator, shape)


class SiteRecord:
    """Host-side record of one sample/observe site met while running
    ``forward``."""

    __slots__ = (
        "address_base",
        "address",
        "instance",
        "name",
        "control",
        "observed",
        "distribution",
        "rejection",  # True for sites inside a rejection_sample block
    )

    def __init__(self, **kw):
        for k in self.__slots__:
            setattr(self, k, kw.get(k))


class VectorizedHandler:
    """Effect handler active while ``forward`` runs over a particle batch."""

    def __init__(
        self,
        num_particles,
        generator,
        trace_mode,
        inference_engine,
        observed,
        root_function_name,
        prior_inflation=PriorInflation.DISABLED,
        likelihood_importance=1.0,
        proposal_step=None,
    ):
        self.n = num_particles
        self.generator = generator
        self.device = generator.device
        self.trace_mode = trace_mode
        self.inference_engine = inference_engine
        self.observed = observed or {}
        self.root_function_name = root_function_name
        self.prior_inflation = prior_inflation
        self.likelihood_importance = likelihood_importance
        self.proposal_step = proposal_step
        if proposal_step is not None:
            proposal_step.reset(num_particles)
        self.sites = []
        self.values = []
        self.log_probs = []
        self.instance_counts = {}
        self.rejection_rounds = []  # attempts run by each rejection block
        zeros = lambda: torch.zeros(  # noqa: E731
            (num_particles,), dtype=util.dtype(), device=self.device
        )
        self.log_importance_weight = zeros()
        self.log_prob_observed = zeros()
        self.log_prob_total = zeros()

    def _make_address(self, address, suffix):
        if address is None:
            base = extract_address(self.root_function_name) + "__" + suffix
        else:
            base = address + "__" + suffix
        instance = self.instance_counts.get(base, 0) + 1
        self.instance_counts[base] = instance
        return base, base + "__" + str(instance), instance

    def _per_particle(self, log_prob):
        """A site's log-density as one [n] value per particle."""
        if log_prob.dim() > 1:
            log_prob = log_prob.reshape(self.n, -1).sum(dim=1)
        return log_prob.expand(self.n)

    def _inflate(self, distribution):
        if self.prior_inflation == PriorInflation.ENABLED:
            if isinstance(distribution, Categorical):
                n = distribution.num_categories
                return Categorical(
                    probs=torch.full((n,), 1.0 / n, dtype=util.dtype(), device=self.device)
                )
            if isinstance(distribution, Normal):
                return Normal(distribution.mean, distribution.stddev * 3)
        return None

    def _is_weighted(self):
        return self.inference_engine in (
            InferenceEngine.IMPORTANCE_SAMPLING,
            InferenceEngine.IMPORTANCE_SAMPLING_WITH_INFERENCE_NETWORK,
        )

    def _record(self, site, value, log_prob):
        self.sites.append(site)
        self.values.append(value)
        self.log_probs.append(log_prob)

    def _per_particle_value(self, distribution, value):
        """An observed value as one row per particle (a trace takes row i).
        A value with no dims beyond the distribution's event dims is the
        same for every particle and becomes a [n, ...] view; one with a
        leading particle dim (computed from latents) is kept as it is."""
        if value.dim() > len(distribution.event_shape):
            return value
        return value.expand((self.n,) + tuple(value.shape))

    def sample(self, distribution, name=None, address=None, control=True, mask=None):
        if mask is not None:
            raise NotImplementedError(
                "sample(mask=) sites are not ported yet; they come with the "
                "Markov/SMC slice"
            )
        base, full, instance = self._make_address(address, distribution.address_suffix)
        site = SiteRecord(
            address_base=base,
            address=full,
            instance=instance,
            name=name,
            control=control,
            observed=False,
            distribution=distribution,
        )
        if name is not None and name in self.observed:
            value = util.to_tensor(self.observed[name], self.device)
            log_prob = self.likelihood_importance * self._per_particle(
                distribution.log_prob(value)
            )
            if self._is_weighted():
                self.log_importance_weight = self.log_importance_weight + log_prob
            self.log_prob_observed = self.log_prob_observed + log_prob
            self.log_prob_total = self.log_prob_total + log_prob
            site.control, site.observed = False, True
            self._record(site, self._per_particle_value(distribution, value), log_prob)
            return value

        if control and self._ic_proposals():
            value, proposal_log_prob = self.proposal_step(
                site, distribution, self.generator, self.observed
            )
            log_prob = self._per_particle(distribution.log_prob(value))
            self.log_importance_weight = (
                self.log_importance_weight + log_prob - proposal_log_prob
            )
            self.log_prob_total = self.log_prob_total + log_prob
            self._record(site, value, log_prob)
            return value

        inflated = self._inflate(distribution) if control else None
        proposal = inflated if inflated is not None else distribution
        value = _draw(proposal, self.n, self.generator)
        log_prob = self._per_particle(distribution.log_prob(value))
        if inflated is not None:
            self.log_importance_weight = (
                self.log_importance_weight
                + log_prob
                - self._per_particle(inflated.log_prob(value))
            )
        if control:
            self.log_prob_total = self.log_prob_total + log_prob
        self._record(site, value, log_prob)
        return value

    def observe(self, distribution, value=None, name=None, address=None):
        base, full, instance = self._make_address(address, distribution.address_suffix)
        site = SiteRecord(
            address_base=base,
            address=full,
            instance=instance,
            name=name,
            control=False,
            observed=True,
            distribution=distribution,
        )
        if name is not None and name in self.observed:
            value = util.to_tensor(self.observed[name], self.device)
        elif value is not None:
            value = util.to_tensor(value, self.device)
        elif self.trace_mode == TraceMode.PRIOR_FOR_INFERENCE_NETWORK:
            value = _draw(distribution, self.n, self.generator)
        if value is None:
            site.observed = False
            self._record(site, None, None)
            return None
        log_prob = self.likelihood_importance * self._per_particle(
            distribution.log_prob(value)
        )
        if self._is_weighted():
            self.log_importance_weight = self.log_importance_weight + log_prob
        self.log_prob_observed = self.log_prob_observed + log_prob
        self.log_prob_total = self.log_prob_total + log_prob
        self._record(site, self._per_particle_value(distribution, value), log_prob)
        return value

    def factor(self, log_prob=None, log_prob_func=None, name=None, address=None, mask=None):
        raise NotImplementedError(
            "factor is not ported yet; it comes with the distributions slice "
            "(the Factor distribution)"
        )

    def tag(self, value, name=None, address=None):
        raise NotImplementedError(
            "tag sites are not ported yet; they come with the interpreter slice"
        )

    def _ic_proposals(self):
        return (
            self.trace_mode == TraceMode.POSTERIOR
            and self.inference_engine
            == InferenceEngine.IMPORTANCE_SAMPLING_WITH_INFERENCE_NETWORK
            and self.proposal_step is not None
        )

    def rejection_sample(self, attempt_fn, max_attempts=None):
        """The block as a masked retry loop over the ``[n]`` particles,
        with replacement semantics: every attempt restarts the instance
        counts from the pre-block snapshot, so the block's sites keep
        instance 1, and a lane still pending at the start of a round takes
        that round's values, log-densities, distribution parameters and
        outputs.  Each round runs every lane; rounds repeat while a lane is
        pending, up to ``max_attempts`` (default 64), after which a pending
        lane's weight is −inf.

        The first attempt alone may propose from the learned network.
        Under guided IS, retries restart the proposal network from the
        pre-block state (training saw only accepted attempts) and propose
        from the defensive mixture π·q + (1−π)·prior (π = 0.5), which caps
        a rejected attempt's weight factor at 1/(1−π); each lane then
        continues from the network state its accepted attempt left.  The
        importance weight takes log p − log q of every attempt a lane
        executed, accepted or not: exact by the extended-space argument
        (the target and the proposal processes both define densities over
        the sequence of executed attempts, with ratio Π p(x_i)/q(x_i))."""
        max_attempts = int(max_attempts) if max_attempts else _REJECTION_MAX_ATTEMPTS
        base_counts = dict(self.instance_counts)
        step = self.proposal_step
        ic_retry = self._ic_proposals() and all(
            hasattr(step, a) for a in ("get_state", "set_state", "select_state")
        )
        defensive = (
            _REJECTION_DEFENSIVE_PI
            if ic_retry and getattr(step, "supports_defensive", False)
            else None
        )
        s0 = step.get_state() if ic_retry else None

        def run_attempt(use_proposal, defensive=None):
            sub = _RejectionAttemptHandler(self, base_counts, use_proposal, defensive)
            prev = state._set_handler(sub)
            try:
                out, accept = attempt_fn()
            finally:
                state._set_handler(prev)
            accept = torch.as_tensor(accept, device=self.device).to(torch.bool)
            return out, accept.expand(self.n), sub

        out, accept, sub0 = run_attempt(use_proposal=True)
        if not sub0.sites:
            raise RuntimeError("rejection_sample block contains no sample sites")
        for iw in sub0.log_iws:
            if iw is not None:
                self.log_importance_weight = self.log_importance_weight + iw
        self.instance_counts = dict(sub0.instance_counts)
        addresses = [s.address for s in sub0.sites]
        values, log_probs = list(sub0.values), list(sub0.log_probs)
        dists = [s.distribution for s in sub0.sites]
        pstate = step.get_state() if ic_retry else None
        rounds = 1
        pending = ~accept
        # one host sync per round: whether any lane is still pending
        while rounds < max_attempts and bool(pending.any()):
            if ic_retry:
                step.set_state(s0)
            o, acc, sub = run_attempt(use_proposal=ic_retry, defensive=defensive)
            if [s.address for s in sub.sites] != addresses:
                raise RuntimeError(
                    "rejection_sample attempts must meet the same sample sites "
                    "on the batched tier"
                )
            for iw in sub.log_iws:
                if iw is not None:
                    self.log_importance_weight = self.log_importance_weight + torch.where(
                        pending, iw, torch.zeros_like(iw)
                    )
            out = _select(pending, o, out)
            values = [_select(pending, a, b) for a, b in zip(sub.values, values)]
            log_probs = [_select(pending, a, b) for a, b in zip(sub.log_probs, log_probs)]
            dists = [
                _select_distribution(pending, s.distribution, d)
                for s, d in zip(sub.sites, dists)
            ]
            if ic_retry:
                pstate = step.select_state(pending, step.get_state(), pstate)
            accept = accept | (pending & acc)
            pending = pending & ~acc
            rounds += 1
        self.rejection_rounds.append(rounds)
        self.log_importance_weight = torch.where(
            accept, self.log_importance_weight,
            torch.full_like(self.log_importance_weight, -math.inf),
        )
        if ic_retry:
            step.set_state(pstate)
        for site, value, lp, dist in zip(sub0.sites, values, log_probs, dists):
            site.distribution = dist
            if site.control:
                self.log_prob_total = self.log_prob_total + lp
            self._record(site, value, lp)
        return out


def _select(mask, new, old):
    """Per lane, ``new`` where ``mask`` [n] holds, else ``old``: tensors
    with the lanes on their first dimension (0-d ones broadcast), or
    tuples, lists and dicts of them."""
    if isinstance(new, (tuple, list)):
        return type(new)(_select(mask, a, b) for a, b in zip(new, old))
    if isinstance(new, dict):
        return {k: _select(mask, new[k], old[k]) for k in new}
    new = torch.as_tensor(new, device=mask.device)
    old = torch.as_tensor(old, device=mask.device)
    dim = max(new.dim(), old.dim(), 1)
    return torch.where(mask.reshape((-1,) + (1,) * (dim - 1)), new, old)


def _select_distribution(mask, new, old):
    """A site's distribution with per-lane parameters: ``new``'s where
    ``mask`` holds, else ``old``'s (the parameters may depend on earlier
    sites of the block)."""
    if new is old:
        return new
    if type(new) is not type(old) or not type(new)._param_names:
        raise NotImplementedError(
            f"per-lane parameters of {type(new).__name__} inside a "
            "rejection_sample block are not supported on the batched tier"
        )
    leaves = []
    for a, b in zip(new._leaves(), old._leaves()):
        # a parameter shared by every lane gains a lane dimension
        a = a.unsqueeze(0) if new.batch_shape == () else a
        b = b.unsqueeze(0) if old.batch_shape == () else b
        leaves.append(_select(mask, a, b))
    return type(new)._rebuild(leaves)


class _RejectionAttemptHandler:
    """Handler installed while one attempt of a rejection block runs.  It
    records the attempt's sites, values, log-densities and weight terms
    without touching the outer handler's accumulators; the outer
    ``rejection_sample`` selects and commits them per lane."""

    _make_address = VectorizedHandler._make_address

    def __init__(self, outer, base_counts, use_proposal, defensive=None):
        self.outer = outer
        self.root_function_name = outer.root_function_name
        self.instance_counts = dict(base_counts)
        self.use_proposal = use_proposal
        self.defensive = defensive  # mixture weight on q for retry proposals
        self.sites = []
        self.values = []
        self.log_probs = []
        self.log_iws = []

    def sample(self, distribution, name=None, address=None, control=True, mask=None):
        outer = self.outer
        if mask is not None:
            raise RuntimeError(
                "sample(mask=) inside rejection_sample is not supported "
                "(the block's acceptance indicator already gates attempts)"
            )
        if name is not None and name in outer.observed:
            raise RuntimeError(
                "observed sample sites inside rejection_sample are not supported"
            )
        base, full, instance = self._make_address(address, distribution.address_suffix)
        site = SiteRecord(
            address_base=base,
            address=full,
            instance=instance,
            name=name,
            control=control,
            observed=False,
            distribution=distribution,
            rejection=True,
        )
        log_iw = None
        if self.use_proposal and control and outer._ic_proposals():
            kwargs = {} if self.defensive is None else {"defensive": self.defensive}
            value, proposal_log_prob = outer.proposal_step(
                site, distribution, outer.generator, outer.observed, **kwargs
            )
            lp = outer._per_particle(distribution.log_prob(value))
            log_iw = lp - proposal_log_prob
        else:
            inflated = outer._inflate(distribution) if (self.use_proposal and control) else None
            proposal = inflated if inflated is not None else distribution
            value = _draw(proposal, outer.n, outer.generator)
            lp = outer._per_particle(distribution.log_prob(value))
            if inflated is not None:
                log_iw = lp - outer._per_particle(inflated.log_prob(value))
        self.sites.append(site)
        self.values.append(value)
        self.log_probs.append(lp)
        self.log_iws.append(log_iw)
        return value

    def observe(self, distribution, value=None, name=None, address=None):
        raise RuntimeError("observe/factor inside rejection_sample is not supported")

    def factor(self, log_prob=None, log_prob_func=None, name=None, address=None, mask=None):
        raise RuntimeError("observe/factor inside rejection_sample is not supported")

    def tag(self, value, name=None, address=None):
        raise RuntimeError("tag inside rejection_sample is not supported")

    def rejection_sample(self, attempt_fn, max_attempts=None):
        raise RuntimeError("nested rejection_sample is not supported on the batched tier")


def run_traced(
    model,
    num_particles,
    observed,
    trace_mode,
    inference_engine,
    prior_inflation=PriorInflation.DISABLED,
    likelihood_importance=1.0,
    proposal_step=None,
    generator=None,
    args=(),
    kwargs=None,
):
    """Run ``forward`` once over ``num_particles`` particles under the
    batched handler; returns (outputs, handler).  Outputs hold [n] device
    tensors keyed as the JAX package's."""
    handler = VectorizedHandler(
        num_particles=num_particles,
        generator=generator if generator is not None else util.generator(),
        trace_mode=trace_mode,
        inference_engine=inference_engine,
        observed=observed,
        root_function_name=model.forward.__code__.co_name,
        prior_inflation=prior_inflation,
        likelihood_importance=likelihood_importance,
        proposal_step=proposal_step,
    )
    prev = state._set_handler(handler)
    try:
        result = model.forward(*args, **(kwargs or {}))
    except RuntimeError as e:
        msg = str(e)
        if "ambiguous" in msg or "cannot be converted to Scalar" in msg:
            raise NotImplementedError(
                f"model {model.name!r} branches on sampled values, so it does "
                f"not run on the batched tier, and {_INTERPRETER_LATER}"
            ) from e
        raise
    finally:
        state._set_handler(prev)
    if isinstance(result, torch.Tensor):
        result = result.expand(num_particles) if result.dim() == 0 else result
    outputs = {
        "result": result,
        "log_importance_weight": handler.log_importance_weight,
        "log_prob_observed": handler.log_prob_observed,
        "log_prob_total": handler.log_prob_total,
        "values": {
            s.address: v.expand(num_particles) if v.dim() == 0 else v
            for s, v in zip(handler.sites, handler.values)
            if v is not None
        },
        "log_probs": {
            s.address: lp
            for s, lp in zip(handler.sites, handler.log_probs)
            if lp is not None
        },
    }
    return outputs, handler


@torch.no_grad()
def run_training_batch(model, batch_size, prior_inflation=PriorInflation.DISABLED):
    """A training batch for the IC training loop: one ``run_traced`` of
    ``batch_size`` traces in ``PRIOR_FOR_INFERENCE_NETWORK`` mode (observes
    draw their values), outputs left on the device as ``[B]`` tensors (no
    trace materialization).  Returns (outputs, sites); each site record
    holds its distribution with the batch's parameters."""
    outputs, handler = run_traced(
        model,
        batch_size,
        {},
        TraceMode.PRIOR_FOR_INFERENCE_NETWORK,
        InferenceEngine.IMPORTANCE_SAMPLING,
        prior_inflation,
    )
    return outputs, handler.sites


def _run_batched(
    model,
    num_traces,
    observed,
    trace_mode,
    inference_engine,
    prior_inflation,
    likelihood_importance,
    proposal_step=None,
    args=(),
    kwargs=None,
    fetch=None,
):
    """Run ``forward`` over chunks of at most ``_BATCH_LIMIT`` particles;
    returns the outputs concatenated to ``num_traces`` on the device
    (only the ``fetch`` keys, when given), the per-chunk distributions of
    each site, the site list, per chunk the rounds its rejection blocks
    ran (summed over the blocks; empty without blocks), and the chunk
    sizes.  A chunk that runs out of device memory is retried at half its
    size (down to one particle, where the error is raised), and the size
    that worked caps this model's later chunks (``_oom_batch_limit``), as
    the JAX package backs off; the run stays on the device."""
    device = util.device()
    observed = {
        k: util.to_tensor(v, device) for k, v in (observed or {}).items()
    }
    generator = util.generator(device)
    chunks, dists, sites, rounds, sizes = [], [], None, [], []
    limit = min(_BATCH_LIMIT, _oom_batch_limit.get(id(model), _BATCH_LIMIT))
    remaining = num_traces
    while remaining > 0:
        n = min(remaining, limit)
        try:
            out, handler = run_traced(
                model, n, observed, trace_mode, inference_engine, prior_inflation,
                likelihood_importance, proposal_step=proposal_step,
                generator=generator, args=args, kwargs=kwargs,
            )
        except torch.cuda.OutOfMemoryError:
            if n <= 1:
                raise
            out = None
        if out is None:
            # outside the except block: the error's traceback holds the
            # failed chunk's tensors until the block is left
            limit = max(1, n // 2)
            _oom_batch_limit[id(model)] = limit
            warnings.warn(
                f"device OOM at {n} particles/dispatch; retrying with chunks of {limit}"
            )
            torch.cuda.empty_cache()
            continue
        sizes.append(n)
        if fetch is not None:
            out = {k: out[k] for k in fetch}
        else:
            dists.append([s.distribution for s in handler.sites])
        chunks.append(out)
        if handler.rejection_rounds:
            rounds.append(sum(handler.rejection_rounds))
        if sites is None:
            sites = handler.sites
        remaining -= n
    outputs = chunks[0] if len(chunks) == 1 else _concat(chunks)
    return outputs, dists, sites, rounds, sizes


def _concat(chunks):
    first = chunks[0]
    if isinstance(first, dict):
        return {k: _concat([c[k] for c in chunks]) for k in first}
    if isinstance(first, torch.Tensor):
        return torch.cat(chunks, dim=0)
    raise TypeError(
        f"forward() returned {type(first).__name__}; the batched tier "
        "concatenates tensors and dicts of tensors"
    )


def _host(x):
    return x.detach().cpu().numpy()


def _site_leaves(per_chunk, sizes):
    """A site's distribution parameters on the host, one row per trace:
    batched leaves are concatenated over chunks, shared ones repeated.  A
    leaf is batched when it has batch dims (dims beyond its parameter's
    event dims) and the distribution a batch shape."""
    leaves = []
    for j, ls in enumerate(zip(*[d._leaves() for d in per_chunk])):
        rows = []
        for d, leaf, c in zip(per_chunk, ls, sizes):
            leaf = leaf.detach().cpu()
            event_dims = d._param_event_dims[j] if d._param_event_dims else 0
            batched = d.batch_shape != () and leaf.dim() > event_dims
            rows.append(
                leaf.expand((c,) + tuple(leaf.shape[1:]))
                if batched
                else leaf.expand((c,) + tuple(leaf.shape))
            )
        leaves.append(torch.cat(rows))
    return leaves


def _materialize_traces(sites, outputs, dists, sizes):
    """Per-trace ``Trace`` objects from the batched outputs (only when the
    caller asks for traces, not results); ``sizes`` are the chunk sizes
    the run took."""
    num = sum(sizes)
    values = {a: _host(v) for a, v in outputs["values"].items()}
    log_probs = {a: _host(v) for a, v in outputs["log_probs"].items()}
    results = _host(outputs["result"])
    lw = _host(outputs["log_importance_weight"]).astype(np.float64)
    lp_obs = _host(outputs["log_prob_observed"])
    lp_total = _host(outputs["log_prob_total"])
    leaves = [
        _site_leaves([chunk[j] for chunk in dists], sizes)
        if s.distribution._param_names
        else None
        for j, s in enumerate(sites)
    ]
    traces = []
    for i in range(num):
        tr = Trace()
        for j, s in enumerate(sites):
            v = values.get(s.address)
            lp = log_probs.get(s.address)
            dist = (
                None
                if leaves[j] is None
                else type(s.distribution)._rebuild([leaf[i] for leaf in leaves[j]])
            )
            tr.add(
                Variable(
                    distribution=dist,
                    value=None if v is None else v[i],
                    address_base=s.address_base,
                    address=s.address,
                    instance=s.instance,
                    log_prob=None if lp is None else lp[i],
                    control=s.control,
                    name=s.name,
                    observed=s.observed,
                )
            )
        tr.end(results[i], None)
        tr.log_importance_weight = float(lw[i])
        tr.log_prob_observed = lp_obs[i]
        tr.log_prob = lp_total[i]
        traces.append(tr)
    return traces


@torch.no_grad()
def vectorized_traces(
    model,
    num_traces,
    trace_mode,
    inference_engine=InferenceEngine.IMPORTANCE_SAMPLING,
    prior_inflation=PriorInflation.DISABLED,
    map_func=None,
    observe=None,
    file_name=None,
    likelihood_importance=1.0,
    proposal_step=None,
    args=(),
    kwargs=None,
):
    """Batched counterpart of ``Model._traces``; returns an Empirical.
    Runs without autograd: a served network records no graph."""
    if file_name is not None:
        raise NotImplementedError(
            "file-backed Empirical results come with the storage slice"
        )
    if observe is not None and any(v is None for v in observe.values()):
        raise RuntimeError(f"Observe has missing value(s): {observe}")
    t0 = time.time()
    results_only = getattr(map_func, "__name__", "") == "trace_result"
    outputs, dists, sites, rounds, sizes = _run_batched(
        model,
        num_traces,
        observe,
        trace_mode,
        inference_engine,
        prior_inflation,
        likelihood_importance,
        proposal_step=proposal_step,
        args=args,
        kwargs=kwargs,
        fetch=["result", "log_importance_weight"] if results_only else None,
    )
    lw = outputs["log_importance_weight"]
    finite = torch.isfinite(lw)
    neg_inf = torch.full_like(lw, -math.inf)
    if trace_mode == TraceMode.PRIOR:
        lw = torch.where(finite, torch.ones_like(lw), neg_inf)
    else:
        lw = torch.where(finite, lw, neg_inf)
    # ESS and log Z from the device-resident weights, one host fetch
    m, s1, s2 = kernels.log_weight_stats_packed(lw).cpu().tolist()
    if m == -math.inf:
        ess, log_evidence = 0.0, -math.inf
    else:
        ess, log_evidence = s1 * s1 / s2, m + math.log(s1)
    log_weights = _host(lw).astype(np.float64)
    keep = np.isfinite(log_weights)
    if not keep.all():
        warnings.warn(f"Discarding {(~keep).sum()} traces with nan/inf log_weight.")

    if results_only and isinstance(outputs["result"], torch.Tensor):
        values = _host(outputs["result"])[keep]
        emp = Empirical.from_arrays(values, log_weights[keep], effective_sample_size=ess)
    else:
        traces = _materialize_traces(sites, outputs, dists, sizes)
        if map_func is not None:
            traces = [map_func(t) for t in traces]
        emp = Empirical(
            values=[v for v, k in zip(traces, keep) if k],
            log_weights=log_weights[keep],
            effective_sample_size=ess,
        )
    emp.add_metadata(log_evidence=log_evidence)
    if rounds:
        emp.add_metadata(rejection_rounds=rounds)
    duration = time.time() - t0
    if util.verbosity() > 1:
        util.log_print(
            f"[batched tier] {num_traces:,} traces in {duration:.3f}s "
            f"({num_traces / max(duration, 1e-9):,.0f} traces/s), "
            f"ESS {emp.effective_sample_size:,.1f}"
        )
    return emp


def vectorized_prior(
    model,
    num_traces,
    prior_inflation=PriorInflation.DISABLED,
    map_func=None,
    file_name=None,
    *args,
    **kwargs,
):
    emp = vectorized_traces(
        model,
        num_traces,
        TraceMode.PRIOR,
        prior_inflation=prior_inflation,
        map_func=map_func,
        file_name=file_name,
        args=args,
        kwargs=kwargs,
    )
    emp.rename(f"Prior, traces: {emp.length:,}")
    emp.add_metadata(
        op="prior",
        num_traces=num_traces,
        prior_inflation=str(prior_inflation),
        vectorized=True,
    )
    return emp


def vectorized_posterior(
    model,
    num_traces,
    inference_engine=InferenceEngine.IMPORTANCE_SAMPLING,
    map_func=None,
    observe=None,
    file_name=None,
    likelihood_importance=1.0,
    *args,
    **kwargs,
):
    """Batched posterior by importance sampling, from the prior (IS) or
    from the model's inference network (IC)."""
    if inference_engine == InferenceEngine.IMPORTANCE_SAMPLING:
        proposal_step, label = None, "IS"
    elif inference_engine == InferenceEngine.IMPORTANCE_SAMPLING_WITH_INFERENCE_NETWORK:
        network = model._inference_network
        if network is None:
            raise RuntimeError(
                "No inference network available. Use learn_inference_network "
                "or load_inference_network first."
            )
        proposal_step, label = network.cached_vectorized_proposal_step(observe), "IC"
        if proposal_step is None:
            raise NotImplementedError(
                f"{type(network).__name__} has no batched proposal step"
            )
    else:
        raise NotImplementedError(
            f"{inference_engine.name} is not ported yet; it comes with the "
            "engines slice"
        )
    emp = vectorized_traces(
        model,
        num_traces,
        TraceMode.POSTERIOR,
        inference_engine=inference_engine,
        map_func=map_func,
        observe=observe,
        file_name=file_name,
        likelihood_importance=likelihood_importance,
        proposal_step=proposal_step,
        args=args,
        kwargs=kwargs,
    )
    emp.rename(
        f"Posterior, {label} (batched), traces: {emp.length:,}, "
        f"ESS: {emp.effective_sample_size:,.2f}"
    )
    emp.add_metadata(
        op="posterior",
        num_traces=num_traces,
        inference_engine=str(inference_engine),
        effective_sample_size=emp.effective_sample_size,
        vectorized=True,
    )
    return emp
