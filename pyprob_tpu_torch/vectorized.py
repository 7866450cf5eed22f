"""Batched execution tier: N particles per ``forward`` call.

Counterpart of ``pyprob_tpu/vectorized.py``.  The JAX package traces
``forward`` once under ``jax.vmap``; here ``forward`` runs once per chunk
of particles with a handler installed in ``state`` that draws an explicit
``[N]`` tensor at every ``sample`` site (``[N, D]`` or ``[N, d, d]`` for an
event-shaped distribution; a model reads its coordinates as ``z[..., i]``)
and accumulates ``[N]`` log-weights on the device.  Data-dependent Python control flow on those tensors fails
as it fails under ``vmap``: such a model raises ``NotImplementedError``
here, and with ``vectorized=None`` the entry points mark its class
(``_TraceabilityCache``) and run it on the interpreter tier.  Rejection loops written with
``rejection_sample`` do run here: the block becomes a masked retry loop
over the batch (``VectorizedHandler.rejection_sample``).  Results stay on
the device until the end of a run; the ESS and log Z of a result come from
the ``log_weight_stats`` kernel over the run's ``[N]`` log-weights.  The
MCMC engines route to ``inference.mcmc``, whose ``ReplayHandler`` (a
``VectorizedHandler``) replays ``forward`` over the chains through
``run_forward``; the SMC engines to ``inference.smc``, whose stages run
``forward`` under a ``VectorizedHandler`` that replays the resampled
prefix (``replay_values``); the gradient engines (HMC, NUTS, LAPLACE) to
``inference.hmc`` / ``nuts`` / ``laplace``, whose potential is one replay
of ``forward`` over the chains under ``_TransformedReplayHandler``, run
with autograd on.
"""

from __future__ import annotations

import math
import time
import warnings

import numpy as np
import torch

from . import state, util
from .address import extract_address
from .distributions import Categorical, Empirical, Factor, Normal
from .distributions.empirical import values_of
from .parallel.collectives import log_weight_stats_host
from .trace import Trace, Variable
from .util import InferenceEngine, PriorInflation, TraceMode

_INTERPRETER_TIER = "vectorized=None or False runs it on the interpreter tier"
_BRANCH_MESSAGES = ("ambiguous", "cannot be converted to Scalar", "only one element tensors")

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
        replay_values=None,
        record_site_log_iws=False,
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
        # {full_address: [n, *event] value}: controlled sites in the dict
        # take the given value (SMC's prefix replay, ``inference.smc``)
        self.replay_values = replay_values or None
        # per-site prior - proposal deltas, an output only guided SMC reads
        self.record_site_log_iws = record_site_log_iws
        if proposal_step is not None:
            proposal_step.reset(num_particles)
        self.sites = []
        self.values = []
        self.log_probs = []
        self.site_log_iws = []
        self.instance_counts = {}
        self.rejection_rounds = []  # attempts run by each rejection block
        self.host_syncs = 0  # the retry loops' reads of whether a lane is pending
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

    def _record(self, site, value, log_prob, log_iw=None):
        self.sites.append(site)
        self.values.append(value)
        self.log_probs.append(log_prob)
        self.site_log_iws.append(log_iw)

    def _per_particle_value(self, distribution, value):
        """An observed value as one row per particle (a trace takes row i).
        A value with a leading particle dim (computed from latents: dims
        beyond the distribution's batch and event dims' count less the
        particle dim, and n rows) is kept as it is; any other is the same
        for every particle and becomes a [n, ...] view (a data vector [D]
        observed under a [n, D] batch too)."""
        event = len(distribution.event_shape)
        if (value.dim() > event and value.dim() >= len(distribution.batch_shape) + event
                and value.shape[0] == self.n):
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

        if control and self.replay_values is not None and full in self.replay_values:
            value = self.replay_values[full]
            if self.proposal_step is not None:
                # advance the proposal network through the replayed site
                # (guided SMC keeps the LSTM's chain of sites intact)
                self.proposal_step(
                    site, distribution, self.generator, self.observed, forced_value=value
                )
            log_prob = self._per_particle(distribution.log_prob(value))
            self.log_prob_total = self.log_prob_total + log_prob
            self._record(site, value, log_prob)
            return value

        if control and self._ic_proposals():
            value, proposal_log_prob = self.proposal_step(
                site, distribution, self.generator, self.observed
            )
            log_prob = self._per_particle(distribution.log_prob(value))
            delta = log_prob - proposal_log_prob
            self.log_importance_weight = self.log_importance_weight + delta
            self.log_prob_total = self.log_prob_total + log_prob
            self._record(site, value, log_prob, delta if self.record_site_log_iws else None)
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

    def observe(self, distribution, value=None, name=None, address=None, mask=None):
        if mask is not None:
            raise NotImplementedError(
                "observe(mask=) sites are not ported yet; they come with the "
                "Markov/SMC slice"
            )
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
        elif self.trace_mode == TraceMode.PRIOR_FOR_INFERENCE_NETWORK and not isinstance(
            distribution, Factor
        ):
            value = _draw(distribution, self.n, self.generator)
        if value is None and not isinstance(distribution, Factor):
            site.observed = False
            self._record(site, None, None)
            return None
        # a factor without a value scores None: its fixed log-probability,
        # or its function's value at None, as the JAX package's batched tier
        log_prob = self.likelihood_importance * self._per_particle(
            util.to_tensor(distribution.log_prob(value), self.device)
        )
        if self._is_weighted():
            self.log_importance_weight = self.log_importance_weight + log_prob
        self.log_prob_observed = self.log_prob_observed + log_prob
        self.log_prob_total = self.log_prob_total + log_prob
        self._record(
            site, None if value is None else self._per_particle_value(distribution, value), log_prob
        )
        return value

    def factor(self, log_prob=None, log_prob_func=None, name=None, address=None, mask=None):
        if mask is not None:
            raise NotImplementedError(
                "factor(mask=) is not ported yet; it comes with the Markov/SMC slice"
            )
        return self.observe(Factor(log_prob=log_prob, log_prob_func=log_prob_func), name=name, address=address)

    def tag(self, value, name=None, address=None):
        raise NotImplementedError(
            f"tag sites do not run on the batched tier; {_INTERPRETER_TIER}"
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
        the sequence of executed attempts, with ratio Π p(x_i)/q(x_i)).

        Under guided SMC (replay, per-site weights) retries draw from the
        prior and only the first attempt's correction counts: exact by the
        same argument with q = p on retries.  A block whose sites are all
        replayed runs no retry: its values were accepted when drawn."""
        max_attempts = int(max_attempts) if max_attempts else _REJECTION_MAX_ATTEMPTS
        base_counts = dict(self.instance_counts)
        step = self.proposal_step
        ic_retry = (
            self._ic_proposals()
            and self.replay_values is None
            and not self.record_site_log_iws
            and all(hasattr(step, a) for a in ("get_state", "set_state", "select_state"))
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
        replay_all = self.replay_values is not None and all(
            a in self.replay_values for a in addresses
        )
        pending = ~accept
        # one host sync per round: whether any lane is still pending
        while not replay_all and rounds < max_attempts:
            self.host_syncs += 1
            if not bool(pending.any()):
                break
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
        if not replay_all:
            self.log_importance_weight = torch.where(
                accept, self.log_importance_weight,
                torch.full_like(self.log_importance_weight, -math.inf),
            )
        if ic_retry:
            step.set_state(pstate)
        for site, value, lp, dist, iw in zip(sub0.sites, values, log_probs, dists, sub0.log_iws):
            site.distribution = dist
            if site.control:
                self.log_prob_total = self.log_prob_total + lp
            self._record(site, value, lp, iw if self.record_site_log_iws else None)
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
    return new._with_leaves(leaves)


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
        if outer.replay_values is not None and full in outer.replay_values:
            value = outer.replay_values[full]
            if self.use_proposal and outer.proposal_step is not None:
                # keep the proposal network's chain through replayed block
                # sites (guided SMC's prefix replay)
                outer.proposal_step(site, distribution, outer.generator, outer.observed, forced_value=value)
            lp = outer._per_particle(distribution.log_prob(value))
        elif self.use_proposal and control and outer._ic_proposals():
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

    def observe(self, distribution, value=None, name=None, address=None, mask=None):
        if mask is not None:
            raise NotImplementedError(
                "observe(mask=) sites are not ported yet; they come with the "
                "Markov/SMC slice"
            )
        raise RuntimeError("observe/factor inside rejection_sample is not supported")

    def factor(self, log_prob=None, log_prob_func=None, name=None, address=None, mask=None):
        raise RuntimeError("observe/factor inside rejection_sample is not supported")

    def tag(self, value, name=None, address=None):
        raise RuntimeError("tag inside rejection_sample is not supported")

    def rejection_sample(self, attempt_fn, max_attempts=None):
        raise RuntimeError("nested rejection_sample is not supported on the batched tier")


def run_forward(model, handler, args=(), kwargs=None):
    """Run ``forward`` once under ``handler`` (a ``VectorizedHandler`` or a
    subclass of it, such as the MCMC tier's ``ReplayHandler``); returns its
    result with a number, or a 0-d tensor, spread over the handler's
    particles.  A model that branches on sampled values raises
    ``NotImplementedError``."""
    prev = state._set_handler(handler)
    try:
        result = model.forward(*args, **(kwargs or {}))
    except (RuntimeError, ValueError, TypeError) as e:
        # what torch raises where Python needs one value of an [N] tensor
        # (``if x > 0``, ``float(x)``)
        msg = str(e)
        if any(m in msg for m in _BRANCH_MESSAGES):
            raise NotImplementedError(
                f"model {model.name!r} branches on sampled values, so it does "
                f"not run on the batched tier; {_INTERPRETER_TIER}"
            ) from e
        raise
    finally:
        state._set_handler(prev)
    if isinstance(result, (int, float)):
        # the same for every particle (or one particle's own)
        result = torch.tensor(float(result), dtype=util.dtype(), device=handler.device)
    if isinstance(result, torch.Tensor):
        result = result.expand(handler.n) if result.dim() == 0 else result
    return result


def handler_outputs(handler, result):
    """The outputs of a ``forward`` run under ``handler``: [n] device
    tensors keyed as the JAX package's."""
    n = handler.n
    return {
        "result": result,
        "log_importance_weight": handler.log_importance_weight,
        "log_prob_observed": handler.log_prob_observed,
        "log_prob_total": handler.log_prob_total,
        "values": {
            s.address: v.expand(n) if v.dim() == 0 else v
            for s, v in zip(handler.sites, handler.values)
            if v is not None
        },
        "log_probs": {
            s.address: lp
            for s, lp in zip(handler.sites, handler.log_probs)
            if lp is not None
        },
        "site_log_iws": {
            s.address: iw
            for s, iw in zip(handler.sites, handler.site_log_iws)
            if iw is not None
        },
    }


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
    handler=None,
):
    """Run ``forward`` once over ``num_particles`` particles under the
    batched handler (or under ``handler``, built by the caller); returns
    (outputs, handler).  Outputs hold [n] device tensors keyed as the JAX
    package's."""
    if handler is None:
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
    result = run_forward(model, handler, args, kwargs)
    return handler_outputs(handler, result), handler


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
    make_handler=None,
):
    """Run ``forward`` over chunks of at most ``_BATCH_LIMIT`` particles;
    returns the outputs concatenated to ``num_traces`` on the device
    (only the ``fetch`` keys, when given), the per-chunk distributions of
    each site, the site list, per chunk the rounds its rejection blocks
    ran (summed over the blocks; empty without blocks), and the chunk
    sizes.  A chunk that runs out of device memory is retried at half its
    size (down to one particle, where the error is raised), and the size
    that worked caps this model's later chunks (``_oom_batch_limit``), as
    the JAX package backs off; the run stays on the device.
    ``make_handler(n, begin, generator, observed)``, when given, builds the
    handler of the chunk of ``n`` particles from particle ``begin`` on (the
    MCMC tier's replay passes)."""
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
                handler=None if make_handler is None else make_handler(
                    n, num_traces - remaining, generator, observed
                ),
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


class _TraceabilityCache:
    """Remembers per model class whether ``forward`` runs on the batched
    tier; a class marked False goes straight to the interpreter tier, as
    does a model with ``_never_vectorize`` set (a forward with side effects,
    which must not run even once on this tier)."""

    _cache = {}

    @classmethod
    def known_untraceable(cls, model):
        return _skips_batched_tier(model, fallback=True)

    @classmethod
    def mark(cls, model, ok):
        cls._cache[type(model)] = ok


def _skips_batched_tier(model, fallback):
    """Whether an entry point returns None at once for ``model``: for a
    model with ``_never_vectorize`` set, also without ``fallback``
    (``vectorized=True``), as the JAX package does; with ``fallback`` also
    for a model whose class is known not to run here."""
    return getattr(model, "_never_vectorize", False) or (
        fallback and _TraceabilityCache._cache.get(type(model)) is False
    )


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
                else s.distribution._with_leaves([leaf[i] for leaf in leaves[j]])
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
    fallback=False,
):
    """Batched counterpart of ``Model._traces``; returns an Empirical.
    Runs without autograd: a served network records no graph.  With
    ``fallback``, a model that cannot run here (``NotImplementedError``)
    is marked untraceable for its class and None is returned, as is at
    once for a class already marked: the caller runs the interpreter
    tier."""
    if _skips_batched_tier(model, fallback):
        return None
    if observe is not None and any(v is None for v in observe.values()):
        raise RuntimeError(f"Observe has missing value(s): {observe}")
    t0 = time.time()
    results_only = getattr(map_func, "__name__", "") == "trace_result"
    try:
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
    except NotImplementedError as e:
        if not fallback:
            raise
        util.log_print(
            f"[pyprob_tpu_torch] model {model.name!r} does not run on the batched tier "
            f"({e}); falling back to the interpreter tier."
        )
        _TraceabilityCache.mark(model, False)
        return None
    _TraceabilityCache.mark(model, True)
    lw = outputs["log_importance_weight"]
    finite = torch.isfinite(lw)
    neg_inf = torch.full_like(lw, -math.inf)
    if trace_mode == TraceMode.PRIOR:
        lw = torch.where(finite, torch.ones_like(lw), neg_inf)
    else:
        lw = torch.where(finite, lw, neg_inf)
    # ESS and log Z from the device-resident weights, one host fetch
    ess, log_evidence = log_weight_stats_host(lw)
    log_weights = _host(lw).astype(np.float64)
    keep = np.isfinite(log_weights)
    if not keep.all():
        warnings.warn(f"Discarding {(~keep).sum()} traces with nan/inf log_weight.")

    if results_only and isinstance(outputs["result"], torch.Tensor):
        values = _host(outputs["result"])[keep]
        emp = Empirical.from_arrays(values, log_weights[keep], effective_sample_size=ess, file_name=file_name)
    else:
        traces = _materialize_traces(sites, outputs, dists, sizes)
        if map_func is not None:
            traces = [map_func(t) for t in traces]
        emp = Empirical(
            values=values_of([v for v, k in zip(traces, keep) if k]),
            log_weights=log_weights[keep],
            effective_sample_size=ess,
            file_name=file_name,
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
    fallback=False,
    *args,
    **kwargs,
):
    """Batched prior; None when ``fallback`` and the model cannot run on
    this tier (``vectorized_traces``)."""
    emp = vectorized_traces(
        model,
        num_traces,
        TraceMode.PRIOR,
        prior_inflation=prior_inflation,
        map_func=map_func,
        file_name=file_name,
        args=args,
        kwargs=kwargs,
        fallback=fallback,
    )
    if emp is None:
        return None
    emp.rename(f"Prior, traces: {emp.length:,}")
    emp.add_metadata(
        op="prior",
        num_traces=num_traces,
        prior_inflation=str(prior_inflation),
        vectorized=True,
    )
    return emp


def _network_proposal_step(model, observe):
    """The batched proposal step of the model's trained network."""
    network = model._inference_network
    if network is None:
        raise RuntimeError(
            "No inference network available. Use learn_inference_network "
            "or load_inference_network first."
        )
    proposal_step = network.cached_vectorized_proposal_step(observe)
    if proposal_step is None:
        raise NotImplementedError(f"{type(network).__name__} has no batched proposal step")
    return proposal_step


def vectorized_posterior(
    model,
    num_traces,
    inference_engine=InferenceEngine.IMPORTANCE_SAMPLING,
    map_func=None,
    observe=None,
    file_name=None,
    likelihood_importance=1.0,
    fallback=False,
    initial_trace=None,
    thinning_steps=None,
    num_chains=None,
    burn_in=None,
    return_chains=False,
    resample_threshold=0.5,
    resampling="systematic",
    leapfrog_steps=None,
    target_accept=None,
    step_size=None,
    max_tree_depth=None,
    map_steps=None,
    num_starts=None,
    learning_rate=None,
    *args,
    **kwargs,
):
    """Batched posterior by importance sampling, from the prior (IS) or
    from the model's inference network (IC), by parallel LMH / RMH
    chains (``inference.mcmc.vectorized_mcmc_posterior``, which takes
    ``initial_trace``, ``thinning_steps``, ``num_chains``, ``burn_in`` and
    ``return_chains``), by SMC, guided by the network or not
    (``inference.smc.vectorized_smc_posterior``, which takes
    ``resample_threshold`` and ``resampling``), or by the gradient engines:
    HMC and NUTS chains (``inference.hmc`` / ``inference.nuts``, which take
    ``leapfrog_steps`` / ``max_tree_depth``, ``target_accept``,
    ``step_size`` and a ``GradientChainState`` as ``initial_trace``) and
    LAPLACE (``inference.laplace``: ``map_steps``, ``num_starts``,
    ``learning_rate``); None when ``fallback`` and the model cannot run on
    this tier (``vectorized_traces``), and for SMC and the gradient engines
    whenever it cannot (the caller runs the interpreter filter or raises)."""
    if inference_engine == InferenceEngine.LAPLACE:
        from .inference.laplace import vectorized_laplace_posterior

        return vectorized_laplace_posterior(
            model,
            num_traces=num_traces,
            observe=observe,
            map_func=map_func,
            file_name=file_name,
            map_steps=map_steps,
            num_starts=num_starts,
            learning_rate=learning_rate,
            likelihood_importance=likelihood_importance,
            args=args,
            kwargs=kwargs,
        )
    if inference_engine in state._GRADIENT_CHAINS:
        # initial_trace doubles as the warm-start slot for the gradient
        # engines: a GradientChainState from final_gradient_state
        from .inference.hmc import GradientChainState

        if initial_trace is not None and not isinstance(initial_trace, GradientChainState):
            raise RuntimeError(
                f"{inference_engine.name} resumes from a "
                "GradientChainState (posterior.final_gradient_state), "
                f"got {type(initial_trace).__name__}"
            )
        common = dict(
            num_traces=num_traces,
            observe=observe,
            map_func=map_func,
            file_name=file_name,
            num_chains=num_chains,
            burn_in=burn_in,
            thinning_steps=thinning_steps,
            target_accept=target_accept,
            step_size=step_size,
            likelihood_importance=likelihood_importance,
            return_chains=return_chains,
            initial_state=initial_trace,
            args=args,
            kwargs=kwargs,
        )
        if inference_engine == InferenceEngine.NO_U_TURN_SAMPLER:
            from .inference.nuts import vectorized_nuts_posterior

            return vectorized_nuts_posterior(model, max_tree_depth=max_tree_depth, **common)
        from .inference.hmc import vectorized_hmc_posterior

        return vectorized_hmc_posterior(model, leapfrog_steps=leapfrog_steps, **common)
    if inference_engine in state._SMC:
        from .inference.smc import vectorized_smc_posterior

        guided = inference_engine == InferenceEngine.SEQUENTIAL_MONTE_CARLO_WITH_INFERENCE_NETWORK
        proposal_step = _network_proposal_step(model, observe) if guided else None
        return vectorized_smc_posterior(
            model,
            num_traces=num_traces,
            observe=observe,
            map_func=map_func,
            file_name=file_name,
            resample_threshold=resample_threshold,
            resampling=resampling,
            likelihood_importance=likelihood_importance,
            proposal_step=proposal_step,
            args=args,
            kwargs=kwargs,
        )
    if inference_engine in state._MCMC:
        from .inference.mcmc import vectorized_mcmc_posterior

        return vectorized_mcmc_posterior(
            model,
            num_traces=num_traces,
            inference_engine=inference_engine,
            map_func=map_func,
            observe=observe,
            file_name=file_name,
            initial_trace=initial_trace,
            thinning_steps=thinning_steps,
            num_chains=num_chains,
            burn_in=burn_in,
            return_chains=return_chains,
            fallback=fallback,
            args=args,
            kwargs=kwargs,
        )
    if _skips_batched_tier(model, fallback):
        return None
    if inference_engine == InferenceEngine.IMPORTANCE_SAMPLING:
        proposal_step, label = None, "IS"
    elif inference_engine == InferenceEngine.IMPORTANCE_SAMPLING_WITH_INFERENCE_NETWORK:
        proposal_step, label = _network_proposal_step(model, observe), "IC"
    else:
        raise state._engines_later(inference_engine.name)
    try:
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
            fallback=fallback,
        )
    finally:
        # the network keeps its step between runs: drop the last chunk's
        # recurrent state and values, so no run's batch outlives it
        if proposal_step is not None:
            proposal_step.reset(0)
    if emp is None:
        return None
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
