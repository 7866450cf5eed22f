"""Batched single-site Metropolis-Hastings: C parallel chains a ``forward``
call (counterpart of ``pyprob_tpu/inference/mcmc.py``).

The JAX package scans a jitted step over steps and vmaps it over chains.
Here the step loop is Python and each step is one batched replay of
``forward`` over the ``[C]`` chains on the device, under ``ReplayHandler``:
every chain picks its own site to perturb, every other site replays the
chain's stored value and is rescored, and the acceptance test is a
``torch.where`` over the chains.  Draws come from the run's device
``torch.Generator``.  A step makes no host sync (a ``rejection_sample``
block excepted: its retry loop asks once a round whether a chain is still
pending, as the batched tier's does); the kept states stay on the device
and are copied to the host once per ``_HOST_EVERY`` kept steps.

The structure is static on this tier, so the reference's acceptance
formula (reference: pyprob/model.py:151-162) simplifies: the trace-length
terms cancel and every controlled site but the perturbed one is reused,

    log a = Σ_{k ≠ j} (lp_k' − lp_k) + t_j + (obs' − obs)

with t_j the RMH transition log-ratio (``rmh_log_ratio``), 0 for LMH.
"""

from __future__ import annotations

import math
import pickle
import time

import numpy as np
import torch

from .. import state, util
from ..concurrency import _PlainUnpickler
from ..distributions import Empirical, Normal, TruncatedNormal, Uniform
from ..ops import kernels
from ..util import InferenceEngine, PriorInflation, TraceMode
from ..vectorized import (
    _REJECTION_MAX_ATTEMPTS,
    SiteRecord,
    VectorizedHandler,
    _draw,
    _materialize_traces,
    _RejectionAttemptHandler,
    _run_batched,
    _select,
    _select_distribution,
    _skips_batched_tier,
    _TraceabilityCache,
    run_forward,
)

RMH_ALPHA = 0.5
_LOG_ALPHA, _LOG_1M_ALPHA = math.log(RMH_ALPHA), math.log1p(-RMH_ALPHA)
# kept steps stacked on the device before one copy to the host
_HOST_EVERY = 256


class ChainState:
    """The whole per-chain state of a batched MCMC run: every chain's
    current values and per-site log-probs, its observed log-likelihood and
    its result, as numpy arrays with the chains on the first dimension.

    A result's ``final_chain_state``; ``posterior(initial_trace=state)``
    resumes every chain from its own state (the reference resumes its one
    chain from ``initial_trace=posterior[-1]``, pyprob/model.py:122-127).
    If the observation changed between the runs, the chains are rescored
    by one replay pass before they step.  ``save`` writes a pickle of
    numpy arrays and plain data, which ``load`` reads with an unpickler
    that refuses anything else; the file is not interchangeable with the
    JAX package's ChainState pickle."""

    def __init__(self, values, log_probs, log_prob_observed, result, inference_engine, observe_fingerprint):
        self.values = values  # {address: np [C, ...]}
        self.log_probs = log_probs  # {address: np [C]}
        self.log_prob_observed = log_prob_observed  # np [C]
        self.result = result  # np [C, ...], or a dict/tuple/list of them
        self.inference_engine = inference_engine
        self.observe_fingerprint = observe_fingerprint

    @property
    def num_chains(self):
        return int(np.asarray(self.log_prob_observed).shape[0])

    def save(self, file_name):
        data = {
            "values": self.values,
            "log_probs": self.log_probs,
            "log_prob_observed": self.log_prob_observed,
            "result": self.result,
            "inference_engine": self.inference_engine.name,
            "observe_fingerprint": self.observe_fingerprint,
        }
        with open(file_name, "wb") as f:
            pickle.dump(data, f, protocol=pickle.HIGHEST_PROTOCOL)

    @staticmethod
    def load(file_name):
        try:
            with open(file_name, "rb") as f:
                data = _PlainUnpickler(f).load()
            return ChainState(
                values=data["values"],
                log_probs=data["log_probs"],
                log_prob_observed=data["log_prob_observed"],
                result=data["result"],
                inference_engine=InferenceEngine[data["inference_engine"]],
                observe_fingerprint=data["observe_fingerprint"],
            )
        except (pickle.UnpicklingError, KeyError, TypeError, EOFError) as e:
            raise TypeError(f"{file_name} does not contain a ChainState: {e}") from e

    def __repr__(self):
        return f"ChainState(num_chains={self.num_chains}, addresses={list(self.values.keys())})"


def _host(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _observe_fingerprint(observe):
    return tuple(sorted((k, np.asarray(_host(v), np.float64).tobytes()) for k, v in (observe or {}).items()))


def _rmh_kernel(distribution, x):
    """RMH's random-walk kernel at ``x``: Normal(x, σ) for a Normal prior, a
    TruncatedNormal of width 0.1 (high − low) on [low, high] for a Uniform
    one; None for any other distribution (it is proposed from its prior)."""
    if isinstance(distribution, Normal):
        return Normal(x, distribution.stddev)
    if isinstance(distribution, Uniform):
        return TruncatedNormal(
            x, 0.1 * (distribution.high - distribution.low), low=distribution.low, high=distribution.high
        )
    return None


def rmh_log_ratio(distribution, old_value, old_log_prob, new_value, new_log_prob, reduce):
    """The RMH transition log-ratio log q(old | new) + log p(new) − log q(new
    | old) − log p(old) with the α-mixture kernel q(· | x) = α k(· | x) +
    (1 − α) p(·) (reference: pyprob/state.py:235-262).  ``reduce`` sums a
    kernel's log-densities to one per value (one per chain on the batched
    tier); log-probs given as floats are taken in float64."""

    def as_tensor(lp):
        return lp if isinstance(lp, torch.Tensor) else torch.tensor(lp, dtype=torch.float64)

    old_log_prob, new_log_prob = as_tensor(old_log_prob), as_tensor(new_log_prob)
    rev = reduce(_rmh_kernel(distribution, new_value).log_prob(old_value))
    fwd = reduce(_rmh_kernel(distribution, old_value).log_prob(new_value))
    log_q_rev = torch.logaddexp(_LOG_ALPHA + rev, _LOG_1M_ALPHA + old_log_prob)
    log_q_fwd = torch.logaddexp(_LOG_ALPHA + fwd, _LOG_1M_ALPHA + new_log_prob)
    return log_q_rev + new_log_prob - log_q_fwd - old_log_prob


_LOG_SQRT_2PI = 0.5 * math.log(2.0 * math.pi)


def _scalar_kernel_log_prob(distribution, x, at):
    """log k(x | at) of RMH's kernel in float64 on the host, for a Normal or
    Uniform of 0-d parameters (``_rmh_kernel``'s densities)."""
    if type(distribution) is Normal:
        scale = float(distribution.scale)
        z = (x - at) / scale
        return -0.5 * z * z - math.log(scale) - _LOG_SQRT_2PI
    low, high = float(distribution.low), float(distribution.high)
    if not low <= x <= high:
        return -math.inf
    scale = 0.1 * (high - low)
    ndtr = lambda v: 0.5 * (1.0 + math.erf(v / math.sqrt(2.0)))  # noqa: E731
    z = max(ndtr((high - at) / scale) - ndtr((low - at) / scale), 1e-12)
    xi = (x - at) / scale
    return -0.5 * xi * xi - _LOG_SQRT_2PI - math.log(scale) - math.log(z)


def rmh_log_ratio_scalar(distribution, old_value, old_log_prob, new_value, new_log_prob):
    """``rmh_log_ratio`` for a Normal or Uniform site of 0-d parameters and
    value, in float64 on the host (the interpreter's hot path)."""
    old, new = float(old_value), float(new_value)

    def log_mix(kernel_lp, prior_lp):
        a, b = _LOG_ALPHA + kernel_lp, _LOG_1M_ALPHA + prior_lp
        m = max(a, b)
        return m if m == -math.inf else m + math.log(math.exp(a - m) + math.exp(b - m))

    log_q_rev = log_mix(_scalar_kernel_log_prob(distribution, old, new), old_log_prob)
    log_q_fwd = log_mix(_scalar_kernel_log_prob(distribution, new, old), new_log_prob)
    return log_q_rev + new_log_prob - log_q_fwd - old_log_prob


class ReplayHandler(VectorizedHandler):
    """Replays ``forward`` over the chains: each chain's site
    ``perturb_index`` (a [C] tensor; -1 perturbs none, a rescoring pass)
    gets a proposal, every other controlled site the chain's stored value.
    It accumulates, per chain, the reused sites' log-prob differences and
    the perturbed site's transition term."""

    def __init__(self, num_chains, generator, observed, root_function_name, engine, current_values,
                 current_log_probs, perturb_index):
        super().__init__(
            num_particles=num_chains,
            generator=generator,
            trace_mode=TraceMode.POSTERIOR,
            inference_engine=engine,
            observed=observed,
            root_function_name=root_function_name,
        )
        self.current_values = current_values
        self.current_log_probs = current_log_probs
        self.perturb_index = perturb_index
        self.controlled_counter = 0
        self.reused_log_prob_diff = torch.zeros_like(self.log_prob_total)
        self.transition_term = torch.zeros_like(self.log_prob_total)

    def _current(self, address):
        if address not in self.current_values:
            raise RuntimeError(
                f"the chains' state has no site {address}: the model met other sites than "
                "when the chains began (or the state was recorded for another model)"
            )
        return self.current_values[address], self.current_log_probs[address]

    def sample(self, distribution, name=None, address=None, control=True, mask=None):
        # the MCMC engines control every sample site
        if name is not None and name in self.observed:
            return super().sample(distribution, name=name, address=address, mask=mask)
        if mask is not None:
            raise NotImplementedError(
                "sample(mask=) sites are not ported yet; they come with the Markov/SMC slice"
            )
        base, full, instance = self._make_address(address, distribution.address_suffix)
        i = self.controlled_counter
        self.controlled_counter += 1
        is_site = self.perturb_index == i
        cur_value, cur_lp = self._current(full)
        proposed = _draw(distribution, self.n, self.generator)
        kernel = (
            _rmh_kernel(distribution, cur_value)
            if self.inference_engine == InferenceEngine.RANDOM_WALK_METROPOLIS_HASTINGS
            else None
        )
        if kernel is not None:
            walk = _draw(kernel, self.n, self.generator)
            use_walk = torch.rand((self.n,), generator=self.generator, device=self.device) < RMH_ALPHA
            proposed = _select(use_walk, walk, proposed)
            prop_lp = self._per_particle(distribution.log_prob(proposed))
            t = rmh_log_ratio(distribution, cur_value, cur_lp, proposed, prop_lp, self._per_particle)
            self.transition_term = self.transition_term + torch.where(is_site, t, 0.0)
        value = _select(is_site, proposed, cur_value)
        log_prob = self._per_particle(distribution.log_prob(value))
        self.reused_log_prob_diff = self.reused_log_prob_diff + torch.where(is_site, 0.0, log_prob - cur_lp)
        self.log_prob_total = self.log_prob_total + log_prob
        site = SiteRecord(
            address_base=base, address=full, instance=instance, name=name, control=True,
            observed=False, distribution=distribution,
        )
        self._record(site, value, log_prob)
        return value

    def rejection_sample(self, attempt_fn, max_attempts=None):
        """A block-atomic MH kernel for a ``rejection_sample`` block.  Block
        sites keep single-site moves: a chain whose perturbed index falls on
        block site i redraws only site i from its prior (the others keep
        their stored values), retrying until the predicate holds: a draw
        from site i's prior truncated to the acceptance region, whose
        normalizer is the same for the current and the candidate state and
        cancels in the MH ratio.  A chain perturbed outside the block
        replays the stored values and rechecks the predicate under its
        candidate's outer latents; a violated predicate, or a redraw still
        rejected after ``max_attempts`` rounds, sends its ratio to −inf.
        The block's other sites are rescored like any reused site.  As in
        the JAX package, this targets the unnormalized-indicator density:
        exact when the acceptance region depends only on the block's own
        values (Marsaglia)."""
        max_attempts = int(max_attempts) if max_attempts else _REJECTION_MAX_ATTEMPTS
        base_counts = dict(self.instance_counts)
        j_rel = self.perturb_index - self.controlled_counter  # the perturbed site within the block

        def run_attempt():
            sub = _ReplayAttemptHandler(self, base_counts, j_rel)
            prev = state._set_handler(sub)
            try:
                out, accept = attempt_fn()
            finally:
                state._set_handler(prev)
            return out, torch.as_tensor(accept, device=self.device).to(torch.bool).expand(self.n), sub

        # the first round holds the stored values for a chain perturbed
        # outside the block, which needs no other
        out, accepted, sub0 = run_attempt()
        K = len(sub0.sites)
        if K == 0:
            raise RuntimeError("rejection_sample block contains no sample sites")
        addresses = [s.address for s in sub0.sites]
        values, log_probs = list(sub0.values), list(sub0.log_probs)
        dists = [s.distribution for s in sub0.sites]
        in_block = (j_rel >= 0) & (j_rel < K)
        pending = in_block & ~accepted
        rounds = 1
        # one host sync a round: whether a chain is still pending
        while rounds < max_attempts and bool(pending.any()):
            o, acc, sub = run_attempt()
            if [s.address for s in sub.sites] != addresses:
                raise RuntimeError("rejection_sample attempts must meet the same sample sites on the batched tier")
            out = _select(pending, o, out)
            values = [_select(pending, a, b) for a, b in zip(sub.values, values)]
            log_probs = [_select(pending, a, b) for a, b in zip(sub.log_probs, log_probs)]
            dists = [_select_distribution(pending, s.distribution, d) for s, d in zip(sub.sites, dists)]
            accepted = accepted | (pending & acc)
            pending = pending & ~acc
            rounds += 1
        self.rejection_rounds.append(rounds)
        diff = torch.where(accepted, 0.0, -math.inf)
        for k, (address, lp) in enumerate(zip(addresses, log_probs)):
            # the redrawn site's prior factor cancels against its truncated
            # proposal; the others are reused and rescored
            diff = diff + torch.where(j_rel == k, 0.0, lp - self._current(address)[1])
        self.reused_log_prob_diff = self.reused_log_prob_diff + diff
        self.controlled_counter += K
        self.instance_counts = dict(sub0.instance_counts)
        for site, value, lp, dist in zip(sub0.sites, values, log_probs, dists):
            site.distribution = dist
            self.log_prob_total = self.log_prob_total + lp
            self._record(site, value, lp)
        return out


class _ReplayAttemptHandler(_RejectionAttemptHandler):
    """One attempt of a rejection block under ``ReplayHandler``: each site
    takes the chain's stored value, but the chain's site ``fresh_index``
    within the block (a [C] tensor) draws from its prior."""

    def __init__(self, outer, base_counts, fresh_index):
        super().__init__(outer, base_counts, use_proposal=False)
        self.fresh_index = fresh_index

    def sample(self, distribution, name=None, address=None, control=True, mask=None):
        outer = self.outer
        if mask is not None:
            raise RuntimeError(
                "sample(mask=) inside rejection_sample is not supported "
                "(the block's acceptance indicator already gates attempts)"
            )
        if name is not None and name in outer.observed:
            raise RuntimeError("observed sample sites inside rejection_sample are not supported")
        base, full, instance = self._make_address(address, distribution.address_suffix)
        stored, _ = outer._current(full)
        fresh = _draw(distribution, outer.n, outer.generator)
        value = _select(self.fresh_index == len(self.sites), fresh, stored)
        site = SiteRecord(
            address_base=base, address=full, instance=instance, name=name, control=True,
            observed=False, distribution=distribution, rejection=True,
        )
        self.sites.append(site)
        self.values.append(value)
        self.log_probs.append(outer._per_particle(distribution.log_prob(value)))
        self.log_iws.append(None)
        return value


def _engine_name(engine):
    return "LMH" if engine == InferenceEngine.LIGHTWEIGHT_METROPOLIS_HASTINGS else "RMH"


def _stack(items, dim=0):
    """Stack a list of tensors, or of dicts/tuples/lists of them."""
    first = items[0]
    if first is None:
        return None
    if isinstance(first, dict):
        return {k: _stack([x[k] for x in items], dim) for k in first}
    if isinstance(first, (tuple, list)):
        return type(first)(_stack(list(parts), dim) for parts in zip(*items))
    return torch.stack(items, dim)


def _tree(fn, x):
    if x is None:
        return None
    if isinstance(x, dict):
        return {k: _tree(fn, v) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return type(x)(_tree(fn, v) for v in x)
    return fn(x)


def _replay_pass(model, engine, observed, values, perturb_index, generator, args, kwargs):
    """One ``forward`` over the chains with ``perturb_index`` [C]: (handler,
    its result)."""
    handler = ReplayHandler(
        perturb_index.shape[0], generator, observed, model.forward.__code__.co_name, engine, values[0], values[1],
        perturb_index,
    )
    return handler, run_forward(model, handler, args, kwargs)


def _controlled(handler, addresses):
    values = {s.address: v for s, v in zip(handler.sites, handler.values) if s.address in addresses}
    lps = {s.address: lp for s, lp in zip(handler.sites, handler.log_probs) if s.address in addresses}
    return values, lps


def _rescore(model, observed, values, lps, generator, args, kwargs):
    """Every chain's log-probs, observed log-likelihood and result at its
    stored values (a replay that perturbs no site)."""
    n = next(iter(lps.values())).shape[0]
    none = torch.full((n,), -1, dtype=torch.long, device=next(iter(lps.values())).device)
    handler, result = _replay_pass(
        model, InferenceEngine.LIGHTWEIGHT_METROPOLIS_HASTINGS, observed, (values, lps), none, generator, args, kwargs
    )
    new_values, new_lps = _controlled(handler, lps)
    return new_values, new_lps, handler.log_prob_observed, result


def _kept_traces(model, observed, kept_values, addresses, args, kwargs):
    """Traces of the kept states: one replay pass over them (in chunks, as
    the batched tier runs) gives every site's value, log-prob and
    distribution; the traces are built as the batched tier builds them."""
    num = next(iter(kept_values.values())).shape[0]
    zeros = {a: torch.zeros(num, dtype=util.dtype(), device=kept_values[a].device) for a in addresses}
    root = model.forward.__code__.co_name

    def make_handler(n, begin, generator, observed_):
        return ReplayHandler(
            n, generator, observed_, root, InferenceEngine.LIGHTWEIGHT_METROPOLIS_HASTINGS,
            {a: v[begin : begin + n] for a, v in kept_values.items()},
            {a: v[begin : begin + n] for a, v in zeros.items()},
            torch.full((n,), -1, dtype=torch.long, device=util.device()),
        )

    outputs, dists, sites, _, sizes = _run_batched(
        model, num, observed, TraceMode.POSTERIOR, InferenceEngine.LIGHTWEIGHT_METROPOLIS_HASTINGS,
        PriorInflation.DISABLED, 1.0, args=args, kwargs=kwargs, make_handler=make_handler,
    )
    traces = _materialize_traces(sites, outputs, dists, sizes)
    for tr in traces:
        tr.log_importance_weight = 0.0
    return traces


def _untraceable_resume(model):
    return ValueError(
        "ChainState resume requires the batched MCMC tier, but model "
        f"{model.name!r} does not run there; resume the interpreter chain with a Trace instead."
    )


@torch.no_grad()
def vectorized_mcmc_posterior(
    model,
    num_traces,
    inference_engine,
    map_func=None,
    observe=None,
    file_name=None,
    initial_trace=None,
    thinning_steps=None,
    num_chains=None,
    burn_in=None,
    return_chains=False,
    fallback=False,
    args=(),
    kwargs=None,
):
    """C parallel chains of S steps with C·S ≈ ``num_traces`` transitions
    after burn-in.  ``num_chains`` defaults to min(max(1, n // 256), 1024)
    (enough chains to fill the card, at least 256 steps each); ``burn_in``
    to max(8, S // 10) steps, run before the kept ones (0 on a resume under
    the same observation).  Fresh chains start from an importance-resampled
    warm start: min(16384, 64 C) prior draws scored on the observations,
    resampled by those weights (their statistics from kernel 3).
    ``initial_trace`` is a ``ChainState`` (every chain resumes from its own
    state, rescored when the observation changed) or a ``Trace`` (every
    chain starts from its values, rescored).  Returns an Empirical of the
    kept results (``posterior_results``), or of the kept states' traces
    mapped by ``map_func`` (built by one replay pass over them), with
    ``final_chain_state``; with ``return_chains``, one Empirical of kept
    results a chain.  None when ``fallback`` and the model does not run on
    this tier (the caller runs the interpreter chain); a ``ChainState``
    resume on such a model raises ValueError."""
    kwargs = kwargs or {}
    resume = initial_trace if isinstance(initial_trace, ChainState) else None
    if _skips_batched_tier(model, fallback):
        if resume is not None:
            raise _untraceable_resume(model)
        return None
    if observe is not None and any(v is None for v in observe.values()):
        raise RuntimeError(f"Observe has missing value(s): {observe}")
    device = util.device()
    observed = {k: util.to_tensor(v, device) for k, v in (observe or {}).items()}
    generator = util.generator(device)
    fingerprint = _observe_fingerprint(observe)
    obs_changed = resume is not None and resume.observe_fingerprint != fingerprint
    if num_chains is None:
        num_chains = resume.num_chains if resume is not None else int(min(max(1, num_traces // 256), 1024))
    C = int(num_chains)
    thinning_steps = 1 if thinning_steps is None else int(thinning_steps)
    per_chain = max(1, -(-num_traces // C))
    if burn_in is None:
        burn_in = 0 if resume is not None and not obs_changed else max(8, per_chain // 10)
    num_steps = per_chain + burn_in
    t0 = time.time()

    # the site structure, and the warm start's prior draws
    pool = C if resume is not None else int(max(C, min(16384, 64 * C)))
    try:
        init, _, sites, _, _ = _run_batched(
            model, pool, observe, TraceMode.POSTERIOR, InferenceEngine.IMPORTANCE_SAMPLING,
            PriorInflation.DISABLED, 1.0, args=args, kwargs=kwargs,
        )
    except NotImplementedError as e:
        if resume is not None:
            raise _untraceable_resume(model) from e
        if not fallback:
            raise
        util.log_print(
            f"[pyprob_tpu_torch] model {model.name!r} does not run on the batched tier ({e}); "
            "falling back to the interpreter chain."
        )
        _TraceabilityCache.mark(model, False)
        return None
    _TraceabilityCache.mark(model, True)
    addresses = [s.address for s in sites if not s.observed and s.address in init["values"]]
    if not addresses:
        raise RuntimeError("Cannot run MCMC with no controlled sample sites in the model.")

    need_rescore = False
    warm_start_ess = None
    if resume is not None:
        missing = [a for a in addresses if a not in resume.values]
        if missing:
            raise ValueError(
                f"ChainState does not cover controlled addresses {missing}; "
                "it was recorded for a different model or observe names."
            )
        take = np.arange(C) % resume.num_chains

        def on_device(a):
            return torch.as_tensor(np.asarray(a)[take], device=device)

        values = {a: on_device(resume.values[a]) for a in addresses}
        lps = {a: on_device(resume.log_probs[a]).to(util.dtype()) for a in addresses}
        obs_lp = on_device(resume.log_prob_observed).to(util.dtype())
        result = _tree(on_device, resume.result)
        need_rescore = obs_changed
    else:
        # the importance-resampled warm start: the pool is an IS run with
        # prior proposals; resampling it by its weights starts every chain
        # at an approximate posterior draw
        lw = init["log_prob_observed"]
        lw = torch.where(torch.isfinite(lw), lw, torch.full_like(lw, -math.inf))
        m, s1, s2 = kernels.log_weight_stats_packed(lw).unbind(0)
        warm_start_ess = s1 * s1 / s2
        weights = torch.exp(lw - m)
        if torch.isinf(m):  # every draw impossible: resample uniformly
            weights = torch.ones_like(lw)
        pick = torch.multinomial(weights, C, replacement=True, generator=generator)
        values = {a: init["values"][a][pick] for a in addresses}
        lps = {a: init["log_probs"][a][pick] for a in addresses}
        obs_lp = init["log_prob_observed"][pick]
        result = _tree(lambda r: r[pick], init["result"])
        if initial_trace is not None:
            if not hasattr(initial_trace, "variables_dict_address"):
                raise TypeError(
                    "initial_trace must be a Trace or a ChainState (e.g. posterior.final_chain_state "
                    f"from a previous batched run), got {type(initial_trace).__name__}."
                )
            for a in addresses:
                v = initial_trace.variables_dict_address.get(a)
                if v is not None and v.value is not None:
                    given = torch.as_tensor(_host(v.value), device=device).to(values[a].dtype)
                    values[a] = given.expand(values[a].shape).clone()
                    need_rescore = True
    del init
    if need_rescore:
        values, lps, obs_lp, result = _rescore(model, observed, values, lps, generator, args, kwargs)

    results_only = getattr(map_func, "__name__", "") == "trace_result"
    K = len(addresses)
    accepts = torch.zeros(C, dtype=torch.long, device=device)
    kept, host_parts = [], []
    t_steps = time.time()
    for step in range(num_steps):
        j = torch.randint(K, (C,), generator=generator, device=device)
        handler, cand_result = _replay_pass(
            model, inference_engine, observed, (values, lps), j, generator, args, kwargs
        )
        cand_values, cand_lps = _controlled(handler, lps)
        log_alpha = handler.reused_log_prob_diff + handler.transition_term + handler.log_prob_observed - obs_lp
        u = torch.rand((C,), generator=generator, device=device).clamp_min(1e-38)
        accept = torch.log(u) < log_alpha
        accepts += accept
        values = {a: _select(accept, cand_values[a], values[a]) for a in addresses}
        lps = {a: _select(accept, cand_lps[a], lps[a]) for a in addresses}
        obs_lp = torch.where(accept, handler.log_prob_observed, obs_lp)
        result = None if result is None else _select(accept, cand_result, result)
        if step >= burn_in and (step - burn_in) % thinning_steps == 0:
            kept.append(result if results_only or return_chains else values)
            if len(kept) == _HOST_EVERY:
                host_parts.append(_tree(_host, _stack(kept, 1)))
                kept = []
    if kept:
        host_parts.append(_tree(_host, _stack(kept, 1)))
    steps_seconds = time.time() - t_steps
    accept_rate = float(accepts.sum()) / (C * num_steps)
    final_state = ChainState(
        values={a: _host(v) for a, v in values.items()},
        log_probs={a: _host(v) for a, v in lps.items()},
        log_prob_observed=_host(obs_lp),
        result=_tree(_host, result),
        inference_engine=inference_engine,
        observe_fingerprint=fingerprint,
    )
    kept_host = _concat_host_steps(host_parts)  # [C, S_kept, ...]
    num_kept = len(range(burn_in, num_steps, thinning_steps))
    engine_name = _engine_name(inference_engine)

    if return_chains:
        chains = []
        for c in range(C):
            chain = _empirical_of_kept(_tree(lambda r: r[c], kept_host), num_kept, None)
            chain.final_chain_state = final_state
            chains.append(chain)
        return chains
    if results_only:
        # chains interleaved a step at a time: [S_kept, C, ...] flattened
        flat = _tree(lambda r: np.swapaxes(r, 0, 1).reshape((C * num_kept,) + r.shape[2:]), kept_host)
        emp = _empirical_of_kept(flat, C * num_kept, file_name)
    else:
        flat = {
            a: torch.as_tensor(np.swapaxes(v, 0, 1).reshape((C * num_kept,) + v.shape[2:]), device=device)
            for a, v in kept_host.items()
        }
        traces = _kept_traces(model, observed, flat, addresses, args, kwargs)
        if map_func is not None:
            traces = [map_func(t) for t in traces]
        from ..model import empirical_of

        emp = empirical_of(traces, np.zeros(len(traces)), file_name)
    duration = time.time() - t0
    transitions = C * num_steps
    if util.verbosity() > 1:
        util.log_print(
            f"[batched tier] {engine_name}: {C} chains x {num_steps} steps = {transitions:,} transitions in "
            f"{duration:.3f}s ({transitions / max(duration, 1e-9):,.0f} transitions/s), "
            f"accept {100 * accept_rate:.1f}%"
        )
    emp.rename(
        f"Posterior, {engine_name} (compiled, {C} chains), samples: {emp.length:,}, "
        f"accepted: {100 * accept_rate:,.2f}%"
    )
    emp.add_metadata(
        op="posterior",
        num_traces=num_traces,
        inference_engine=str(inference_engine),
        num_chains=C,
        num_steps=num_steps,
        burn_in=burn_in,
        thinning_steps=thinning_steps,
        acceptance_rate=accept_rate,
        reuse_rate=(K - 1) / K,
        warm_start_pool=None if resume is not None else pool,
        warm_start_ess=None if warm_start_ess is None else float(warm_start_ess),
        step_seconds=steps_seconds,
        resumed=resume is not None,
        vectorized=True,
    )
    emp.final_chain_state = final_state
    return emp


def _concat_host_steps(parts):
    """Host chunks of kept steps, each [C, steps, ...], joined on the steps."""
    first = parts[0]
    if first is None:
        return None
    if isinstance(first, dict):
        return {k: _concat_host_steps([p[k] for p in parts]) for k in first}
    if isinstance(first, (tuple, list)):
        return type(first)(_concat_host_steps(list(ps)) for ps in zip(*parts))
    return np.concatenate(parts, axis=1)


def _empirical_of_kept(values, n, file_name):
    """An unweighted Empirical of ``n`` kept values: one array, or a list of
    per-value dicts/tuples when the result is a structure of arrays."""
    if isinstance(values, np.ndarray):
        return Empirical.from_arrays(values, np.zeros(n), effective_sample_size=float(n), file_name=file_name)
    if values is None:
        return Empirical(values=[None] * n, log_weights=np.zeros(n), file_name=file_name)
    rows = [_tree(lambda r: r[i], values) for i in range(n)]
    return Empirical(values=rows, log_weights=np.zeros(n), file_name=file_name)
