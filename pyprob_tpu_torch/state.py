"""The ``sample`` / ``observe`` / ``factor`` / ``tag`` / ``rejection_sample``
effect entry points and the interpreter tier.

Counterpart of ``pyprob_tpu/state.py``.  User models call these
module-level functions.  While the batched tier (``vectorized.py``) runs
``forward`` it installs a handler, and they dispatch to it.  Otherwise,
inside a trace begun by ``_begin_trace``, they run the interpreter tier:
one trace at a time, every site recorded in a ``Trace`` under the
thread's own context (``_Context``), per engine:

* PRIOR / PRIOR_FOR_INFERENCE_NETWORK: draw from the (optionally
  inflated) prior; observes draw their values in the second mode;
* POSTERIOR + IMPORTANCE_SAMPLING: prior proposals, weight from observes;
* POSTERIOR + IC: the inference network proposes each controlled site
  (``_infer_step``), weight log p − log q; rejection retries draw from the
  defensive mixture π·q + (1 − π)·prior, π = 0.5;
* POSTERIOR + LMH / RMH: a candidate trace of a Metropolis-Hastings chain
  (``Model._mcmc_posterior``).  Every sample site is controlled.  The
  chosen site is resampled (``_mh_site_resample``: LMH from the prior, RMH
  from the α = 0.5 mixture of a random-walk kernel and the prior, with the
  transition log-ratio kept for the acceptance test); every other site the
  current trace holds reuses its value, rescored under the candidate's
  parameters, and is resampled where that score is not finite.

Values are drawn and scored on the host with an explicit CPU
``torch.Generator`` (the context's, else the CPU generator of
``util.generator``), and ``sample`` returns a 0-d (or shaped) CPU tensor:
a model that calls ``float(x)`` never waits on the card.  Distributions
built from plain numbers inside a trace put their parameters on the CPU
(``util.param_device``); the network, the loss and the kernels run on the
card.  ``_set_smc_replay`` pins controlled sites to given values in the
prior modes (``Model.posterior_predictive``) and under IS
(``inference.smc.interpreter_smc_posterior``'s prefix replay).  The
gradient engines and ``sample(mask=)``/``observe(mask=)`` come with the
gradient-engine and Markov slices and raise here.  Without a handler or
a trace, ``sample`` just draws and ``rejection_sample`` is a plain host
loop.
"""

from __future__ import annotations

import math
import threading
import time
import warnings

import numpy as np
import torch

from . import util
from .address import extract_address
from .distributions import Categorical, Factor, Normal, Uniform
from .trace import Trace, Variable
from .util import InferenceEngine, PriorInflation, TraceMode

_WEIGHTED = (
    InferenceEngine.IMPORTANCE_SAMPLING,
    InferenceEngine.IMPORTANCE_SAMPLING_WITH_INFERENCE_NETWORK,
)
_MCMC = (
    InferenceEngine.LIGHTWEIGHT_METROPOLIS_HASTINGS,
    InferenceEngine.RANDOM_WALK_METROPOLIS_HASTINGS,
)
_SMC = (
    InferenceEngine.SEQUENTIAL_MONTE_CARLO,
    InferenceEngine.SEQUENTIAL_MONTE_CARLO_WITH_INFERENCE_NETWORK,
)
# the chain engines of the gradient engines' base (inference/hmc.py)
_GRADIENT_CHAINS = (
    InferenceEngine.HAMILTONIAN_MONTE_CARLO,
    InferenceEngine.NO_U_TURN_SAMPLER,
)
# the gradient engines: batched tier only
_GRADIENT = _GRADIENT_CHAINS + (InferenceEngine.LAPLACE,)
# mixture weight on the learned proposal for rejection-retry attempts
# (defensive importance sampling, Hesterberg 1995)
_DEFENSIVE_PI = 0.5


def _engines_later(what):
    return NotImplementedError(
        f"{what} is not ported yet; it comes with the tempered and variational engines slice"
    )


class _Context:
    def __init__(self):
        self.trace_mode = TraceMode.PRIOR
        self.inference_engine = InferenceEngine.IMPORTANCE_SAMPLING
        self.prior_inflation = PriorInflation.DISABLED
        self.likelihood_importance = 1.0
        self.current_trace = None
        self.root_function_name = None
        self.inference_network = None
        self.previous_variable = None
        self.observed_variables = {}
        self.execution_start = None
        self.rng = None  # a CPU torch.Generator (None: util.generator("cpu"))
        # True while re-running a rejection_sample attempt after the first:
        # retries draw from the defensive mixture (no inflation)
        self.rejection_retry = False
        # LMH / RMH: the chain's current trace, the address of the site to
        # resample and the transition log-ratio of the resampled site (None
        # until the candidate meets that site)
        self.metropolis_hastings_trace = None
        self.metropolis_hastings_site_address = None
        self.metropolis_hastings_site_transition_log_prob = None
        # {full_address: value}: controlled sites take these values in the
        # prior modes (the posterior-predictive replay) and under IS (SMC's
        # prefix replay)
        self.smc_replay_values = None


class _ContextLocal(threading.local):
    """One interpreter context per thread: concurrent trace executions (the
    lockstep workers) each get their own trace state."""

    def __init__(self):
        self.value = _Context()


_ctx_local = _ContextLocal()


def _get_rng():
    rng = _ctx_local.value.rng
    return rng if rng is not None else util.generator("cpu")


def _set_smc_replay(replay_values):
    """Install (a dict) or clear (None) the replay values of the thread's
    next traces."""
    _ctx_local.value.smc_replay_values = replay_values


def _swap_context(ctx):
    """Install ``ctx`` as the current thread's interpreter context and
    return the previous one."""
    prev = _ctx_local.value
    _ctx_local.value = ctx
    return prev


# Handler installed by the batched tier; one per thread.
_handler_local = threading.local()


def _set_handler(handler):
    prev = getattr(_handler_local, "value", None)
    _handler_local.value = handler
    return prev


def _get_handler():
    return getattr(_handler_local, "value", None)


def _on_host(distribution):
    """``distribution`` with its parameters on the CPU (a distribution
    built from tensors on the card is copied once)."""
    leaves = distribution._leaves() if type(distribution)._param_names else ()
    if all(leaf.device.type == "cpu" for leaf in leaves):
        return distribution
    return distribution._with_leaves([leaf.cpu() for leaf in leaves])


def _host_tensor(value):
    """A stored value as a CPU tensor (a batched-tier trace holds numpy
    values), its dtype kept."""
    if isinstance(value, torch.Tensor):
        return value
    return torch.as_tensor(value.copy() if isinstance(value, np.ndarray) else np.asarray(value))


def _as_value(distribution, value):
    """A draw shaped as one value of ``distribution`` (a proposal's draw
    has its batch of one)."""
    shape = tuple(distribution.batch_shape) + tuple(distribution.event_shape)
    return value if tuple(value.shape) == shape else value.reshape(shape)


_LOG_SQRT_2PI = 0.5 * math.log(2.0 * math.pi)


def _score(distribution, value):
    """``float(distribution.log_prob(value, sum=True))``.  A Normal or a
    Uniform of 0-d parameters scoring a 0-d value is scored in float64 on
    the Python side, and a Categorical of one row scoring an integer value
    reads its logit: ``log_prob`` there is a few torch calls of a few µs
    each, a large share of a site's host time (``profile_host_score.py``
    times the first two)."""
    if value is not None and value.dim() == 0 and distribution.batch_shape == ():
        if type(distribution) is Normal:
            z = (float(value) - float(distribution.loc)) / float(distribution.scale)
            return -0.5 * z * z - math.log(float(distribution.scale)) - _LOG_SQRT_2PI
        if type(distribution) is Uniform:
            v, low, high = float(value), float(distribution.low), float(distribution.high)
            return -math.log(high - low) if low <= v <= high else -math.inf
        if type(distribution) is Categorical and not value.is_floating_point():
            # the logit log_prob's gather reads: 0 <= value < categories
            i = int(value)
            if 0 <= i < distribution.num_categories:
                return float(distribution.logits[i])
    return float(distribution.log_prob(value, sum=True))


def _logaddexp(a, b):
    m = max(a, b)
    if m == -math.inf:
        return m
    return m + math.log(math.exp(a - m) + math.exp(b - m))


def _inflate(distribution):
    """Prior inflation for spreading IS proposals."""
    if _ctx_local.value.prior_inflation == PriorInflation.ENABLED:
        if isinstance(distribution, Categorical):
            n = distribution.num_categories
            return Categorical(probs=torch.full((n,), 1.0 / n, dtype=util.dtype()))
        if isinstance(distribution, Normal):
            return Normal(distribution.mean, distribution.stddev * 3)
    return None


def _build_address(address, distribution, trace):
    ctx = _ctx_local.value
    if address is None:
        address_base = (
            extract_address(ctx.root_function_name) + "__" + distribution.address_suffix
        )
    else:
        address_base = address + "__" + distribution.address_suffix
    instance = trace.last_instance(address_base) + 1
    return address_base, address_base + "__" + str(instance), instance


def tag(value, name=None, address=None):
    handler = _get_handler()
    if handler is not None:
        return handler.tag(value, name=name, address=address)
    ctx = _ctx_local.value
    trace = ctx.current_trace
    if trace is None:
        return None
    if address is None:
        address_base = extract_address(ctx.root_function_name) + "__None"
    else:
        address_base = address + "__None"
    instance = trace.last_instance(address_base) + 1
    trace.add(
        Variable(
            distribution=None,
            value=value,
            address_base=address_base,
            address=address_base + "__" + str(instance),
            instance=instance,
            log_prob=0.0,
            tagged=True,
            name=name,
        )
    )
    return None


def factor(log_prob=None, log_prob_func=None, name=None, address=None, mask=None):
    handler = _get_handler()
    if handler is not None:
        return handler.factor(
            log_prob=log_prob, log_prob_func=log_prob_func, name=name,
            address=address, mask=mask,
        )
    if mask is not None:
        raise NotImplementedError("factor(mask=) is not ported yet; it comes with the Markov/SMC slice")
    return observe(Factor(log_prob=log_prob, log_prob_func=log_prob_func), name=name, address=address)


def observe(distribution, value=None, name=None, address=None, mask=None):
    handler = _get_handler()
    if handler is not None:
        return handler.observe(distribution, value=value, name=name, address=address, mask=mask)
    if mask is not None:
        raise NotImplementedError(
            "observe(mask=) sites are not ported yet; they come with the Markov/SMC slice"
        )
    ctx = _ctx_local.value
    trace = ctx.current_trace
    if trace is None:
        return None
    distribution = _on_host(distribution)
    address_base, full_address, instance = _build_address(address, distribution, trace)
    if name in ctx.observed_variables:
        value = ctx.observed_variables[name]
    elif value is not None:
        value = util.to_tensor(value, "cpu")
    elif ctx.trace_mode == TraceMode.PRIOR_FOR_INFERENCE_NETWORK:
        value = distribution.sample(_get_rng())
    if value is None and not isinstance(distribution, Factor):
        observed, log_prob, log_importance_weight = False, None, None
    else:
        observed = True
        log_prob = ctx.likelihood_importance * _score(distribution, value)
        log_importance_weight = log_prob if ctx.inference_engine in _WEIGHTED else None
    trace.add(
        Variable(
            distribution=distribution,
            value=value,
            address_base=address_base,
            address=full_address,
            instance=instance,
            log_prob=log_prob,
            log_importance_weight=log_importance_weight,
            observed=observed,
            name=name,
        )
    )
    return value


def sample(distribution, name=None, address=None, control=True, mask=None):
    handler = _get_handler()
    if handler is not None:
        return handler.sample(
            distribution, name=name, address=address, control=control, mask=mask
        )
    ctx = _ctx_local.value
    trace = ctx.current_trace
    if trace is None:
        return distribution.sample()
    if mask is not None:
        raise NotImplementedError(
            "sample(mask=) sites are not ported yet; they come with the Markov/SMC slice"
        )
    distribution = _on_host(distribution)
    rng = _get_rng()
    address_base, full_address, instance = _build_address(address, distribution, trace)
    engine = ctx.inference_engine
    if engine in _MCMC:
        control = True  # the MCMC engines control every sample site

    if name in ctx.observed_variables:
        # a sample site overridden by a named observation
        value = ctx.observed_variables[name]
        log_prob = ctx.likelihood_importance * _score(distribution, value)
        trace.add(
            Variable(
                distribution=distribution,
                value=value,
                address_base=address_base,
                address=full_address,
                instance=instance,
                log_prob=log_prob,
                log_importance_weight=log_prob if engine in _WEIGHTED else None,
                observed=True,
                name=name,
            )
        )
        return value

    if ctx.trace_mode == TraceMode.POSTERIOR and engine in _MCMC:
        value, log_prob, reused = _mh_sample(ctx, distribution, rng, full_address)
        trace.add(
            Variable(
                distribution=distribution,
                value=value,
                address_base=address_base,
                address=full_address,
                instance=instance,
                log_prob=log_prob,
                control=True,
                name=name,
                reused=reused,
            )
        )
        return value
    if (
        control
        and ctx.smc_replay_values is not None
        and (ctx.trace_mode != TraceMode.POSTERIOR or engine == InferenceEngine.IMPORTANCE_SAMPLING)
    ):
        replayed = ctx.smc_replay_values.get(full_address)
        if replayed is not None:
            # the posterior-predictive replay (the latent keeps a posterior
            # draw's value while the observes draw theirs) and SMC's prefix
            # replay (the site keeps its resampled ancestor's value, scored
            # and unweighted)
            trace.add(
                Variable(
                    distribution=distribution,
                    value=replayed,
                    address_base=address_base,
                    address=full_address,
                    instance=instance,
                    log_prob=_score(distribution, replayed),
                    control=True,
                    name=name,
                    reused=True,
                )
            )
            return replayed
    if (
        ctx.trace_mode == TraceMode.POSTERIOR
        and engine == InferenceEngine.IMPORTANCE_SAMPLING_WITH_INFERENCE_NETWORK
        and control
    ):
        variable = Variable(
            distribution=distribution,
            address_base=address_base,
            address=full_address,
            instance=instance,
            control=True,
            name=name,
        )
        proposal = ctx.inference_network._infer_step(
            variable, prev_variable=ctx.previous_variable
        )
        if ctx.rejection_retry and proposal is not distribution:
            # a retry draws from the defensive mixture π·q + (1−π)·prior: a
            # rejected attempt's p/q enters the weight with no likelihood
            # term, and the mixture caps that factor at 1/(1−π); exact
            # because the weight scores against the mixture's density
            if float(torch.rand((), generator=rng)) < _DEFENSIVE_PI:
                value = proposal.sample(rng)
            else:
                value = distribution.sample(rng)
            value = _as_value(distribution, value)
            log_prob = _score(distribution, value)
            proposal_log_prob = _logaddexp(
                math.log(_DEFENSIVE_PI) + float(proposal.log_prob(value, sum=True)),
                math.log1p(-_DEFENSIVE_PI) + log_prob,
            )
        else:
            value = _as_value(distribution, proposal.sample(rng))
            # a lockstep round scored both densities of its draw on the card
            pair_of = getattr(proposal, "pair_of", None)
            pair = pair_of(value) if pair_of is not None else None
            if pair is not None:
                log_prob, proposal_log_prob = pair
            else:
                log_prob = _score(distribution, value)
                proposal_log_prob = float(proposal.log_prob(value, sum=True))
        if not math.isfinite(log_prob):
            warnings.warn(f"Prior log_prob has NaN/inf. dist: {distribution} value: {value}")
        if not math.isfinite(proposal_log_prob):
            warnings.warn(f"Proposal log_prob has NaN/inf. dist: {proposal} value: {value}")
        variable.value = value
        variable.log_prob = log_prob
        variable.log_importance_weight = log_prob - proposal_log_prob
        ctx.previous_variable = variable
        trace.add(variable)
        return value

    if ctx.trace_mode == TraceMode.POSTERIOR and engine != InferenceEngine.IMPORTANCE_SAMPLING:
        # an uncontrolled site under IC: from the prior, unweighted
        value = distribution.sample(rng)
        log_prob, log_importance_weight = _score(distribution, value), None
    else:
        value, log_prob, log_importance_weight = _sample_from_prior(distribution, rng)
    trace.add(
        Variable(
            distribution=distribution,
            value=value,
            address_base=address_base,
            address=full_address,
            instance=instance,
            log_prob=log_prob,
            log_importance_weight=log_importance_weight,
            control=control,
            name=name,
        )
    )
    return value


def rejection_sample(attempt_fn, max_attempts=None):
    """Rejection sampling with replacement semantics.

    ``attempt_fn()`` runs model code containing ``sample`` calls and
    returns ``(output, accept)``; attempts repeat until ``accept`` is true
    and the accepted attempt *replaces* the rejected ones in the trace, so
    a block's sites keep stable addresses (instance 1).  On the batched
    tier the loop runs over the whole particle batch, retrying the lanes
    still pending (``VectorizedHandler.rejection_sample``).

    On the interpreter tier, under guided IS, the network proposes every
    attempt: its recurrent state is restored to the pre-block snapshot per
    retry (training traces record only accepted attempts) and retries draw
    from the defensive mixture π·q + (1 − π)·prior (π = 0.5).  The weight
    takes log p − log q of every attempt executed, accepted or not: exact
    by the extended-space argument (the target and the proposal processes
    both define densities over the sequence of executed attempts, with
    ratio Π p(x_i)/q(x_i)).  ``observe``/``factor``/``tag`` inside
    ``attempt_fn`` are not supported.  ``max_attempts`` (default 1e6 here,
    64 on the batched tier) bounds the loop; exhausting it marks the trace
    invalid (weight −inf), as the batched tier does.  With no handler and
    no trace it is a plain host loop that returns the accepted output."""
    handler = _get_handler()
    if handler is not None:
        return handler.rejection_sample(attempt_fn, max_attempts=max_attempts)
    ctx = _ctx_local.value
    trace = ctx.current_trace
    cap = int(max_attempts) if max_attempts else 1_000_000
    if trace is None:
        for _ in range(cap):
            out, accept = attempt_fn()
            if bool(torch.all(torch.as_tensor(accept))):
                return out
        raise RuntimeError(f"rejection_sample exceeded {cap:,} attempts without acceptance")
    if ctx.rejection_retry:
        raise RuntimeError("nested rejection_sample is not supported inside a retried attempt")
    prev_variable = ctx.previous_variable
    network = (
        ctx.inference_network
        if ctx.trace_mode == TraceMode.POSTERIOR
        and ctx.inference_engine == InferenceEngine.IMPORTANCE_SAMPLING_WITH_INFERENCE_NETWORK
        else None
    )
    network_state = network._infer_lstm_state if network is not None else None
    prev_attempts_iw = 0.0
    out, new_vars = None, []
    try:
        for i in range(cap):
            marker = len(trace.variables)
            out, accept = attempt_fn()
            new_vars = trace.variables[marker:]
            if any(v.observed or v.tagged for v in new_vars):
                trace.rollback(marker)
                raise RuntimeError("observe/factor/tag inside rejection_sample is not supported")
            if i == 0 and not new_vars:
                raise RuntimeError("rejection_sample block contains no sample sites")
            if bool(torch.all(torch.as_tensor(accept))):
                if prev_attempts_iw != 0.0:
                    # the rejected attempts' corrections enter the weight
                    # beside the accepted attempt's own
                    for v in new_vars:
                        if v.control:
                            v.log_importance_weight = (v.log_importance_weight or 0.0) + prev_attempts_iw
                            break
                return out
            if all(v.reused for v in new_vars):
                # every value of the block came from the MH chain's trace: a
                # retry would repeat it, so the stored values violate the
                # predicate under the candidate's outer latents
                break
            if i == cap - 1:
                break  # keep the last attempt recorded to mark the trace
            prev_attempts_iw += sum(
                v.log_importance_weight for v in new_vars if v.log_importance_weight is not None
            )
            trace.rollback(marker)
            ctx.previous_variable = prev_variable
            if network is not None:
                network._infer_lstm_state = network_state
            ctx.rejection_retry = True
    finally:
        ctx.rejection_retry = False
    warnings.warn(
        "rejection_sample: the acceptance predicate cannot be satisfied (cap "
        f"{cap:,} attempts, or the MH chain's stored values violate it); trace marked invalid."
    )
    if ctx.trace_mode == TraceMode.POSTERIOR and ctx.inference_engine in _MCMC:
        # an invalid candidate: the acceptance test rejects it
        t = ctx.metropolis_hastings_site_transition_log_prob
        ctx.metropolis_hastings_site_transition_log_prob = (0.0 if t is None else t) - math.inf
        return out
    marked = next((v for v in new_vars if v.control), new_vars[0] if new_vars else None)
    if marked is not None:
        marked.log_importance_weight = -math.inf
    return out


def _mh_sample(ctx, distribution, rng, address):
    """A candidate's value at ``address``: (value, log_prob, reused).  The
    chosen site is resampled; a site the current trace holds reuses its
    value, rescored, or is drawn from the prior where that score is not
    finite (or the value no longer fits the distribution); a new site is
    drawn from the prior."""
    mh_trace = ctx.metropolis_hastings_trace
    if mh_trace is not None:
        if address == ctx.metropolis_hastings_site_address:
            value, log_prob = _mh_site_resample(ctx, distribution, rng, address)
            return value, log_prob, False
        old = mh_trace.variables_dict_address.get(address)
        if old is not None:
            try:
                value = _host_tensor(old.value)
                log_prob = _score(distribution, value)
                if math.isfinite(log_prob):
                    return value, log_prob, True
            except (RuntimeError, ValueError, TypeError, IndexError):
                pass
    value = _as_value(distribution, distribution.sample(rng))
    return value, _score(distribution, value), False


def _mh_site_resample(ctx, distribution, rng, address):
    """Resample the chosen MH site: LMH from the prior; RMH from the α = 0.5
    mixture of a random-walk kernel (``inference.mcmc._rmh_kernel``:
    Normal(x, σ) for a Normal prior, a TruncatedNormal of width 0.1 (high −
    low) for a Uniform one) and the prior, keeping the transition log-ratio
    for the acceptance test (0 for LMH and for a site with no kernel)."""
    from .inference.mcmc import RMH_ALPHA, _rmh_kernel, rmh_log_ratio, rmh_log_ratio_scalar

    ctx.metropolis_hastings_site_transition_log_prob = 0.0
    if ctx.inference_engine == InferenceEngine.RANDOM_WALK_METROPOLIS_HASTINGS:
        old = ctx.metropolis_hastings_trace.variables_dict_address[address]
        old_value = _host_tensor(old.value)
        forward = _rmh_kernel(distribution, old_value)
        if forward is not None:
            if float(torch.rand((), generator=rng)) < RMH_ALPHA:
                value = forward.sample(rng)
            else:
                value = distribution.sample(rng)
            value = _as_value(distribution, value)
            log_prob = _score(distribution, value)
            if distribution.batch_shape == () and value.dim() == 0:
                t = rmh_log_ratio_scalar(distribution, old_value, float(old.log_prob), value, log_prob)
            else:
                t = float(rmh_log_ratio(distribution, old_value, float(old.log_prob), value, log_prob, torch.sum))
            ctx.metropolis_hastings_site_transition_log_prob = t
            return value, log_prob
    value = _as_value(distribution, distribution.sample(rng))
    return value, _score(distribution, value)


def _sample_from_prior(distribution, rng):
    inflated = None if _ctx_local.value.rejection_retry else _inflate(distribution)
    if inflated is None:
        value = distribution.sample(rng)
        return value, _score(distribution, value), None
    value = inflated.sample(rng)
    log_prob = _score(distribution, value)
    return value, log_prob, log_prob - _score(inflated, value)


def _init_traces(
    func,
    trace_mode=TraceMode.PRIOR,
    prior_inflation=PriorInflation.DISABLED,
    inference_engine=InferenceEngine.IMPORTANCE_SAMPLING,
    inference_network=None,
    observe=None,
    metropolis_hastings_trace=None,
    likelihood_importance=1.0,
):
    """Set up the thread's context for a run of traces of ``func``.
    Observed values become CPU tensors once here.  Under LMH / RMH with the
    chain's current trace, one of its controlled sites is chosen to be
    resampled, uniformly."""
    if trace_mode == TraceMode.POSTERIOR and inference_engine not in _WEIGHTED + _MCMC:
        raise _engines_later(inference_engine.name)
    util.device()  # raises without a card unless the CPU was asked for
    ctx = _ctx_local.value
    ctx.trace_mode = trace_mode
    ctx.inference_engine = inference_engine
    ctx.prior_inflation = prior_inflation
    ctx.likelihood_importance = likelihood_importance
    ctx.root_function_name = func.__code__.co_name
    ctx.metropolis_hastings_trace = metropolis_hastings_trace
    ctx.metropolis_hastings_site_address = None
    ctx.metropolis_hastings_site_transition_log_prob = None
    if metropolis_hastings_trace is not None:
        variables = metropolis_hastings_trace.variables_controlled
        if not variables:
            raise RuntimeError("Cannot run MCMC on a trace with no sample sites.")
        pick = int(torch.randint(len(variables), (), generator=_get_rng()))
        ctx.metropolis_hastings_site_address = variables[pick].address
    if observe is None:
        ctx.observed_variables = {}
    else:
        if any(v is None for v in observe.values()):
            raise RuntimeError(f"Observe has missing value(s): {observe}")
        ctx.observed_variables = {k: util.to_tensor(v, "cpu") for k, v in observe.items()}
    ctx.inference_network = inference_network
    if inference_network is None:
        if inference_engine == InferenceEngine.IMPORTANCE_SAMPLING_WITH_INFERENCE_NETWORK:
            raise ValueError(
                "Cannot run IMPORTANCE_SAMPLING_WITH_INFERENCE_NETWORK without an inference network."
            )
    else:
        inference_network._infer_init(ctx.observed_variables)


def _begin_trace():
    ctx = _ctx_local.value
    ctx.execution_start = time.time()
    ctx.current_trace = Trace()
    ctx.previous_variable = None
    if ctx.inference_network is not None:
        ctx.inference_network._infer_begin_trace()
    util._interpreter_thread.active = True


def _end_trace(result):
    trace = _abort_trace()
    trace.end(result, time.time() - _ctx_local.value.execution_start)
    return trace


def _abort_trace():
    """Leave the thread's trace (after a failed ``forward`` too); returns it."""
    ctx = _ctx_local.value
    util._interpreter_thread.active = False
    trace, ctx.current_trace = ctx.current_trace, None
    return trace
