"""Sequential Monte Carlo (a particle filter over the observe sequence),
counterpart of ``pyprob_tpu/inference/smc.py``.

A universal-PPL program cannot be paused mid-trace, so resampling uses
**staged replay**: stage r re-runs the whole ``forward`` over all N
particles with the controlled sites *before* observe r replayed from the
(resampled) previous stage and every later site drawn fresh.  A replayed
prefix makes the re-run statistically the same as resuming each particle
at its checkpoint; suffix sites have not been weighted yet, so drawing
them anew is exact.  The cost is one ``forward`` a stage.

On the batched tier (``vectorized_smc_posterior``) each stage is one
``forward`` over ``[N]`` under ``VectorizedHandler`` with
``replay_values``.  The JAX package compiles the whole filter into one
program; here the stage loop is Python and reads each stage's ESS and
log Σw on the host from one launch of kernel 3
(``parallel.collectives.log_weight_stats_host``): one host sync a stage,
plus one a retry round of a ``rejection_sample`` block.  Resampling is
adaptive: it triggers when the ESS falls below ``resample_threshold * N``
(``parallel.collectives.resample_indices``, on the device), and log Z
accumulates at every resample and at the end.  A stage whose ESS is NaN
(a NaN weight) or where every weight is −inf does not resample, as in the
JAX package.  Resampling couples all particles, so there is no chunking:
the N particles are one batch.  With a trained network
(``SEQUENTIAL_MONTE_CARLO_WITH_INFERENCE_NETWORK``) every stage proposes
from it, the replayed sites advance it with ``forced_value=`` and each
site's prior − proposal delta enters the increment of the stage that
commits the site.

On the interpreter tier (``interpreter_smc_posterior``) the same design
runs one trace at a time, the prefix replayed through
``state._set_smc_replay``, with float64 weights on the host; programs
whose particles meet different numbers of observes run to the end.

Caveat on the reported ESS: it is 1/Σw² of the final weights, blind to
genealogy: after a resample many particles share ancestors, so the
accuracy of posterior expectations is lower than the ESS suggests.
"""

from __future__ import annotations

import math
import time
import warnings

import numpy as np
import torch

from .. import util
from ..distributions import Empirical
from ..distributions.empirical import values_of
from ..parallel.collectives import RESAMPLING_SCHEMES, log_weight_stats_host, resample_indices
from ..util import InferenceEngine, TraceMode

_GUIDED = "InferenceEngine.SEQUENTIAL_MONTE_CARLO_WITH_INFERENCE_NETWORK"
_UNGUIDED = "InferenceEngine.SEQUENTIAL_MONTE_CARLO"


def _check_request(observe, resampling):
    if not observe:
        raise RuntimeError("SEQUENTIAL_MONTE_CARLO requires observe={...} values")
    if any(v is None for v in observe.values()):
        raise RuntimeError(f"Observe has missing value(s): {observe}")
    if resampling not in RESAMPLING_SCHEMES:
        raise ValueError(
            f"Unknown resampling scheme {resampling!r}; choose one of {sorted(RESAMPLING_SCHEMES)}"
        )


def _no_observes():
    return RuntimeError("SEQUENTIAL_MONTE_CARLO requires at least one observed site")


def _stage_of(sites):
    """{address: observes met before the site} of the controlled sites:
    stage r replays every site with ``stage_of < r``."""
    stage_of, seen = {}, 0
    for s in sites:
        if s.observed:
            seen += 1
        elif s.control:
            stage_of[s.address] = seen
    return stage_of


def _smc_stages(model, n, observed, resample_threshold, resampling, likelihood_importance,
                proposal_step, generator, args, kwargs):
    """The batched filter's stage loop.  Returns (last handler, its
    outputs, final [n] log-weights, log Z, stage ESSs, resampled flags,
    host syncs)."""
    from ..vectorized import VectorizedHandler, handler_outputs, run_forward

    engine = (
        InferenceEngine.IMPORTANCE_SAMPLING_WITH_INFERENCE_NETWORK
        if proposal_step is not None
        else InferenceEngine.IMPORTANCE_SAMPLING
    )

    def run(replay):
        handler = VectorizedHandler(
            num_particles=n,
            generator=generator,
            trace_mode=TraceMode.POSTERIOR,
            inference_engine=engine,
            observed=observed,
            root_function_name=model.forward.__code__.co_name,
            likelihood_importance=likelihood_importance,
            proposal_step=proposal_step,
            replay_values=replay,
            record_site_log_iws=proposal_step is not None,
        )
        return handler, handler_outputs(handler, run_forward(model, handler, args, kwargs))

    handler, outputs = run(None)
    observe_addrs = [s.address for s in handler.sites if s.observed]
    n_obs = len(observe_addrs)
    if n_obs == 0:
        raise _no_observes()
    stage_of = _stage_of(handler.sites)
    w = torch.zeros((n,), dtype=util.dtype(), device=generator.device)
    log_z, log_n = 0.0, math.log(n)
    stage_ess, resampled, syncs = [], [], 0
    for r in range(1, n_obs + 1):
        incr = outputs["log_probs"][observe_addrs[r - 1]]
        # the prior - proposal deltas (guided SMC) of the sites this stage
        # commits (fresh in run r - 1, replayed from run r on); the last
        # stage also commits every site after the last observe
        log_iws = outputs["site_log_iws"]
        for a, st in stage_of.items():
            if (st == r - 1 or (r == n_obs and st >= r - 1)) and a in log_iws:
                incr = incr + log_iws[a]
        w = w + incr
        ess, log_sum = log_weight_stats_host(w)
        syncs += 1 + handler.host_syncs
        stage_ess.append(ess)
        if r == n_obs:
            break
        # NaN compares False; every weight -inf leaves nothing to resample
        do_resample = log_sum > -math.inf and ess < resample_threshold * n
        resampled.append(bool(do_resample))
        values = outputs["values"]
        if do_resample:
            log_z += log_sum - log_n
            idx = resample_indices(generator, w, n, resampling)
            w = torch.zeros_like(w)
            replay = {a: values[a].index_select(0, idx) for a, st in stage_of.items() if st < r}
        else:
            replay = {a: values[a] for a, st in stage_of.items() if st < r}
        handler, outputs = run(replay)
    log_z += log_sum - log_n
    return handler, outputs, w, log_z, stage_ess, resampled, syncs


@torch.no_grad()
def vectorized_smc_posterior(
    model,
    num_traces,
    observe=None,
    map_func=None,
    file_name=None,
    resample_threshold=0.5,
    resampling="systematic",
    likelihood_importance=1.0,
    mesh=None,
    proposal_step=None,
    args=(),
    kwargs=None,
):
    """SMC posterior over ``num_traces`` particles on the batched tier, as
    one batch (no chunking).  Returns an Empirical with the metadata and
    the attribute ``log_evidence``, or None for a model that does not run
    on this tier (the caller falls back or raises).  ``proposal_step``, a
    trained network's ``cached_vectorized_proposal_step``, makes it guided
    SMC; it is reset before every stage's run and after the filter."""
    from ..vectorized import _TraceabilityCache, _host, _materialize_traces

    if mesh is not None:
        raise NotImplementedError(
            "mesh= (particles over several cards) is not ported yet; it comes with the distributed slice"
        )
    if _TraceabilityCache.known_untraceable(model):
        return None
    _check_request(observe, resampling)
    t0 = time.time()
    results_only = getattr(map_func, "__name__", "") == "trace_result"
    device = util.device()
    observed = {k: util.to_tensor(v, device) for k, v in observe.items()}
    try:
        handler, outputs, w, log_evidence, stage_ess, resampled, syncs = _smc_stages(
            model, num_traces, observed, resample_threshold, resampling, likelihood_importance,
            proposal_step, util.generator(device), args, kwargs,
        )
    except NotImplementedError as e:
        util.log_print(
            f"[pyprob_tpu_torch] model {model.name!r} does not run on the batched tier ({e}); "
            "SMC falls back to the interpreter filter."
        )
        _TraceabilityCache.mark(model, False)
        return None
    finally:
        if proposal_step is not None:
            proposal_step.reset(0)  # no run's batch outlives the filter
    _TraceabilityCache.mark(model, True)
    n_obs = len(stage_ess)

    log_weights = _host(w).astype(np.float64)
    keep = np.isfinite(log_weights)
    if not keep.all():
        warnings.warn(f"Discarding {(~keep).sum()} particles with nan/inf log_weight.")
    ess = stage_ess[-1] if keep.all() else None
    if results_only and isinstance(outputs["result"], torch.Tensor):
        emp = Empirical.from_arrays(
            _host(outputs["result"])[keep], log_weights[keep], effective_sample_size=ess, file_name=file_name
        )
    else:
        outputs["log_importance_weight"] = w
        traces = _materialize_traces(handler.sites, outputs, [[s.distribution for s in handler.sites]], [num_traces])
        values = traces if map_func is None else [map_func(t) for t in traces]
        emp = Empirical(
            values=values_of([v for v, k in zip(values, keep) if k]),
            log_weights=log_weights[keep],
            effective_sample_size=ess,
            file_name=file_name,
        )
    emp.log_evidence = log_evidence
    kind = "guided SMC" if proposal_step is not None else "SMC"
    emp.rename(
        f"Posterior, {kind} (batched, {n_obs} stages), particles: {emp.length:,}, "
        f"ESS: {emp.effective_sample_size:,.2f}"
    )
    emp.add_metadata(
        op="posterior",
        num_traces=num_traces,
        inference_engine=_GUIDED if proposal_step is not None else _UNGUIDED,
        effective_sample_size=emp.effective_sample_size,
        log_evidence=log_evidence,
        resample_threshold=resample_threshold,
        resampling=resampling,
        stages=n_obs,
        stage_ess=stage_ess,
        resampled_stages=resampled,
        host_syncs=syncs,
        vectorized=True,
    )
    if util.verbosity() > 1:
        util.log_print(
            f"[SMC] {num_traces:,} particles x {n_obs} stages in {time.time() - t0:.3f}s, "
            f"ESS {emp.effective_sample_size:,.1f}, log Z {log_evidence:.4f}"
        )
    return emp


def _host_resample_indices(rng, log_weights, num_samples, scheme):
    """Host (numpy, float64) mirror of ``parallel.resample_indices`` for
    the interpreter tier, drawing from the numpy generator ``rng``."""
    w = np.exp(log_weights - log_weights.max())
    w = w / w.sum()
    n = num_samples
    if scheme == "systematic":
        points = (rng.random() + np.arange(n)) / n
    elif scheme == "stratified":
        points = (rng.random(n) + np.arange(n)) / n
    elif scheme == "multinomial":
        points = rng.random(n)
    elif scheme == "residual":
        counts = np.floor(n * w).astype(np.int64)
        det = np.repeat(np.arange(w.size), counts)
        rem = n - det.size
        resid = n * w - counts
        resid_sum = resid.sum()
        if rem == 0:
            return det[:n]
        if resid_sum <= 0.0:
            # every residual underflowed but the floor counts fall short of
            # n: pad with the heaviest particle, so n indices come back
            return np.concatenate([det, np.full(rem, int(np.argmax(w)))])
        resid_cdf = np.cumsum(resid / resid_sum)
        extra = np.minimum(np.searchsorted(resid_cdf, rng.random(rem)), w.size - 1)
        return np.concatenate([det, extra])
    else:
        raise ValueError(
            f"Unknown resampling scheme {scheme!r}; choose one of {sorted(RESAMPLING_SCHEMES)}"
        )
    return np.minimum(np.searchsorted(np.cumsum(w), points), w.size - 1)


def _logsumexp(w):
    m = w.max()
    if m == -np.inf:
        return -math.inf
    return float(m + np.log(np.exp(w - m).sum()))


def interpreter_smc_posterior(
    model,
    num_traces,
    observe=None,
    map_func=None,
    file_name=None,
    resample_threshold=0.5,
    resampling="systematic",
    likelihood_importance=1.0,
    args=(),
    kwargs=None,
):
    """SMC on the interpreter tier, for models that do not run on the
    batched tier: each stage re-runs every particle's ``forward`` with the
    controlled sites before the stage's observe replayed from its
    (resampled) ancestor (``state._set_smc_replay``).  Control flow up to
    that observe follows the replayed values, so a branching program stays
    on its ancestor's path.  Weights are float64 on the host; the
    resampling uniforms come from the numpy generator (``util.get_rng``).

    Particles may meet different numbers of observes: the filter runs as
    many stages as the most observes, and a particle past its last observe
    carries a zero increment and keeps its trace (it has reached the final
    target) while it takes part in resampling."""
    from .. import state
    from ..model import empirical_of, trace_id

    _check_request(observe, resampling)
    t0 = time.time()
    n = num_traces
    generator = model._trace_generator(
        trace_mode=TraceMode.POSTERIOR,
        inference_engine=InferenceEngine.IMPORTANCE_SAMPLING,
        observe=observe,
        likelihood_importance=likelihood_importance,
        *args,
        **(kwargs or {}),
    )

    def run_particle(replay):
        state._set_smc_replay(replay)
        try:
            return next(generator)
        finally:
            state._set_smc_replay(None)

    traces = [run_particle(None) for _ in range(n)]
    n_obs = max(len(t.variables_observed) for t in traces)
    if n_obs == 0:
        raise _no_observes()
    rng = util.get_rng()
    w = np.zeros(n, dtype=np.float64)
    log_z, log_n = 0.0, math.log(n)
    stage_ess, resampled_stages = [], []
    for r in range(1, n_obs + 1):
        for i, t in enumerate(traces):
            if r <= len(t.variables_observed):
                w[i] += float(t.variables_observed[r - 1].log_prob)
        w[~np.isfinite(w)] = -np.inf
        ess = float(util.effective_sample_size(w))
        stage_ess.append(ess)
        if r == n_obs:
            break
        resampled_stages.append(ess < resample_threshold * n)
        if resampled_stages[-1]:
            log_z += _logsumexp(w) - log_n
            ancestors = [traces[j] for j in _host_resample_indices(rng, w, n, resampling)]
            w[:] = 0.0
        else:
            ancestors = list(traces)
        new_traces = []
        for a in ancestors:
            replay, seen_obs, committed = {}, 0, True
            for v in a.variables:
                if v.observed:
                    seen_obs += 1
                    if seen_obs >= r:
                        committed = False
                        break
                elif v.control:
                    replay[v.address] = v.value
            # a trace without observe r is final: kept as it is (a re-run
            # would draw its committed suffix anew)
            new_traces.append(a if committed else run_particle(replay))
        traces = new_traces
    log_z += _logsumexp(w) - log_n

    map_func = map_func or trace_id
    keep = np.isfinite(w)
    emp = empirical_of([map_func(t) for t, k in zip(traces, keep) if k], w[keep], file_name)
    emp.log_evidence = log_z
    emp.rename(
        f"Posterior, SMC (interpreter, {n_obs} stages), particles: {emp.length:,}, "
        f"ESS: {emp.effective_sample_size:,.2f}"
    )
    emp.add_metadata(
        op="posterior",
        num_traces=num_traces,
        inference_engine=_UNGUIDED,
        effective_sample_size=emp.effective_sample_size,
        log_evidence=log_z,
        resample_threshold=resample_threshold,
        resampling=resampling,
        stages=n_obs,
        stage_ess=stage_ess,
        resampled_stages=resampled_stages,
        vectorized=False,
    )
    if util.verbosity() > 1:
        util.log_print(
            f"[SMC interpreter] {num_traces:,} particles x {n_obs} stages in {time.time() - t0:.3f}s, "
            f"ESS {emp.effective_sample_size:,.1f}, log Z {log_z:.4f}"
        )
    return emp
