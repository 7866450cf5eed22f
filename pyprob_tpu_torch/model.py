"""Model API (counterpart of ``pyprob_tpu/model.py``).

The user subclasses ``Model`` and implements ``forward`` calling
``pyprob_tpu_torch.sample`` / ``observe``.  The port runs the prior and
importance sampling, from the prior (IS) or from an inference network
(IC), on two tiers: the batched tier (``pyprob_tpu_torch.vectorized``, N
particles a ``forward`` call) and the interpreter tier (``state.py``, one
trace at a time on the host).  ``vectorized=True`` asks for the first,
``False`` for the second; ``None`` tries the batched tier and falls back
to the interpreter for a model whose ``forward`` cannot run there (it
branches on sampled values), remembering that per model class.  A model
class with ``_never_vectorize = True`` runs on the interpreter tier with
``None`` and with ``True``, as in the JAX package.  IC on the
interpreter tier runs lockstep by default (``interpreter_lockstep.py``).
It trains a feedforward (the default) or an LSTM inference network online
or from trace files (``learn_inference_network``; ``save_dataset`` writes
the files), and keeps it in a file (``save_inference_network``,
``load_inference_network``).  Results go to an Empirical file with
``file_name=``.  ``sample`` draws one interpreter-tier trace
(``get_trace`` is its deprecated name).  LMH and RMH run as parallel chains
on the batched tier (``inference.mcmc``, resumable from a ``ChainState``)
and as the reference's sequential chain on the interpreter tier.  SMC
(``inference.smc``) is a staged-replay particle filter on both tiers,
guided by the network on the batched tier.  The gradient engines (HMC,
NUTS, LAPLACE, and ``map_estimate``; ``inference.hmc``, ``nuts``,
``laplace``) differentiate one batched replay of ``forward`` and run on
the batched tier only.  ``posterior_predictive``
replays a trace-valued posterior's latents with fresh observes; ``condition`` (``filter``) wraps a model in a
``ConditionalModel`` that keeps the traces meeting a criterion;
``parallel`` gives a ``ParallelModel`` that spreads interpreter-tier
traces over spawned processes.  The other engines come with later slices
and raise ``NotImplementedError``.
"""

from __future__ import annotations

import io
import math
import multiprocessing
import os
import pickle
import shutil
import tempfile
import time
import uuid
import warnings

import numpy as np
import torch

from . import state, util
from .distributions import Empirical
from .distributions.empirical import values_of
from .trace import _total
from .util import (
    InferenceEngine,
    InferenceNetwork,
    LearningRateScheduler,
    Optimizer,
    PriorInflation,
    TraceMode,
)


def trace_result(trace):
    return trace.result


def trace_id(trace):
    return trace


def empirical_of(values, log_weights, file_name=None):
    """An Empirical of the kept traces' mapped values: one numpy array when
    every value is a number or a tensor of one shape, else the list; with
    ``file_name``, appended to that Empirical file."""
    values = values_of(values)
    if isinstance(values, np.ndarray):
        return Empirical.from_arrays(values, log_weights, file_name=file_name)
    return Empirical(values=values, log_weights=log_weights, file_name=file_name)


class Model:
    def __init__(self, name="Unnamed pyprob_tpu_torch model"):
        self.name = name
        self._inference_network = None

    def __repr__(self):
        return f"Model(name:{self.name})"

    def forward(self):
        raise RuntimeError("Model instances must provide a forward method.")

    # ------------------------------------------------------------------
    # trace generation (interpreter tier)
    # ------------------------------------------------------------------
    def _trace_generator(
        self,
        trace_mode=TraceMode.PRIOR,
        prior_inflation=PriorInflation.DISABLED,
        inference_engine=InferenceEngine.IMPORTANCE_SAMPLING,
        inference_network=None,
        observe=None,
        metropolis_hastings_trace=None,
        likelihood_importance=1.0,
        *args,
        **kwargs,
    ):
        state._init_traces(
            func=self.forward,
            trace_mode=trace_mode,
            prior_inflation=prior_inflation,
            inference_engine=inference_engine,
            inference_network=inference_network,
            observe=observe,
            metropolis_hastings_trace=metropolis_hastings_trace,
            likelihood_importance=likelihood_importance,
        )
        while True:
            state._begin_trace()
            try:
                result = self.forward(*args, **kwargs)
            except BaseException:
                state._abort_trace()
                raise
            yield state._end_trace(result)

    def _traces(
        self,
        num_traces=10,
        trace_mode=TraceMode.PRIOR,
        prior_inflation=PriorInflation.DISABLED,
        inference_engine=InferenceEngine.IMPORTANCE_SAMPLING,
        inference_network=None,
        map_func=None,
        silent=False,
        observe=None,
        file_name=None,
        likelihood_importance=1.0,
        *args,
        **kwargs,
    ):
        """``num_traces`` interpreter-tier traces, one after another, as an
        Empirical of ``map_func(trace)`` (the trace itself by default);
        traces with a NaN or infinite weight are discarded."""
        generator = self._trace_generator(
            trace_mode=trace_mode,
            prior_inflation=prior_inflation,
            inference_engine=inference_engine,
            inference_network=inference_network,
            observe=observe,
            likelihood_importance=likelihood_importance,
            *args,
            **kwargs,
        )
        map_func = map_func or trace_id
        values, log_weights = [], []
        time_start = time.time()
        for _ in range(num_traces):
            trace = next(generator)
            log_weight = 1.0 if trace_mode == TraceMode.PRIOR else float(trace.log_importance_weight)
            if not np.isfinite(log_weight):
                warnings.warn("Encountered trace with nan/inf log_weight. Discarding trace.")
                continue
            values.append(map_func(trace))
            log_weights.append(log_weight)
        emp = empirical_of(values, log_weights, file_name)
        if not silent and util.verbosity() > 1:
            duration = time.time() - time_start
            util.log_print(
                f"[interpreter tier] {num_traces:,} traces in {duration:.3f}s "
                f"({num_traces / max(duration, 1e-9):,.0f} traces/s), "
                f"ESS {emp.effective_sample_size:,.1f}"
            )
        return emp

    def sample(self, *args, **kwargs):
        """One interpreter-tier trace (from the prior by default; the
        ``_trace_generator`` arguments select another mode)."""
        return next(self._trace_generator(*args, **kwargs))

    def get_trace(self, *args, **kwargs):
        warnings.warn("Model.get_trace is deprecated. Use Model.sample instead.")
        return self.sample(*args, **kwargs)

    # ------------------------------------------------------------------
    # prior
    # ------------------------------------------------------------------
    def prior(
        self,
        num_traces=10,
        prior_inflation=PriorInflation.DISABLED,
        map_func=None,
        file_name=None,
        likelihood_importance=1.0,
        vectorized=None,
        *args,
        **kwargs,
    ):
        if vectorized is not False:
            from .vectorized import vectorized_prior

            prior = vectorized_prior(
                self,
                num_traces=num_traces,
                prior_inflation=prior_inflation,
                map_func=map_func,
                file_name=file_name,
                fallback=vectorized is None,
                *args,
                **kwargs,
            )
            if prior is not None:
                return prior
        prior = self._traces(
            num_traces=num_traces,
            trace_mode=TraceMode.PRIOR,
            prior_inflation=prior_inflation,
            map_func=map_func,
            file_name=file_name,
            likelihood_importance=likelihood_importance,
            *args,
            **kwargs,
        )
        prior.rename(f"Prior, traces: {prior.length:,}")
        prior.add_metadata(
            op="prior", num_traces=num_traces, prior_inflation=str(prior_inflation),
            likelihood_importance=likelihood_importance,
        )
        return prior

    def prior_results(
        self,
        num_traces=10,
        prior_inflation=PriorInflation.DISABLED,
        map_func=trace_result,
        file_name=None,
        likelihood_importance=1.0,
        *args,
        **kwargs,
    ):
        return self.prior(
            num_traces=num_traces,
            prior_inflation=prior_inflation,
            map_func=map_func,
            file_name=file_name,
            likelihood_importance=likelihood_importance,
            *args,
            **kwargs,
        )

    # ------------------------------------------------------------------
    # posterior
    # ------------------------------------------------------------------
    def posterior(
        self,
        num_traces=10,
        inference_engine=InferenceEngine.IMPORTANCE_SAMPLING,
        initial_trace=None,
        map_func=None,
        observe=None,
        file_name=None,
        thinning_steps=None,
        likelihood_importance=1.0,
        vectorized=None,
        num_chains=None,
        burn_in=None,
        return_chains=False,
        mesh=None,
        resample_threshold=0.5,
        resampling="systematic",
        lockstep=None,
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
        """IS from the prior or from the inference network (IC), an LMH /
        RMH chain, SMC, or a gradient engine.  On the interpreter tier IC
        runs lockstep when ``num_traces >= 8``: a pool of worker threads (64, or ``lockstep``
        when it is an int) whose proposal sites are answered a round at a
        time by one batched network step on the card; ``lockstep=False``
        runs the sequential loop, one network step a site.  The MCMC engines
        run parallel chains on the batched tier
        (``inference.mcmc.vectorized_mcmc_posterior``: ``initial_trace`` a
        ``ChainState`` or a ``Trace``, ``num_chains``, ``burn_in``,
        ``thinning_steps``, ``return_chains``) and the reference's one
        sequential chain on the interpreter tier (``initial_trace`` a
        ``Trace``, ``thinning_steps``).  SMC (``inference.smc``;
        ``resample_threshold``, ``resampling``: 'systematic', 'stratified',
        'residual' or 'multinomial') runs on the batched tier unless
        ``vectorized=False``; unguided SMC falls back to the interpreter
        filter for a model that cannot run there, and guided SMC
        (``SEQUENTIAL_MONTE_CARLO_WITH_INFERENCE_NETWORK``) raises for it.
        The gradient engines run on the batched tier only: HMC and NUTS as
        parallel chains (``inference.hmc`` / ``inference.nuts``:
        ``leapfrog_steps`` (HMC), ``max_tree_depth`` (NUTS),
        ``target_accept``, ``step_size``, ``num_chains``, ``burn_in``,
        ``thinning_steps``, ``return_chains``; ``initial_trace`` a
        ``GradientChainState``, ``posterior.final_gradient_state``) and
        LAPLACE (``inference.laplace``: ``map_steps``, ``num_starts``,
        ``learning_rate``); a model that does not run there raises
        RuntimeError.  ``mesh`` (chains or particles over several cards)
        comes with the distributed slice."""
        if mesh is not None:
            raise NotImplementedError(
                "mesh= (chains or particles over several cards) is not ported yet; "
                "it comes with the distributed slice"
            )
        mcmc = inference_engine in state._MCMC
        if vectorized is not False:
            from .vectorized import vectorized_posterior

            posterior = vectorized_posterior(
                self,
                num_traces=num_traces,
                inference_engine=inference_engine,
                map_func=map_func,
                observe=observe,
                file_name=file_name,
                likelihood_importance=likelihood_importance,
                fallback=vectorized is None,
                initial_trace=initial_trace,
                thinning_steps=thinning_steps,
                num_chains=num_chains,
                burn_in=burn_in,
                return_chains=return_chains,
                resample_threshold=resample_threshold,
                resampling=resampling,
                leapfrog_steps=leapfrog_steps,
                target_accept=target_accept,
                step_size=step_size,
                max_tree_depth=max_tree_depth,
                map_steps=map_steps,
                num_starts=num_starts,
                learning_rate=learning_rate,
                *args,
                **kwargs,
            )
            if posterior is not None:
                return posterior
        if inference_engine in state._GRADIENT:
            from .inference.hmc import no_interpreter_tier

            raise no_interpreter_tier(inference_engine.name, self)
        if inference_engine in state._SMC:
            if inference_engine == InferenceEngine.SEQUENTIAL_MONTE_CARLO_WITH_INFERENCE_NETWORK:
                raise RuntimeError(
                    "SEQUENTIAL_MONTE_CARLO_WITH_INFERENCE_NETWORK requires a model that runs "
                    "on the batched tier; for this model use SEQUENTIAL_MONTE_CARLO (the "
                    "interpreter filter) or IMPORTANCE_SAMPLING_WITH_INFERENCE_NETWORK."
                )
            from .inference.smc import interpreter_smc_posterior

            return interpreter_smc_posterior(
                self,
                num_traces=num_traces,
                observe=observe,
                map_func=map_func,
                file_name=file_name,
                resample_threshold=resample_threshold,
                resampling=resampling,
                likelihood_importance=likelihood_importance,
                args=args,
                kwargs=kwargs,
            )
        if num_chains is not None or burn_in is not None or return_chains:
            warnings.warn(
                "num_chains/burn_in/return_chains only apply to the batched MCMC tier "
                "(a model that runs there, vectorized=None or True); the interpreter "
                "chain ignores them."
            )
        if mcmc:
            return self._mcmc_posterior(
                num_traces=num_traces,
                inference_engine=inference_engine,
                initial_trace=initial_trace,
                map_func=map_func,
                observe=observe,
                file_name=file_name,
                thinning_steps=thinning_steps,
                *args,
                **kwargs,
            )
        if inference_engine == InferenceEngine.IMPORTANCE_SAMPLING:
            network, label = None, "IS"
        elif inference_engine == InferenceEngine.IMPORTANCE_SAMPLING_WITH_INFERENCE_NETWORK:
            network, label = self._inference_network, "IC"
            if network is None:
                raise RuntimeError(
                    "No inference network available. Use learn_inference_network "
                    "or load_inference_network first."
                )
        else:
            raise state._engines_later(inference_engine.name)
        if (
            network is not None
            and lockstep is not False
            and num_traces >= 8
            and getattr(self, "_local_lockstep_ok", True)
        ):
            from .interpreter_lockstep import lockstep_interpreter_traces

            posterior = lockstep_interpreter_traces(
                self,
                num_traces=num_traces,
                inference_network=network,
                observe=observe,
                map_func=map_func,
                file_name=file_name,
                likelihood_importance=likelihood_importance,
                num_workers=lockstep if isinstance(lockstep, int) and not isinstance(lockstep, bool) else None,
                args=args,
                kwargs=kwargs,
            )
        else:
            posterior = self._traces(
                num_traces=num_traces,
                trace_mode=TraceMode.POSTERIOR,
                inference_engine=inference_engine,
                inference_network=network,
                map_func=map_func,
                observe=observe,
                file_name=file_name,
                likelihood_importance=likelihood_importance,
                *args,
                **kwargs,
            )
        posterior.rename(
            f"Posterior, {label}, traces: {posterior.length:,}, "
            f"ESS: {posterior.effective_sample_size:,.2f}"
        )
        posterior.add_metadata(
            op="posterior", num_traces=num_traces, inference_engine=str(inference_engine),
            effective_sample_size=posterior.effective_sample_size,
            likelihood_importance=likelihood_importance,
        )
        return posterior

    def _mcmc_posterior(
        self,
        num_traces,
        inference_engine,
        initial_trace=None,
        map_func=None,
        observe=None,
        file_name=None,
        thinning_steps=None,
        *args,
        **kwargs,
    ):
        """The reference's single-site Metropolis-Hastings chain, one trace a
        step on the interpreter tier, with its acceptance formula
        (reference: pyprob/model.py:118-177): the trace-length terms, the
        observed log-likelihoods, the reused sites' log-prob differences and
        the resampled site's transition term.  Every ``thinning_steps``-th
        state is kept.  The site choice and the acceptance uniforms come
        from the interpreter's CPU generator."""
        from .inference import ChainState

        if isinstance(initial_trace, ChainState):
            raise TypeError(
                "ChainState resume requires the batched MCMC tier (a model that runs "
                "there, vectorized=None or True); the interpreter chain resumes from a Trace."
            )
        map_func = map_func or trace_id
        thinning_steps = 1 if thinning_steps is None else int(thinning_steps)

        def candidate(current):
            return next(
                self._trace_generator(
                    trace_mode=TraceMode.POSTERIOR,
                    inference_engine=inference_engine,
                    observe=observe,
                    metropolis_hastings_trace=current,
                    *args,
                    **kwargs,
                )
            )

        current = candidate(None) if initial_trace is None else initial_trace
        if len(current) == 0:
            raise RuntimeError(
                "Cannot run MCMC with an empty initial trace. The model needs at least one sample statement."
            )
        rng = state._get_rng()
        values = []
        accepted = reused = samples = 0
        time_start = time.time()
        for i in range(num_traces):
            cand = candidate(current)
            log_alpha = (
                math.log(current.length_controlled)
                - math.log(cand.length_controlled)
                + float(cand.log_prob_observed)
                - float(current.log_prob_observed)
            )
            old = current.variables_dict_address
            for variable in cand.variables_controlled:
                if variable.reused:
                    log_alpha += float(_total(variable.log_prob)) - float(_total(old[variable.address].log_prob))
                    reused += 1
            samples += cand.length_controlled
            transition = state._ctx_local.value.metropolis_hastings_site_transition_log_prob
            if transition is None:
                warnings.warn(
                    "Trace did not hit the Metropolis-Hastings site; ensure the model is "
                    "deterministic apart from sample calls"
                )
            else:
                log_alpha += transition
            if math.log(max(float(torch.rand((), dtype=torch.float64, generator=rng)), 1e-300)) < log_alpha:
                accepted += 1
                current = cand
            if i % thinning_steps == 0:
                values.append(map_func(current))
        duration = time.time() - time_start
        posterior = empirical_of(values, np.zeros(len(values)), file_name)
        engine_name = "LMH" if inference_engine == InferenceEngine.LIGHTWEIGHT_METROPOLIS_HASTINGS else "RMH"
        if util.verbosity() > 1:
            util.log_print(
                f"[interpreter tier] {engine_name}: {num_traces:,} steps in {duration:.3f}s "
                f"({num_traces / max(duration, 1e-9):,.0f} steps/s), accepted "
                f"{100 * accepted / max(1, num_traces):.1f}%"
            )
        posterior.rename(
            f"Posterior, {engine_name}, traces: {posterior.length:,}, "
            f"accepted: {100 * accepted / max(1, num_traces):,.2f}%, "
            f"sample reuse: {100 * reused / max(1, samples):,.2f}%"
        )
        posterior.add_metadata(
            op="posterior",
            num_traces=num_traces,
            inference_engine=str(inference_engine),
            thinning_steps=thinning_steps,
            num_traces_accepted=accepted,
            num_samples_reused=reused,
            num_samples=samples,
            seconds=duration,
        )
        return posterior

    def posterior_results(
        self,
        num_traces=10,
        inference_engine=InferenceEngine.IMPORTANCE_SAMPLING,
        initial_trace=None,
        map_func=trace_result,
        observe=None,
        file_name=None,
        thinning_steps=None,
        *args,
        **kwargs,
    ):
        """``posterior`` with ``map_func=trace_result``; the engines' other
        arguments (``resample_threshold``, ``resampling``, ...) pass through."""
        return self.posterior(
            num_traces=num_traces,
            inference_engine=inference_engine,
            initial_trace=initial_trace,
            map_func=map_func,
            observe=observe,
            file_name=file_name,
            thinning_steps=thinning_steps,
            *args,
            **kwargs,
        )

    def map_estimate(self, observe=None, map_steps=None, num_starts=None, learning_rate=None,
                     likelihood_importance=1.0, *args, **kwargs):
        """Posterior mode of the continuous latents: multi-start gradient
        descent on the unconstrained-space potential, enumerable discrete
        sites marginalized and drawn from their exact conditional at the
        mode (``inference.laplace.map_estimate``).  Returns a ``MAPResult``
        with ``values`` (constrained-space mode per latent site), ``result``
        (forward() at the mode) and ``log_joint``.  Needs a model that runs
        on the batched tier."""
        from .inference.laplace import map_estimate as _map_estimate

        return _map_estimate(
            self,
            observe=observe,
            map_steps=map_steps,
            num_starts=num_starts,
            learning_rate=learning_rate,
            likelihood_importance=likelihood_importance,
            args=args,
            kwargs=kwargs,
        )

    def posterior_predictive(self, posterior, num_traces=1000, map_func=None, file_name=None, *args, **kwargs):
        """The posterior-predictive distribution: each draw takes a trace
        from ``posterior`` (a trace-valued Empirical, from ``posterior()``),
        pins its controlled latents to that trace's values and runs
        ``forward`` on the interpreter tier with every observe drawn fresh
        from its likelihood.  Returns an Empirical of ``map_func(trace)``
        (the trace by default)."""
        from .trace import Trace

        generator = self._trace_generator(
            trace_mode=TraceMode.PRIOR_FOR_INFERENCE_NETWORK,
            inference_engine=InferenceEngine.IMPORTANCE_SAMPLING,
            *args,
            **kwargs,
        )
        values = []
        for _ in range(num_traces):
            src = posterior.sample()
            if not isinstance(src, Trace):
                raise RuntimeError(
                    "posterior_predictive needs a trace-valued posterior "
                    "(use posterior(...), not posterior_results(...))"
                )
            state._set_smc_replay({v.address: state._host_tensor(v.value) for v in src.variables_controlled})
            try:
                t = next(generator)
            finally:
                state._set_smc_replay(None)
            values.append(t if map_func is None else map_func(t))
        emp = empirical_of(values, np.zeros(len(values)), file_name)
        emp.rename(f"Posterior predictive, traces: {emp.length:,}")
        emp.add_metadata(op="posterior_predictive", num_traces=num_traces)
        return emp

    def posterior_predictive_results(self, posterior, num_traces=1000, *args, **kwargs):
        """The posterior-predictive distribution of ``forward``'s result."""
        return self.posterior_predictive(posterior, num_traces=num_traces, map_func=trace_result, *args, **kwargs)

    # ------------------------------------------------------------------
    # inference compilation
    # ------------------------------------------------------------------
    def reset_inference_network(self):
        self._inference_network = None

    def learn_inference_network(
        self,
        num_traces,
        num_traces_end=1e9,
        inference_network=InferenceNetwork.FEEDFORWARD,
        prior_inflation=PriorInflation.DISABLED,
        dataset_dir=None,
        dataset_valid_dir=None,
        observe_embeddings={},
        batch_size=64,
        valid_size=None,
        valid_every=None,
        optimizer_type=Optimizer.ADAM,
        learning_rate_init=0.001,
        learning_rate_end=1e-6,
        learning_rate_scheduler_type=LearningRateScheduler.NONE,
        momentum=0.9,
        weight_decay=0.0,
        save_file_name_prefix=None,
        save_every_sec=600,
        pre_generate_layers=False,
        distributed_backend=None,
        distributed_params_sync_every_iter=10000,
        distributed_num_buckets=None,
        dataloader_offline_num_workers=0,
        stop_with_bad_loss=True,
        log_file_name=None,
        lstm_dim=512,
        lstm_depth=1,
        proposal_mixture_components=10,
        tie_address_instances=None,
        ema_decay=None,
        keep_best=False,
        keep_best_every=None,
        keep_best_metric=None,
        keep_best_observe=None,
        keep_best_num_traces=100000,
    ):
        """Train the model's inference network (a new network on the first
        call, continued after) on traces drawn from its prior, or on the
        trace files of ``dataset_dir`` (``save_dataset`` writes them), with
        a validation loss on those of ``dataset_valid_dir`` every
        ``valid_every`` traces.  ``ema_decay``: Polyak/EMA parameter
        averaging per optimizer step; proposals are served from the
        debiased average.  ``keep_best``: probe a metric every
        ``keep_best_every`` traces and at the end, and restore the best
        probed state: ``keep_best_metric`` (a callable ``net -> float``,
        higher is better); or, given ``keep_best_observe``, the guided-IS
        ESS fraction of ``keep_best_num_traces`` traces of this model on
        the batched tier; or, given ``dataset_valid_dir``, the negative
        validation loss.  Tied address instances and distributed training
        raise ``NotImplementedError`` naming their slice."""
        from .nn import InferenceNetworkFeedForward, InferenceNetworkLSTM, OfflineDataset, OnlineDataset

        if tie_address_instances:
            raise NotImplementedError(
                "tie_address_instances comes with the Markov/SMC slice"
            )
        if dataset_dir is None:
            dataset = OnlineDataset(model=self, prior_inflation=prior_inflation)
        else:
            dataset = OfflineDataset(dataset_dir=dataset_dir)
        dataset_valid = None if dataset_valid_dir is None else OfflineDataset(dataset_dir=dataset_valid_dir)
        if self._inference_network is None:
            util.log_print("Creating new inference network...")
            if inference_network == InferenceNetwork.FEEDFORWARD:
                self._inference_network = InferenceNetworkFeedForward(
                    model=self,
                    observe_embeddings=observe_embeddings,
                    proposal_mixture_components=proposal_mixture_components,
                )
            elif inference_network == InferenceNetwork.LSTM:
                self._inference_network = InferenceNetworkLSTM(
                    model=self,
                    observe_embeddings=observe_embeddings,
                    lstm_dim=lstm_dim,
                    lstm_depth=lstm_depth,
                    proposal_mixture_components=proposal_mixture_components,
                )
            else:
                raise ValueError(f"Unknown inference_network: {inference_network}")
            if pre_generate_layers:
                if dataset_valid is not None:
                    self._inference_network._pre_generate_layers(dataset_valid)
                if dataset_dir is not None:
                    self._inference_network._pre_generate_layers(dataset)
        else:
            util.log_print("Continuing to train existing inference network...")
        if keep_best and keep_best_metric is None and keep_best_observe is not None:
            engine = InferenceEngine.IMPORTANCE_SAMPLING_WITH_INFERENCE_NETWORK

            def keep_best_metric(net):
                probe = self.posterior_results(
                    num_traces=keep_best_num_traces, observe=keep_best_observe, vectorized=True,
                    inference_engine=engine,
                )
                return probe.effective_sample_size / keep_best_num_traces

        self._inference_network.optimize(
            num_traces=num_traces,
            dataset=dataset,
            dataset_valid=dataset_valid,
            num_traces_end=num_traces_end,
            batch_size=batch_size,
            valid_every=valid_every,
            optimizer_type=optimizer_type,
            learning_rate_init=learning_rate_init,
            learning_rate_end=learning_rate_end,
            learning_rate_scheduler_type=learning_rate_scheduler_type,
            momentum=momentum,
            weight_decay=weight_decay,
            save_file_name_prefix=save_file_name_prefix,
            save_every_sec=save_every_sec,
            distributed_backend=distributed_backend,
            distributed_params_sync_every_iter=distributed_params_sync_every_iter,
            distributed_num_buckets=distributed_num_buckets,
            stop_with_bad_loss=stop_with_bad_loss,
            log_file_name=log_file_name,
            ema_decay=ema_decay,
            keep_best=keep_best,
            keep_best_every=keep_best_every,
            keep_best_metric=keep_best_metric,
        )

    def save_dataset(self, dataset_dir, num_traces, num_traces_per_file, prior_inflation=PriorInflation.DISABLED):
        """Write ``num_traces`` training traces (drawn as
        ``learn_inference_network`` draws them online) to files of
        ``num_traces_per_file`` in ``dataset_dir``, for
        ``learn_inference_network(dataset_dir=...)``."""
        from .nn import OnlineDataset

        if not os.path.exists(dataset_dir):
            util.log_print(f"Directory does not exist, creating: {dataset_dir}")
            os.makedirs(dataset_dir)
        return OnlineDataset(self, prior_inflation=prior_inflation).save_dataset(
            dataset_dir=dataset_dir, num_traces=num_traces, num_traces_per_file=num_traces_per_file,
        )

    def save_inference_network(self, file_name):
        """Write the model's inference network, with its optimizer's state
        and counters, to ``file_name`` (a gzip tar holding one pickle of
        numpy arrays and plain Python data)."""
        if self._inference_network is None:
            raise RuntimeError("The model has no trained inference network.")
        self._inference_network._save(file_name)

    def load_inference_network(self, file_name):
        """Make the network saved in ``file_name`` this model's, on the
        port's device; training continues it where it stopped.  Raises
        RuntimeError for a file it cannot read."""
        from .nn import InferenceNetwork as InferenceNetworkBase

        self._inference_network = InferenceNetworkBase._load(file_name)
        self._inference_network._model = self

    # ------------------------------------------------------------------
    def condition(self, criterion, criterion_timeout=1e6):
        return ConditionalModel(self, criterion=criterion, criterion_timeout=criterion_timeout)

    def filter(self, *args, **kwargs):
        warnings.warn("Model.filter is deprecated. Use Model.condition instead.")
        return self.condition(*args, **kwargs)

    def parallel(self, num_workers=None):
        return ParallelModel(self, num_workers=num_workers)


class ConditionalModel(Model):
    """Hard rejection conditioning on a trace criterion (reference:
    pyprob/model.py:270-298): a trace of the base model is kept when
    ``criterion(trace)`` holds, after at most ``criterion_timeout`` tries.
    Interpreter tier only: the criterion reads whole traces on the host."""

    _never_vectorize = True
    _local_lockstep_ok = False  # wraps the base model's trace generator

    def __init__(self, base_model, criterion, criterion_timeout=1e6):
        self._base_model = base_model
        self._criterion = criterion
        self._criterion_timeout = int(criterion_timeout)
        self._traces_total = 1.0
        self._traces_accepted = 1.0
        super().__init__(name=f"ConditionalModel({base_model.name})")

    def __repr__(self):
        return f"ConditionalModel({self._base_model})"

    @property
    def acceptance_ratio(self):
        return self._traces_accepted / self._traces_total

    def _trace_generator(self, *args, **kwargs):
        i = 0
        while True:
            i += 1
            if i > self._criterion_timeout:
                raise RuntimeError(
                    f"ConditionalModel could not satisfy the criterion. Timeout ({self._criterion_timeout}) reached."
                )
            trace = next(self._base_model._trace_generator(*args, **kwargs))
            self._traces_total += 1.0
            if self._criterion(trace):
                self._traces_accepted += 1.0
                yield trace


class _HostPickler(pickle.Pickler):
    """Pickles a model with its tensors as numpy arrays and the device
    they lay on: a spawned worker rebuilds them after it has set its
    device, so it touches CUDA no earlier."""

    def reducer_override(self, obj):
        if isinstance(obj, torch.Tensor):
            return _rebuild_tensor, (obj.detach().cpu().numpy(), str(obj.device))
        return NotImplemented


def _rebuild_tensor(array, device):
    return torch.as_tensor(array, device=device)


class _ParallelModelWorker:
    """A ``ParallelModel`` task runner in a spawned process.  It holds the
    base model pickled (``_HostPickler``), the trace arguments and the file
    of the network to serve, and sets the parent's device before it
    unpickles the model or loads the network."""

    def __init__(self, model_bytes, kwargs, device, network_file):
        self._model_bytes = model_bytes
        self._kwargs = kwargs
        self._device = device
        self._network_file = network_file

    def run(self, task):
        started = time.time()
        seed, num_traces, file_name = task
        util.set_device(self._device)
        util.seed(seed)
        util.set_verbosity(1)
        model = pickle.loads(self._model_bytes)
        kwargs = dict(self._kwargs, num_traces=num_traces, file_name=file_name, silent=True)
        if self._network_file is not None:
            from .nn import InferenceNetwork as InferenceNetworkBase

            net = InferenceNetworkBase._load(self._network_file)
            net._model = model
            model._inference_network = net
            kwargs["inference_network"] = net
        if (
            kwargs.get("inference_engine") == InferenceEngine.IMPORTANCE_SAMPLING_WITH_INFERENCE_NETWORK
            and getattr(model, "_local_lockstep_ok", True)
        ):
            # guided IC: the thread-lockstep pool inside this process, one
            # batched network step a round (processes multiply what one GIL
            # can do)
            from .interpreter_lockstep import lockstep_interpreter_traces

            traces = lockstep_interpreter_traces(
                model,
                num_traces=num_traces,
                inference_network=kwargs["inference_network"],
                observe=kwargs.get("observe"),
                map_func=kwargs.get("map_func"),
                file_name=file_name,
                likelihood_importance=kwargs.get("likelihood_importance", 1.0),
            )
        else:
            traces = model._traces(**kwargs)
        traces.close()
        return {"started": started, "seconds": time.time() - started}


class ParallelModel(Model):
    """Trace generation over a pool of spawned processes on the interpreter
    tier, the workers' Empirical chunk files merged (reference:
    pyprob/model.py:301-406), for a model that does not run on the batched
    tier.  Each worker sets the parent's device (``util.device()``, given
    in its task) before it touches a tensor, so guided IC served on the
    card serves its lockstep rounds there; the JAX package pins its
    workers to the CPU, as a TPU has one owner.  The network is handed to
    the workers in a file (``save_inference_network``'s format).  MCMC is
    refused: a chain is sequential."""

    _never_vectorize = True  # the parallelism is processes
    # the thread-lockstep pool runs inside each worker (_ParallelModelWorker.run)
    _local_lockstep_ok = False

    def __init__(self, base_model, num_workers=None):
        self._base_model = base_model
        self._num_workers = num_workers or multiprocessing.cpu_count()
        super().__init__(name=f"ParallelModel({base_model.name})")

    def __repr__(self):
        return f"ParallelModel({self._base_model})"

    @property
    def _inference_network(self):
        # the network lives on the base model: IC fans guided traces out
        # over the pool (the reference's ParallelModel cannot run IC)
        return self._base_model._inference_network

    @_inference_network.setter
    def _inference_network(self, v):
        # Model.__init__ assigns None; only real assignments pass through
        if v is not None:
            self._base_model._inference_network = v

    def posterior(self, num_traces=10, inference_engine=InferenceEngine.IMPORTANCE_SAMPLING, *args, **kwargs):
        if inference_engine in state._MCMC:
            raise ValueError(f"{inference_engine} currently not supported by ParallelModel")
        return Model.posterior(self, num_traces, inference_engine=inference_engine, *args, **kwargs)

    def _trace_generator(self, *args, **kwargs):
        return self._base_model._trace_generator(*args, **kwargs)

    def _traces(self, num_traces=10, file_name=None, silent=False, **kwargs):
        file_mode = file_name is not None
        scratch = None if file_mode else tempfile.mkdtemp(prefix="pyprob_tpu_torch_")
        if not file_mode:
            file_name = os.path.join(scratch, "traces_" + str(uuid.uuid4()))
        k = self._num_workers
        per = num_traces // k
        seed = int(util.get_rng().integers(2**31 - k))
        tasks, file_names = [], []
        for i in range(k):
            fn = f"{file_name}_chunk_{i + 1}_of_{k}"
            file_names.append(fn)
            tasks.append((seed + i, per + (num_traces - per * k if i == k - 1 else 0), fn))
        network = kwargs.pop("inference_network", None)
        network_file = None
        base = self._base_model
        saved_network, base._inference_network = base._inference_network, None
        try:
            if network is not None:
                network_file = os.path.join(scratch or os.path.dirname(os.path.abspath(file_name)),
                                            f"network_{uuid.uuid4()}")
                stamp = network._modified, network._updates
                network._save(network_file)
                network._modified, network._updates = stamp  # a hand-over, not a save of the user's
            buf = io.BytesIO()
            _HostPickler(buf, protocol=pickle.HIGHEST_PROTOCOL).dump(base)
            model_bytes = buf.getvalue()
        finally:
            base._inference_network = saved_network
        worker = _ParallelModelWorker(model_bytes, kwargs, str(util.device()), network_file)
        time_start = time.time()
        runs = []
        try:
            # spawn, not fork: a forked child of a process that holds a CUDA
            # context cannot use the card
            with multiprocessing.get_context("spawn").Pool(k) as pool:
                for j, run in enumerate(pool.imap(worker.run, tasks)):
                    runs.append(run)
                    if not silent and util.verbosity() > 1:
                        util.log_print(f"[parallel x{k}] chunk {j + 1}/{k} done, {time.time() - time_start:.1f}s")
            if file_mode:
                traces = Empirical(concat_empirical_file_names=file_names, file_name=file_name)
            else:
                joined = Empirical(concat_empirical_file_names=file_names)
                traces = joined.copy()
                joined.close()
        finally:
            if network_file is not None and os.path.exists(network_file):
                os.remove(network_file)
            if scratch is not None:
                shutil.rmtree(scratch, ignore_errors=True)
        traces.add_metadata(
            parallel_workers=k,
            # from the pool's start to each task's start: the process start,
            # its imports and the task's unpickling
            worker_start_seconds=[r["started"] - time_start for r in runs],
            worker_seconds=[r["seconds"] for r in runs],
            seconds=time.time() - time_start,
        )
        return traces
