"""Model API (counterpart of ``pyprob_tpu/model.py``).

The user subclasses ``Model`` and implements ``forward`` calling
``pyprob_tpu_torch.sample`` / ``observe``.  The port runs the prior and
importance sampling, from the prior (IS) or from an inference network
(IC), on two tiers: the batched tier (``pyprob_tpu_torch.vectorized``, N
particles a ``forward`` call) and the interpreter tier (``state.py``, one
trace at a time on the host).  ``vectorized=True`` asks for the first,
``False`` for the second; ``None`` tries the batched tier and falls back
to the interpreter for a model whose ``forward`` cannot run there (it
branches on sampled values), remembering that per model class.  IC on the
interpreter tier runs lockstep by default (``interpreter_lockstep.py``).
It trains a feedforward (the default) or an LSTM inference network online
(``learn_inference_network``), and keeps it in a file
(``save_inference_network``, ``load_inference_network``).  MCMC and the
other engines and offline datasets come with later slices and raise
``NotImplementedError``.
"""

from __future__ import annotations

import time
import warnings

import numpy as np
import torch

from . import state, util
from .distributions import Empirical
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


def empirical_of(values, log_weights):
    """An Empirical of the kept traces' mapped values: one numpy array when
    every value is a number or a tensor of one shape, else the list."""
    numeric = (float, int, np.ndarray, np.generic, torch.Tensor)
    if values and all(isinstance(v, numeric) for v in values):
        arrays = [np.asarray(v) for v in values]
        if len({a.shape for a in arrays}) == 1:
            return Empirical.from_arrays(np.stack(arrays), log_weights)
    return Empirical(values=values, log_weights=log_weights)


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
        if file_name is not None:
            raise NotImplementedError("file-backed Empirical results come with the storage slice")
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
        emp = empirical_of(values, log_weights)
        if not silent and util.verbosity() > 1:
            duration = time.time() - time_start
            util.log_print(
                f"[interpreter tier] {num_traces:,} traces in {duration:.3f}s "
                f"({num_traces / max(duration, 1e-9):,.0f} traces/s), "
                f"ESS {emp.effective_sample_size:,.1f}"
            )
        return emp

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
        map_func=None,
        observe=None,
        file_name=None,
        likelihood_importance=1.0,
        vectorized=None,
        lockstep=None,
        *args,
        **kwargs,
    ):
        """IS from the prior or from the inference network (IC).  On the
        interpreter tier IC runs lockstep when ``num_traces >= 8``: a pool
        of worker threads (64, or ``lockstep`` when it is an int) whose
        proposal sites are answered a round at a time by one batched
        network step on the card; ``lockstep=False`` runs the sequential
        loop, one network step a site."""
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
                *args,
                **kwargs,
            )
            if posterior is not None:
                return posterior
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
        if network is not None and lockstep is not False and num_traces >= 8:
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

    def posterior_results(
        self,
        num_traces=10,
        inference_engine=InferenceEngine.IMPORTANCE_SAMPLING,
        map_func=trace_result,
        observe=None,
        file_name=None,
        *args,
        **kwargs,
    ):
        return self.posterior(
            num_traces=num_traces,
            inference_engine=inference_engine,
            map_func=map_func,
            observe=observe,
            file_name=file_name,
            *args,
            **kwargs,
        )

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
        """Train the model's inference network online on traces drawn from
        its prior (a new network on the first call, continued after).
        ``ema_decay``: Polyak/EMA parameter averaging per optimizer step;
        proposals are served from the debiased average.  This port trains
        the feedforward (the default) and the LSTM network from an online
        dataset, saving it as ``save_file_name_prefix`` asks; offline
        datasets and validation, tied address instances and keep-best
        selection raise ``NotImplementedError`` naming their slice."""
        from .nn import InferenceNetworkFeedForward, InferenceNetworkLSTM, OnlineDataset

        if dataset_dir is not None or dataset_valid_dir is not None:
            raise NotImplementedError(
                "training from dataset_dir / dataset_valid_dir needs the "
                "offline datasets, which come with the offline-dataset slice"
            )
        if tie_address_instances:
            raise NotImplementedError(
                "tie_address_instances comes with the Markov/SMC slice"
            )
        dataset = OnlineDataset(model=self, prior_inflation=prior_inflation)
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
        else:
            util.log_print("Continuing to train existing inference network...")
        self._inference_network.optimize(
            num_traces=num_traces,
            dataset=dataset,
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
