"""Model API (counterpart of ``pyprob_tpu/model.py``).

The user subclasses ``Model`` and implements ``forward`` calling
``pyprob_tpu_torch.sample`` / ``observe``.  The port runs the prior and
importance sampling, from the prior (IS) or from an inference network
(IC), on the batched tier (``pyprob_tpu_torch.vectorized``), and trains
an LSTM inference network online (``learn_inference_network``).  The
interpreter tier, MCMC and the other engines, the feedforward network and
offline datasets come with later slices and raise ``NotImplementedError``.
"""

from __future__ import annotations

from . import util
from .util import (
    InferenceEngine,
    InferenceNetwork,
    LearningRateScheduler,
    Optimizer,
    PriorInflation,
)


def trace_result(trace):
    return trace.result


def _batched_only(vectorized):
    if vectorized is False:
        from .vectorized import _INTERPRETER_LATER

        raise NotImplementedError(
            f"vectorized=False asks for the interpreter tier, and {_INTERPRETER_LATER}"
        )


class Model:
    def __init__(self, name="Unnamed pyprob_tpu_torch model"):
        self.name = name
        self._inference_network = None

    def __repr__(self):
        return f"Model(name:{self.name})"

    def forward(self):
        raise RuntimeError("Model instances must provide a forward method.")

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
        _batched_only(vectorized)
        from .vectorized import vectorized_prior

        return vectorized_prior(
            self,
            num_traces=num_traces,
            prior_inflation=prior_inflation,
            map_func=map_func,
            file_name=file_name,
            *args,
            **kwargs,
        )

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
        *args,
        **kwargs,
    ):
        _batched_only(vectorized)
        from .vectorized import vectorized_posterior

        return vectorized_posterior(
            self,
            num_traces=num_traces,
            inference_engine=inference_engine,
            map_func=map_func,
            observe=observe,
            file_name=file_name,
            likelihood_importance=likelihood_importance,
            *args,
            **kwargs,
        )

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
        the LSTM network from an online dataset; the feedforward network,
        offline datasets and validation, tied address instances and
        keep-best selection raise ``NotImplementedError`` naming their
        slice."""
        from .nn import InferenceNetworkLSTM, OnlineDataset

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
                raise NotImplementedError(
                    "InferenceNetwork.FEEDFORWARD comes with the slice that "
                    "ports inference_network_feedforward.py; use "
                    "inference_network=InferenceNetwork.LSTM"
                )
            if inference_network != InferenceNetwork.LSTM:
                raise ValueError(f"Unknown inference_network: {inference_network}")
            self._inference_network = InferenceNetworkLSTM(
                model=self,
                observe_embeddings=observe_embeddings,
                lstm_dim=lstm_dim,
                lstm_depth=lstm_depth,
                proposal_mixture_components=proposal_mixture_components,
            )
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
