"""Model API (counterpart of ``pyprob_tpu/model.py``).

The user subclasses ``Model`` and implements ``forward`` calling
``pyprob_tpu_torch.sample`` / ``observe``.  This slice runs the prior and
importance sampling, from the prior (IS) or from an inference network
(IC), on the batched tier (``pyprob_tpu_torch.vectorized``).  The
interpreter tier, MCMC and the other engines, and training an inference
network come with later slices and raise ``NotImplementedError``.
"""

from __future__ import annotations

from .util import InferenceEngine, PriorInflation


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

    def learn_inference_network(self, *args, **kwargs):
        raise NotImplementedError(
            "training an inference network comes with the training slice; "
            "build one with nn.InferenceNetworkLSTM and _pre_generate_layers, "
            "or carry the JAX package's weights with "
            "InferenceNetworkLSTM.from_numpy"
        )
