"""Training batches and the online dataset (counterpart of
``pyprob_tpu/nn/dataset.py``).

Traces in a materialized batch are grouped by their controlled-address
sequence (``trace_hash``) so each sub-batch is rectangular.  The online
dataset draws fresh traces from the model in
``PRIOR_FOR_INFERENCE_NETWORK`` mode on the batched tier: ``next_batch``
materializes them (the first batch of a training call, which grows the
network's per-address layers), ``next_device_batch`` leaves them on the
device for the training hot loop.  A model that cannot run on the batched
tier (it branches on sampled values) draws its batches on the interpreter
tier, one trace at a time, and ``next_device_batch`` returns None for it.
The offline datasets and their samplers come with the offline-dataset
slice.
"""

from __future__ import annotations

import numpy as np

from ..trace import Trace, Variable
from ..util import PriorInflation, TraceMode


class Batch:
    """Traces grouped by identical controlled-address sequences."""

    def __init__(self, traces):
        self.traces = traces
        self.size = len(traces)
        sub_batches = {}
        for trace in traces:
            if trace.length == 0:
                raise ValueError("Trace of length zero.")
            sub_batches.setdefault(trace.trace_hash(), []).append(trace)
        self.sub_batches = list(sub_batches.values())

    def __len__(self):
        return self.size


class PackedBatch:
    """A rectangular training batch packed directly from device tensors:
    the hot loop's batch, with no Python trace materialization."""

    def __init__(self, packed, size, addrs, dist_names):
        self.packed = packed
        self.size = size
        self.addrs = addrs
        self.dist_names = dist_names

    def __len__(self):
        return self.size


def _prune_variable(variable, keep_distribution=True):
    return Variable(
        distribution=variable.distribution if keep_distribution else None,
        value=None if variable.value is None else np.asarray(variable.value),
        address_base=variable.address_base,
        address=variable.address,
        instance=variable.instance,
        control=variable.control,
        name=variable.name,
        observed=variable.observed,
        tagged=variable.tagged,
    )


def prune_trace(trace):
    """Keep the controlled variables (with their distributions) and the
    named ones (values only), in execution order."""
    ret = Trace()
    for variable in trace.variables:
        if variable.control:
            ret.add(_prune_variable(variable, keep_distribution=True))
        elif variable.name is not None and variable.address not in ret.variables_dict_address:
            ret.add(_prune_variable(variable, keep_distribution=False))
    ret.end(None, None)
    return ret


class OnlineDataset:
    """Infinite dataset of fresh prior traces (observes receive sampled
    values), drawn on the batched tier when the model runs there, else on
    the interpreter tier."""

    def __init__(self, model, prior_inflation=PriorInflation.DISABLED):
        self._model = model
        self._prior_inflation = prior_inflation

    def __getitem__(self, idx):
        return self.next_batch(1)[0]

    def next_batch(self, batch_size):
        """``batch_size`` pruned, materialized training traces: one batched
        run, or the interpreter loop for a model that cannot run batched."""
        from ..vectorized import vectorized_traces

        emp = vectorized_traces(
            self._model,
            batch_size,
            TraceMode.PRIOR_FOR_INFERENCE_NETWORK,
            prior_inflation=self._prior_inflation,
            fallback=True,
        )
        if emp is not None:
            return [prune_trace(t) for t in emp.get_values()]
        return self._model._traces(
            num_traces=batch_size,
            trace_mode=TraceMode.PRIOR_FOR_INFERENCE_NETWORK,
            prior_inflation=self._prior_inflation,
            map_func=prune_trace,
            silent=True,
        ).get_values()

    def next_device_batch(self, batch_size):
        """(outputs, sites) of one batched run, outputs on the device as
        ``[B]`` tensors; None for a model that cannot run batched (its
        class is marked, as ``vectorized_traces`` marks it)."""
        from ..vectorized import _TraceabilityCache, run_training_batch

        if _TraceabilityCache.known_untraceable(self._model):
            return None
        try:
            return run_training_batch(self._model, batch_size, self._prior_inflation)
        except NotImplementedError:
            _TraceabilityCache.mark(self._model, False)
            return None
