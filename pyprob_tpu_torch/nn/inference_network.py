"""Inference network base: observe embeddings, serving parameters, layer
pre-generation (counterpart of ``pyprob_tpu/nn/inference_network.py``).

Parameters are a nested dict of tensors on the network's device, laid out
as the JAX package's parameter pytree.  Training (``optimize``, the
optimizer, checkpoints) comes with the training slice; this slice serves a
network that was built here or carried over from the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import util
from ..util import ObserveEmbedding
from .layers import map_tensors, mlp_apply, mlp_from_numpy, mlp_init


def _sub_batches(traces):
    """Group traces by their controlled-address sequence (the JAX
    package's ``nn.dataset.Batch.sub_batches``)."""
    groups = {}
    for trace in traces:
        if trace.length == 0:
            raise ValueError("Trace of length zero.")
        groups.setdefault(trace.trace_hash(), []).append(trace)
    return list(groups.values())


class InferenceNetwork:
    def __init__(self, model, observe_embeddings={}, network_type="", device=None):
        self._model = model
        self._network_type = network_type
        self._observe_embeddings_spec = observe_embeddings
        self._observe_meta = {}
        self._params = {"observe": {}, "observe_final": None}
        self._observe_embedding_dim = None
        self._layers_initialized = False
        self._layers_pre_generated = False
        self._head_train_iterations = {}
        self._device = torch.device(device) if device is not None else util.device()
        # Polyak/EMA average kept by training; serving reads the debiased
        # ema/(1-d^t) when present
        self._ema_params = None
        self._ema_decay = None
        self._ema_steps = 0
        self._total_train_traces = 0
        self._total_train_iterations = 0
        self._vps_cache = None

    @property
    def device(self):
        return self._device

    def to(self, device):
        """Move every parameter to ``device``; returns ``self``."""
        device = torch.device(device)
        move = lambda t: t.to(device)  # noqa: E731
        self._params = map_tensors(self._params, move)
        self._ema_params = map_tensors(self._ema_params, move)
        self._device = device
        self._vps_cache = None
        return self

    def _generator(self):
        return util.generator(self._device)

    # ------------------------------------------------------------------
    # observe embeddings
    # ------------------------------------------------------------------
    def _init_layers_observe_embedding(self, observe_embeddings, example_trace):
        if len(observe_embeddings) == 0:
            raise ValueError(
                "At least one observe embedding is needed to initialize the "
                "inference network."
            )
        if isinstance(observe_embeddings, (set, list, tuple)):
            observe_embeddings = {o: {} for o in observe_embeddings}
        total_dim = 0
        for name, spec in observe_embeddings.items():
            if name not in example_trace.named_variables:
                raise ValueError(
                    f"No observed variable named {name!r} in the example trace"
                )
            value = example_trace.named_value(name)
            if "reshape" in spec:
                input_shape = tuple(spec["reshape"])
            else:
                input_shape = tuple(np.shape(value)) or (1,)
            output_dim = int(spec.get("dim", 256))
            embedding = spec.get("embedding", ObserveEmbedding.FEEDFORWARD)
            depth = int(spec.get("depth", 2))
            transform = spec.get("input_transform", "none")
            if transform not in ("arcsinh", "none"):
                raise ValueError(
                    f"Unknown observe input_transform: {transform!r} "
                    "(expected 'arcsinh' or 'none')"
                )
            if embedding != ObserveEmbedding.FEEDFORWARD:
                raise NotImplementedError(
                    f"{embedding} observe embeddings come with the CNN slice"
                )
            self._params["observe"][name] = {
                "kind": "feedforward",
                "p": mlp_init(
                    self._generator(), input_shape, (output_dim,), self._device,
                    num_layers=depth,
                ),
                "tf": transform,
            }
            self._observe_meta[name] = {
                "embedding": embedding,
                "input_shape": input_shape,
                "output_dim": output_dim,
                "depth": depth,
                "input_transform": transform,
            }
            total_dim += output_dim
        self._observe_embedding_dim = total_dim
        util.log_print(f"Observe embedding dimension: {total_dim}")
        self._params["observe_final"] = mlp_init(
            self._generator(), (total_dim,), (total_dim,), self._device, num_layers=2
        )

    @staticmethod
    def _embed_observe_pure(params, obs):
        """obs: {name: [B, ...]} -> [B, O]."""
        pieces = []
        for name in sorted(params["observe"].keys()):
            layer = params["observe"][name]
            x = obs[name]
            if layer.get("tf") == "arcsinh":
                x = torch.asinh(x)
            if layer["kind"] != "feedforward":
                raise NotImplementedError(
                    f"{layer['kind']} observe embeddings come with the CNN slice"
                )
            pieces.append(mlp_apply(layer["p"], x))
        return mlp_apply(params["observe_final"], torch.cat(pieces, dim=1))

    def _observe_params_from_numpy(self, params):
        device = self._device
        self._params["observe"] = {}
        for name, layer in params["observe"].items():
            if layer["kind"] != "feedforward":
                raise NotImplementedError(
                    f"{layer['kind']} observe embeddings come with the CNN slice"
                )
            self._params["observe"][name] = {
                "kind": "feedforward",
                "p": mlp_from_numpy(layer["p"], device),
                "tf": layer.get("tf", "none"),
            }
        self._params["observe_final"] = mlp_from_numpy(params["observe_final"], device)

    # ------------------------------------------------------------------
    # serving
    # ------------------------------------------------------------------
    def _serving_params(self):
        """The parameters serving reads: the debiased Polyak/EMA average
        ``ema/(1-d^t)`` when training kept one, else the raw parameters."""
        if self._ema_params is None or self._ema_steps == 0:
            return self._params
        scale = 1.0 / (1.0 - float(self._ema_decay) ** self._ema_steps)
        return map_tensors(self._ema_params, lambda t: t * scale)

    def make_vectorized_proposal_step(self, observe):
        """A proposal step for the batched tier, or None if unsupported."""
        return None

    def cached_vectorized_proposal_step(self, observe=None):
        """Memoize the proposal step for an unchanged network (only
        training, ``to`` or a carry invalidates it)."""
        key = self._total_train_iterations
        if self._vps_cache is not None and self._vps_cache[0] == key:
            return self._vps_cache[1]
        ps = self.make_vectorized_proposal_step(observe)
        self._vps_cache = (key, ps)
        return ps

    # ------------------------------------------------------------------
    # layers
    # ------------------------------------------------------------------
    def _init_layers(self):
        raise NotImplementedError()

    def _polymorph(self, sub_batches):
        raise NotImplementedError()

    def _pre_generate_layers(self, dataset, batch_size=64):
        """Grow the layers from example traces (a list of traces, or an
        Empirical of them)."""
        traces = dataset.get_values() if hasattr(dataset, "get_values") else list(dataset)
        if not self._layers_initialized:
            self._init_layers_observe_embedding(
                self._observe_embeddings_spec, example_trace=traces[0]
            )
            self._init_layers()
            self._layers_initialized = True
        self._layers_pre_generated = True
        for begin in range(0, len(traces), batch_size):
            self._polymorph(_sub_batches(traces[begin : begin + batch_size]))
        self._vps_cache = None
        util.log_print("Layer pre-generation complete")
