"""Inference network base: observe embeddings, serving parameters, layer
pre-generation and the online training loop (counterpart of
``pyprob_tpu/nn/inference_network.py``).

Parameters are a nested dict of tensors on the network's device, laid out
as the JAX package's parameter pytree.  Training makes them leaf tensors
with ``requires_grad`` and steps them with ``torch.optim`` (Adam with L2
weight decay, or SGD with Nesterov momentum: the arithmetic of the JAX
package's optax chains) at a learning rate computed on the host each step
(POLY1/POLY2 decay by trained traces).  A Polyak/EMA average is kept
beside them when asked, and serving reads the debiased average, detached:
serving never records an autograd graph.

``optimize`` ports the online, single-process path without validation.
The loop is the JAX package's fused online loop at one step per
dispatch: each step draws a device batch, packs it, takes loss/B and
grads/B, updates and folds the EMA, with no ``lax.scan``.  A model that
runs only on the interpreter tier trains on materialized batches instead,
as the JAX package's generic loop does: each is polymorphed, and when it
grows new layers the optimizer is recreated with fresh state.  Offline
datasets, validation and keep-best selection, LARC and distributed
training raise ``NotImplementedError`` naming their slice.

``_save`` and ``_load`` keep a network in a file as the JAX package does
(a gzip tar holding one pickle, ``class_name`` picking the class), with
``save_file_name_prefix`` and ``save_every_sec`` saving during training
under the JAX package's file names.  The pickle holds only numpy arrays,
Python scalars, strings, lists and dicts (enum members by name, the
optimizer's state as numpy), so it loads on a machine without a card.
The two packages' files are not interchangeable: the JAX package's
pickles optax state, and the parameter layouts differ.

Stepwise inference on the interpreter tier (``_infer_init``,
``_infer_begin_trace`` and the subclass's ``_infer_step``) keeps its
per-trace state per thread, and the observe embedding of a run once.
"""

from __future__ import annotations

import math
import os
import pickle
import shutil
import tarfile
import tempfile
import threading
import time
import uuid
import warnings

import numpy as np
import torch

from .. import util
from ..util import LearningRateScheduler, ObserveEmbedding, Optimizer
from .dataset import Batch, OnlineDataset, PackedBatch
from .layers import map_tensors, mlp_apply, mlp_from_numpy, mlp_init, mlp_to_numpy, tensor_leaves


# the pickle's member in a saved network's tar (the JAX package's is
# "pyprob_tpu_inference_network")
_CHECKPOINT_MEMBER = "pyprob_tpu_torch_inference_network"
_JAX_CHECKPOINT_MEMBER = "pyprob_tpu_inference_network"


def _not_ported(what, slice_name):
    return NotImplementedError(f"{what} is not ported yet; it comes with the {slice_name}")


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
        self._vps_cache = None
        self._serving_memo = None  # (key, parameters) of _serving_params
        # per-trace inference state, one per thread (lockstep workers)
        self._infer_tls = threading.local()
        self._infer_emb_cache = None
        # optimizer and schedule, latched by the first optimize() call
        self._optimizer = None  # a torch.optim optimizer over tensor_leaves(_params)
        self._optimizer_type = None
        self._momentum = None
        self._weight_decay = None
        self._learning_rate_scheduler_type = None
        self._learning_rate_init = None
        self._learning_rate_end = None
        self._total_train_seconds = 0.0
        self._total_train_traces = 0
        self._total_train_traces_end = None
        self._total_train_iterations = 0
        self._loss_init = None
        self._loss_min = float("inf")
        self._loss_max = None
        self._loss_previous = float("inf")
        self._history_train_loss = []
        self._history_train_loss_trace = []
        self._modified = None
        self._updates = 0

    @property
    def device(self):
        return self._device

    def to(self, device):
        """Move every parameter, the EMA average and the optimizer state to
        ``device``; returns ``self``.  Trained parameters stay leaves."""
        device = torch.device(device)

        def move(t):
            return t.detach().to(device).requires_grad_(t.requires_grad)

        self._params = map_tensors(self._params, move)
        self._ema_params = map_tensors(self._ema_params, move)
        self._device = device
        self._vps_cache = None
        self._serving_memo = None
        if self._optimizer is not None:
            self._create_optimizer(self._optimizer.state_dict())
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

    def _set_meta_from_numpy(self, meta):
        """The observe and head metadata of a network carried from the JAX
        package (``from_numpy``); its layers count as initialized."""
        self._observe_meta = {}
        for name, m in meta["observe_meta"].items():
            m = dict(m)
            # the JAX package's enum member, or its name
            m["embedding"] = ObserveEmbedding[getattr(m["embedding"], "name", m["embedding"])]
            self._observe_meta[name] = m
        self._observe_embedding_dim = meta["observe_embedding_dim"]
        self._head_meta = {a: dict(m) for a, m in meta["head_meta"].items()}
        self._head_train_iterations = {a: 0 for a in self._head_meta}
        self._layers_initialized = True

    def _observe_params_from_numpy(self, params):
        """``observe`` and ``observe_final`` of the port's tree from the JAX
        package's parameters."""
        device = self._device
        observe = {}
        for name, layer in params["observe"].items():
            if layer["kind"] != "feedforward":
                raise NotImplementedError(
                    f"{layer['kind']} observe embeddings come with the CNN slice"
                )
            observe[name] = {
                "kind": "feedforward",
                "p": mlp_from_numpy(layer["p"], device),
                "tf": layer.get("tf", "none"),
            }
        return {
            "observe": observe,
            "observe_final": mlp_from_numpy(params["observe_final"], device),
        }

    @staticmethod
    def _observe_params_to_numpy(params):
        return {
            "observe": {
                name: {"kind": layer["kind"], "p": mlp_to_numpy(layer["p"]), "tf": layer["tf"]}
                for name, layer in params["observe"].items()
            },
            "observe_final": mlp_to_numpy(params["observe_final"]),
        }

    def _pack_observes(self, traces):
        """{name: [B, D]} observed values of materialized traces, on the
        network's device (a repeated name gives its stacked sequence)."""
        return {
            name: torch.tensor(
                np.stack([np.asarray(t.named_value(name), np.float32).reshape(-1) for t in traces]),
                dtype=util.dtype(), device=self._device,
            )
            for name in self._params["observe"].keys()
        }

    # ------------------------------------------------------------------
    # serving
    # ------------------------------------------------------------------
    def _serving_params(self):
        """The parameters serving reads: the debiased Polyak/EMA average
        ``ema/(1-d^t)`` when training kept one, else the raw parameters
        (detached).  Memoized until training, ``to`` or a restore changes
        them (or polymorph grows them): the interpreter tier asks once a
        site."""
        key = (
            self._total_train_iterations, self._ema_steps, id(self._params), id(self._ema_params),
            sum(len(v) for v in self._params.values() if isinstance(v, dict)),  # polymorph
        )
        if self._serving_memo is not None and self._serving_memo[0] == key:
            return self._serving_memo[1]
        if self._ema_params is None or self._ema_steps == 0:
            params = map_tensors(self._params, torch.Tensor.detach)
        else:
            scale = 1.0 / (1.0 - float(self._ema_decay) ** self._ema_steps)
            with torch.no_grad():
                params = map_tensors(self._ema_params, lambda t: t * scale)
        self._serving_memo = (key, params)
        return params

    def _head_key(self, address):
        """The key per-address layers are stored under: the full address
        (tied address instances, which strip the instance, come with the
        Markov/SMC slice)."""
        return address

    # ------------------------------------------------------------------
    # stepwise inference, interpreter tier
    # ------------------------------------------------------------------
    @property
    def _infer_observe_embedding(self):
        return getattr(self._infer_tls, "observe_embedding", None)

    @_infer_observe_embedding.setter
    def _infer_observe_embedding(self, v):
        self._infer_tls.observe_embedding = v

    def _infer_init(self, observe=None):
        """Set up stepwise inference for a run observing ``observe``: the
        observe embedding ``[1, O]`` on the network's device, computed once
        for an unchanged ``observe`` dict and network."""
        key = (id(observe), self._total_train_iterations)
        cached = self._infer_emb_cache
        if cached is not None and cached[0] == key and cached[1] is observe:
            emb = cached[2]
        else:
            params = self._serving_params()
            obs = {
                name: util.to_tensor(observe[name], self._device).reshape(1, -1)
                for name in params["observe"].keys()
            }
            with torch.no_grad():
                emb = self._embed_observe_pure(params, obs)
            self._infer_emb_cache = (key, observe, emb)
        self._infer_observe_embedding = emb
        self._infer_begin_trace()

    def _infer_begin_trace(self):
        """Hook: reset the per-trace inference state."""

    @property
    def _infer_lstm_state(self):
        """The recurrent state the interpreter snapshots around a
        ``rejection_sample`` block: None for a network without one."""
        return None

    @_infer_lstm_state.setter
    def _infer_lstm_state(self, v):
        pass

    def _infer_step(self, variable, prev_variable=None, proposal_min_train_iterations=None):
        raise NotImplementedError()

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

    def _polymorph(self, batch):
        raise NotImplementedError()

    def _pack_sub_batch(self, sub_batch):
        """One trace type's materialized traces as the loss's packed dict."""
        from .proposals import prior_param_arrays

        device = self._device

        def rows(arrays):
            return torch.tensor(np.stack(arrays), dtype=util.dtype(), device=device)

        steps = []
        for t in range(sub_batch[0].length_controlled):
            variables = [tr.variables_controlled[t] for tr in sub_batch]
            prior = {}
            for v in variables:
                for k, val in prior_param_arrays(v.distribution).items():
                    prior.setdefault(k, []).append(np.asarray(val, np.float32).reshape(-1))
            steps.append({
                "values": rows([np.asarray(v.value, np.float32) for v in variables]),
                "prior": {k: rows(vals) for k, vals in prior.items()},
            })
        return {"obs": self._pack_observes(sub_batch), "steps": steps}

    def _make_loss_for(self, addrs, dist_names):
        """Return (static_key, loss_fn(params, packed) -> summed loss)."""
        raise NotImplementedError()

    def _loss_params_subset(self, addrs, dist_names):
        """The sub-tree of ``self._params`` a trace type's loss reads."""
        return self._params

    def _pre_generate_layers(self, dataset, batch_size=64, save_file_name_prefix=None):
        """Grow the layers from example traces (a list of traces, or an
        Empirical of them); with ``save_file_name_prefix``, save the
        network after each batch that grew it."""
        traces = dataset.get_values() if hasattr(dataset, "get_values") else list(dataset)
        if not self._layers_initialized:
            self._init_layers_observe_embedding(
                self._observe_embeddings_spec, example_trace=traces[0]
            )
            self._init_layers()
            self._layers_initialized = True
        self._layers_pre_generated = True
        for begin in range(0, len(traces), batch_size):
            changed = self._polymorph(Batch(traces[begin : begin + batch_size]))
            if changed and save_file_name_prefix is not None:
                self._save(f"{save_file_name_prefix}_00000000_pre_generated.network")
        self._vps_cache = None
        util.log_print("Layer pre-generation complete")

    # ------------------------------------------------------------------
    # parameter snapshots
    # ------------------------------------------------------------------
    def snapshot_params(self):
        """Snapshot of the parameters (and the EMA average, when kept) as
        host numpy copies; pair with ``restore_params``."""

        def to_np(tree):
            return map_tensors(tree, lambda t: t.detach().to("cpu", copy=True).numpy())

        return {
            "params": to_np(self._params),
            "ema_params": to_np(self._ema_params),
            "ema_steps": self._ema_steps,
        }

    def restore_params(self, snapshot):
        """Restore a ``snapshot_params`` snapshot.  The optimizer keeps its
        state; the memoized serving step is dropped."""
        training = self._optimizer is not None

        def to_dev(tree, trainable):
            return _map_arrays(
                tree,
                lambda a: torch.tensor(a, dtype=util.dtype(), device=self._device).requires_grad_(trainable),
            )

        self._params = to_dev(snapshot["params"], training)
        self._ema_params = to_dev(snapshot["ema_params"], False)
        self._ema_steps = snapshot.get("ema_steps", 0)
        if training:
            self._create_optimizer(self._optimizer.state_dict())
        self._vps_cache = None
        self._serving_memo = None

    # ------------------------------------------------------------------
    # saving and loading
    # ------------------------------------------------------------------
    def _subclass_state(self):
        return {}

    def _load_subclass_state(self, state):
        pass

    def _state_dict(self):
        """Everything ``_load`` needs, as plain data: parameters, the EMA
        average and the optimizer's state as numpy arrays, enum members by
        name."""

        def host(tree):
            return map_tensors(tree, lambda t: t.detach().to("cpu", copy=True).numpy())

        def named(v):
            return getattr(v, "name", v)

        def embeddings_named(meta):  # {observe name: {key: value}}
            if not isinstance(meta, dict):
                return meta  # a list of observe names
            return {k: {a: named(b) for a, b in m.items()} for k, m in meta.items()}

        return {
            "pyprob_tpu_torch_version": util.__version__,
            "torch_version": str(torch.__version__),
            "network_type": self._network_type,
            "class_name": type(self).__name__,
            "params": host(self._params),
            "optimizer_state": None if self._optimizer is None else host(self._optimizer.state_dict()),
            "ema_params": host(self._ema_params),
            "ema_decay": self._ema_decay,
            "ema_steps": self._ema_steps,
            "observe_meta": embeddings_named(self._observe_meta),
            "observe_embedding_dim": self._observe_embedding_dim,
            "observe_embeddings_spec": embeddings_named(self._observe_embeddings_spec),
            "layers_initialized": self._layers_initialized,
            "layers_pre_generated": self._layers_pre_generated,
            "head_train_iterations": dict(self._head_train_iterations),
            "optimizer_type": named(self._optimizer_type),
            "momentum": self._momentum,
            "weight_decay": self._weight_decay,
            "learning_rate_scheduler_type": named(self._learning_rate_scheduler_type),
            "learning_rate_init": self._learning_rate_init,
            "learning_rate_end": self._learning_rate_end,
            "total_train_seconds": self._total_train_seconds,
            "total_train_traces": self._total_train_traces,
            "total_train_traces_end": self._total_train_traces_end,
            "total_train_iterations": self._total_train_iterations,
            "loss_init": self._loss_init,
            "loss_min": self._loss_min,
            "loss_max": self._loss_max,
            "loss_previous": self._loss_previous,
            "history_train_loss": list(self._history_train_loss),
            "history_train_loss_trace": list(self._history_train_loss_trace),
            "modified": self._modified,
            "updates": self._updates,
            "subclass_state": self._subclass_state(),
        }

    def _save(self, file_name):
        """Write the network to ``file_name``: a gzip tar holding one
        pickle of ``_state_dict``."""
        self._modified = util.get_time_stamp()
        self._updates += 1
        data = self._state_dict()
        tmp_dir = tempfile.mkdtemp(suffix=str(uuid.uuid4()))
        try:
            tmp_file = os.path.join(tmp_dir, _CHECKPOINT_MEMBER)
            with open(tmp_file, "wb") as f:
                pickle.dump(data, f, protocol=pickle.HIGHEST_PROTOCOL)
            with tarfile.open(file_name, "w:gz", compresslevel=2) as tar:
                tar.add(tmp_file, arcname=_CHECKPOINT_MEMBER)
        finally:
            shutil.rmtree(tmp_dir)

    @staticmethod
    def _load(file_name, device=None):
        """The network saved in ``file_name``, on ``device`` (default: the
        port's device), with its optimizer's state; raises RuntimeError
        for a file it cannot read (cut short, or the JAX package's)."""
        from .inference_network_feedforward import InferenceNetworkFeedForward
        from .inference_network_lstm import InferenceNetworkLSTM

        try:
            with tarfile.open(file_name, "r:gz") as tar:
                names = tar.getnames()
                if _CHECKPOINT_MEMBER not in names and _JAX_CHECKPOINT_MEMBER in names:
                    raise ValueError("it is a pyprob_tpu (JAX package) network, whose optax state this port cannot read")
                data = pickle.load(tar.extractfile(_CHECKPOINT_MEMBER))
        except Exception as e:
            raise RuntimeError(f"Cannot load inference network: {e}") from e
        if data["pyprob_tpu_torch_version"] != util.__version__:
            warnings.warn(
                f"Different pyprob_tpu_torch versions (loaded network: "
                f"{data['pyprob_tpu_torch_version']}, current: {util.__version__})"
            )
        cls = {
            "InferenceNetworkFeedForward": InferenceNetworkFeedForward,
            "InferenceNetworkLSTM": InferenceNetworkLSTM,
        }[data["class_name"]]

        def embeddings(meta):  # the inverse of _state_dict's embeddings_named
            if not isinstance(meta, dict):
                return meta
            return {
                k: {a: ObserveEmbedding[b] if a == "embedding" else b for a, b in m.items()}
                for k, m in meta.items()
            }

        net = cls(model=None, observe_embeddings=embeddings(data["observe_embeddings_spec"]), device=device)

        def to_dev(tree):
            return _map_arrays(tree, lambda a: torch.tensor(a, device=net._device))

        net._params = to_dev(data["params"])
        net._ema_params = to_dev(data["ema_params"])
        net._ema_decay = data["ema_decay"]
        net._ema_steps = data["ema_steps"]
        net._observe_meta = embeddings(data["observe_meta"])
        net._observe_embedding_dim = data["observe_embedding_dim"]
        net._layers_initialized = data["layers_initialized"]
        net._layers_pre_generated = data["layers_pre_generated"]
        net._head_train_iterations = data["head_train_iterations"]
        net._optimizer_type = None if data["optimizer_type"] is None else Optimizer[data["optimizer_type"]]
        net._momentum = data["momentum"]
        net._weight_decay = data["weight_decay"]
        sched = data["learning_rate_scheduler_type"]
        net._learning_rate_scheduler_type = None if sched is None else LearningRateScheduler[sched]
        for key in (
            "learning_rate_init", "learning_rate_end", "total_train_seconds", "total_train_traces",
            "total_train_traces_end", "total_train_iterations", "loss_init", "loss_min", "loss_max",
            "loss_previous", "history_train_loss", "history_train_loss_trace", "modified", "updates",
        ):
            setattr(net, "_" + key, data[key])
        net._load_subclass_state(data["subclass_state"])
        if net._optimizer_type is not None and data["optimizer_state"] is not None:
            net._create_optimizer(_map_arrays(data["optimizer_state"], torch.from_numpy))
        return net

    # ------------------------------------------------------------------
    # Polyak/EMA parameter averaging
    # ------------------------------------------------------------------
    def _ema_sync_structure(self):
        """Initialize the EMA tree, or graft newly polymorphed leaves into
        it.  ``_ema_params`` is the raw (biased) accumulator
        e_t = d·e + (1−d)·p from e_0 = 0, served as e/(1−d^t); a leaf
        grafted at step t adopts p·(1−d^t), so its debiased value starts
        at p."""
        if self._ema_decay is None:
            return
        bias = 1.0 - float(self._ema_decay) ** max(self._ema_steps, 0)

        def adopt(tree):
            return map_tensors(tree, lambda t: t.detach() * bias)

        if self._ema_params is None:
            self._ema_params = map_tensors(self._params, lambda t: torch.zeros_like(t.detach()))
            return

        def merge(e, p):
            if isinstance(p, dict):
                if not isinstance(e, dict):
                    return adopt(p)
                return {k: merge(e[k], v) if k in e else adopt(v) for k, v in p.items()}
            if isinstance(p, list):
                if not isinstance(e, list) or len(e) != len(p):
                    return adopt(p)
                return [merge(a, b) for a, b in zip(e, p)]
            if not isinstance(p, torch.Tensor):
                return p
            if not isinstance(e, torch.Tensor) or e.shape != p.shape:
                return adopt(p)
            return e

        self._ema_params = merge(self._ema_params, self._params)

    def _ema_update_host(self):
        """One EMA step, e = d·e + (1−d)·p, in place over every leaf."""
        if self._ema_decay is None:
            return
        ema = tensor_leaves(self._ema_params) if self._ema_params is not None else []
        params = tensor_leaves(self._params)
        if len(ema) != len(params) or any(e.shape != p.shape for e, p in zip(ema, params)):
            self._ema_sync_structure()
            ema = tensor_leaves(self._ema_params)
        d = float(self._ema_decay)
        with torch.no_grad():
            torch._foreach_mul_(ema, d)
            torch._foreach_add_(ema, params, alpha=1.0 - d)
        self._ema_steps += 1

    # ------------------------------------------------------------------
    # packing device batches
    # ------------------------------------------------------------------
    def _pack_arrays_from_outputs(self, outputs, sites, batch_size):
        """Batched-tier outputs -> the loss's packed dict:
        ``{"obs": {name: [B, D]}, "steps": [{"values": [B],
        "prior": {param: [B, P]}}]}``, every tensor left on its device."""
        from .proposals import prior_param_arrays

        if getattr(self, "_local_observe_dim", 0):
            raise _not_ported(
                "the per-step local observation slot (tied-instance Markov networks)",
                "Markov/SMC slice",
            )
        if outputs.get("masks"):
            raise _not_ported("training on sample(mask=) sites", "masks slice")
        controlled = [s for s in sites if s.control]
        name_addresses = {}
        for s in sites:
            if s.name is not None:
                name_addresses.setdefault(s.name, []).append(s.address)
        obs = {}
        for name in self._params["observe"].keys():
            addrs_n = name_addresses[name]
            if len(addrs_n) == 1:
                arr = outputs["values"][addrs_n[0]]
            else:
                # a repeated name gives its sequence, as Trace.named_value
                arr = torch.stack([outputs["values"][a] for a in addrs_n], dim=1)
            obs[name] = arr.reshape(batch_size, -1)

        def pack_prior(v):
            # per-row parameters keep their rows, flattened to [B, P];
            # shared ones broadcast
            arr = util.to_tensor(v)
            if arr.dim() > 0 and arr.shape[0] == batch_size:
                return arr.reshape(batch_size, -1)
            return arr.reshape(1, -1).expand(batch_size, max(arr.numel(), 1))

        steps = [
            {
                "values": outputs["values"][s.address],
                "prior": {k: pack_prior(v) for k, v in prior_param_arrays(s.distribution).items()},
            }
            for s in controlled
        ]
        addrs = tuple(s.address for s in controlled)
        dist_names = tuple(s.distribution.name for s in controlled)
        return {"obs": obs, "steps": steps}, addrs, dist_names

    def _packed_batch_from_outputs(self, outputs, sites, batch_size):
        packed, addrs, dist_names = self._pack_arrays_from_outputs(outputs, sites, batch_size)
        return PackedBatch(packed, batch_size, addrs, dist_names)

    # ------------------------------------------------------------------
    # loss, gradients and the optimizer
    # ------------------------------------------------------------------
    def _bump_head_iterations(self, addrs):
        """Per-address counters of the optimizer steps that trained them."""
        for addr in addrs:
            self._head_train_iterations[addr] = self._head_train_iterations.get(addr, 0) + 1

    def _batch_addresses(self, batch):
        """The controlled addresses a batch trains, each once."""
        return dict.fromkeys(a for addrs, _, _ in self._trace_types(batch) for a in addrs)

    @staticmethod
    def _trace_types(batch):
        """(addrs, dist_names, sub-batch or None) per trace type of a batch."""
        if isinstance(batch, PackedBatch):
            return [(batch.addrs, batch.dist_names, None)]
        return [
            (
                tuple(v.address for v in sb[0].variables_controlled),
                tuple(v.distribution.name for v in sb[0].variables_controlled),
                sb,
            )
            for sb in batch.sub_batches
        ]

    def _loss_and_grad(self, batch):
        """Loss/B of a batch, with grads/B left in the leaves' ``.grad``
        (zeros for leaves no trace type reads, as the JAX package pads
        them): the gather-table loss when the subclass serves the batch
        with it, else one per-type loss per trace type.  Returns the loss
        as a 0-d device tensor."""
        leaves = tensor_leaves(self._params)
        for p in leaves:
            p.grad = None
        loss = self._try_gather_loss(batch)
        if loss is None:
            loss = self._per_type_loss(batch)
        loss.backward()
        for p in leaves:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        return loss.detach()

    def _per_type_loss(self, batch):
        """Loss/B of a batch as one per-type loss per trace type."""
        total = None
        for addrs, dist_names, sub_batch in self._trace_types(batch):
            packed = batch.packed if sub_batch is None else self._pack_sub_batch(sub_batch)
            _, loss_fn = self._make_loss_for(addrs, dist_names)
            part = loss_fn(self._loss_params_subset(addrs, dist_names), packed)
            total = part if total is None else total + part
        return total / batch.size

    def _try_gather_loss(self, batch):
        """Subclass hook: the gather-table loss/B of a materialized batch of
        mixed trace types (``gather_loss.py``), or None for the per-type
        loss."""
        return None

    def _create_optimizer(self, state_dict=None):
        """A fresh optimizer over the parameter leaves (made trainable
        here), optionally carrying ``state_dict`` of an earlier one."""
        if self._optimizer_type is None:
            return
        if self._optimizer_type in (Optimizer.ADAM_LARC, Optimizer.SGD_LARC):
            raise _not_ported(f"{self._optimizer_type.name} (optimizer_larc.py)", "LARC slice")
        leaves = [p.requires_grad_(True) for p in tensor_leaves(self._params)]
        wd = self._weight_decay or 0.0
        lr = self._current_learning_rate()
        if self._optimizer_type == Optimizer.ADAM:
            # optax add_decayed_weights + scale_by_adam, then -lr
            self._optimizer = torch.optim.Adam(leaves, lr=lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=wd)
        else:
            # optax add_decayed_weights + trace(nesterov=True), then -lr
            self._optimizer = torch.optim.SGD(
                leaves, lr=lr, momentum=self._momentum or 0.9, nesterov=True, weight_decay=wd,
            )
        if state_dict is not None:
            self._optimizer.load_state_dict(state_dict)

    def _optimizer_step(self, lr):
        """One update of every leaf from its ``.grad`` at learning rate lr."""
        for group in self._optimizer.param_groups:
            group["lr"] = lr
        self._optimizer.step()

    def _current_learning_rate(self):
        """Poly learning-rate decay by total trained traces."""
        lr_init = self._learning_rate_init
        lr_end = self._learning_rate_end
        t = self._learning_rate_scheduler_type
        if t in (None, LearningRateScheduler.NONE):
            return lr_init
        iter_end = self._total_train_traces_end or 1e9
        frac = min(self._total_train_traces / iter_end, 1.0)
        power = 1.0 if t == LearningRateScheduler.POLY1 else 2.0
        return (lr_init - lr_end) * ((1 - frac) ** power) + lr_end

    @property
    def learning_rate(self):
        return self._current_learning_rate()

    # ------------------------------------------------------------------
    # the training loop
    # ------------------------------------------------------------------
    def _record_loss(self, loss, lr, step_traces, time_start, prev_total_train_seconds,
                     state, log_file):
        """Counters, loss history, progress line and log row of one step;
        returns False on a bad loss."""
        now = time.time()
        self._total_train_seconds = prev_total_train_seconds + (now - time_start)
        bad = math.isnan(loss) or math.isinf(loss)
        if bad:
            util.log_print(
                f"Bad loss in training step: {loss} (if the model's observations "
                "are heavy-tailed, consider observe_embeddings={'name': "
                "{'input_transform': 'arcsinh'}})"
            )
        if self._loss_init is None:
            self._loss_init = loss
            self._loss_max = loss
        self._loss_min = min(self._loss_min, loss)
        self._loss_max = max(self._loss_max, loss)
        self._loss_previous = loss
        self._history_train_loss.append(loss)
        self._history_train_loss_trace.append(self._total_train_traces)
        tps = step_traces / max(now - state["time_last_batch"], 1e-9)
        state["time_last_batch"] = now
        if now - state["last_print"] > util._print_refresh_rate:
            state["last_print"] = now
            util.log_print(
                f"{self._total_train_seconds:9.2f}s | {self._total_train_traces:9,} | "
                f"loss {loss:+.3e} | min {self._loss_min:+.3e} | lr {lr:+.2e} | "
                f"{tps:,.1f} traces/s"
            )
        if log_file is not None:
            log_file.write(
                f"{self._total_train_seconds}, {self._total_train_iterations}, "
                f"{self._total_train_traces}, {loss}, , {lr}, , 1, , {tps}\n"
            )
        return not bad

    def _online_optimize(self, dataset, num_traces, batch_size, stop_with_bad_loss,
                         log_file, time_start, prev_total_train_seconds,
                         save_file_name_prefix=None, save_every_sec=None):
        """The online loop, one optimizer step per batch: device batches
        for a model that runs on the batched tier, materialized ones for a
        model that runs only on the interpreter tier.  A materialized batch
        is polymorphed first, and when it grew new layers the optimizer is
        recreated with fresh state, as the JAX package's loop does.  With
        ``save_file_name_prefix`` the network is saved when more than
        ``save_every_sec`` seconds passed since the last save: first after
        ``save_every_sec`` on the batched tier (the JAX package's fused
        loop), at the loop's first step on the interpreter tier (its
        generic loop)."""
        state = {"time_last_batch": time_start, "last_print": time_start - util._print_refresh_rate}
        # first batch: materialized, for polymorph and one step; a loaded
        # optimizer state survives unless the parameter structure changed
        first = Batch(dataset.next_batch(batch_size))
        layers_changed = self._polymorph(first)
        if self._optimizer is None or layers_changed:
            self._create_optimizer()
        loss = float(self._loss_and_grad(first))
        lr = self._current_learning_rate()
        if not (math.isnan(loss) or math.isinf(loss)):
            self._optimizer_step(lr)
            self._bump_head_iterations(self._batch_addresses(first))
            self._total_train_iterations += 1
            self._total_train_traces += first.size
            self._ema_update_host()
        self._ema_sync_structure()  # polymorph may have grown the params
        trace_count = first.size
        last_save = None
        while trace_count < num_traces:
            lr = self._current_learning_rate()
            device_batch = dataset.next_device_batch(batch_size)
            if device_batch is None:
                batch = Batch(dataset.next_batch(batch_size))
                if self._polymorph(batch):
                    self._create_optimizer()
            else:
                batch = self._packed_batch_from_outputs(*device_batch, batch_size)
            loss_dev = self._loss_and_grad(batch)
            self._optimizer_step(lr)
            self._ema_update_host()
            self._bump_head_iterations(self._batch_addresses(batch))
            self._total_train_iterations += 1
            trace_count += batch.size
            self._total_train_traces += batch.size
            # the step's one host sync: the loss, read after the update
            # was enqueued
            ok = self._record_loss(
                float(loss_dev), lr, batch.size, time_start, prev_total_train_seconds,
                state, log_file,
            )
            if save_file_name_prefix is not None and save_every_sec is not None:
                if last_save is None:
                    last_save = time_start - (save_every_sec if device_batch is None else 0)
                now = time.time()
                if now - last_save > save_every_sec:
                    last_save = now
                    self._save(self._save_file_name(save_file_name_prefix))
            if not ok and stop_with_bad_loss:
                return

    def _save_file_name(self, prefix):
        return f"{prefix}_{util.get_time_stamp()}_traces_{self._total_train_traces}.network"

    def optimize(
        self,
        num_traces,
        dataset,
        dataset_valid=None,
        num_traces_end=1e9,
        batch_size=64,
        valid_every=None,
        optimizer_type=Optimizer.ADAM,
        learning_rate_init=0.0001,
        learning_rate_end=1e-6,
        learning_rate_scheduler_type=LearningRateScheduler.NONE,
        momentum=0.9,
        weight_decay=1e-5,
        save_file_name_prefix=None,
        save_every_sec=600,
        distributed_backend=None,
        distributed_params_sync_every_iter=10000,
        distributed_num_buckets=None,
        distributed_rank=0,
        distributed_world_size=1,
        stop_with_bad_loss=False,
        log_file_name=None,
        ema_decay=None,
        keep_best=False,
        keep_best_every=None,
        keep_best_metric=None,
    ):
        """Train online for ``num_traces`` traces (in whole batches).
        ``ema_decay``: keep a Polyak/EMA average of the parameters per
        optimizer step and serve proposals from it, debiased.  The
        learning-rate settings, the optimizer and ``num_traces_end`` are
        latched by the first call; later calls continue the schedule on
        the cumulative trace count.  ``save_file_name_prefix``: save the
        network every ``save_every_sec`` seconds and at the end, as
        ``{prefix}_{time stamp}_traces_{trained traces}.network``."""
        if not isinstance(dataset, OnlineDataset):
            raise _not_ported("training from an offline dataset", "offline-dataset slice")
        if distributed_backend is not None:
            raise _not_ported(f"distributed_backend={distributed_backend!r}", "distributed slice")
        if dataset_valid is not None:
            raise _not_ported("validation (dataset_valid)", "offline-dataset slice")
        if keep_best:
            raise _not_ported("keep_best checkpoint selection", "offline-dataset slice")
        if optimizer_type in (Optimizer.ADAM_LARC, Optimizer.SGD_LARC):
            raise _not_ported(f"{optimizer_type.name} (optimizer_larc.py)", "LARC slice")
        if not self._layers_initialized:
            self._init_layers_observe_embedding(self._observe_embeddings_spec, example_trace=dataset[0])
            self._init_layers()
            self._layers_initialized = True
        if self._optimizer_type is None:
            self._optimizer_type = optimizer_type
        if self._momentum is None:
            self._momentum = momentum
        if self._weight_decay is None:
            self._weight_decay = weight_decay
        if self._learning_rate_scheduler_type is None:
            self._learning_rate_scheduler_type = learning_rate_scheduler_type
        if self._learning_rate_init is None:
            self._learning_rate_init = learning_rate_init
        if self._learning_rate_end is None:
            self._learning_rate_end = learning_rate_end
        if self._total_train_traces_end is None:
            self._total_train_traces_end = num_traces_end
        if ema_decay is not None:
            self._ema_decay = ema_decay
        log_file = None
        if log_file_name is not None:
            log_file = open(log_file_name, mode="w", buffering=1)
            log_file.write(
                "time, iteration, trace, loss, valid_loss, learning_rate, "
                "mean_trace_length_controlled, sub_mini_batches, "
                "distributed_bucket_id, traces_per_second\n"
            )
        try:
            self._online_optimize(
                dataset, num_traces, batch_size, stop_with_bad_loss, log_file,
                time.time(), self._total_train_seconds, save_file_name_prefix, save_every_sec,
            )
        finally:
            if log_file is not None:
                log_file.close()
        if save_file_name_prefix is not None:
            self._save(self._save_file_name(save_file_name_prefix))


def _map_arrays(tree, fn):
    """Apply ``fn`` to every numpy array leaf of a nested dict/list."""
    if isinstance(tree, np.ndarray):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map_arrays(v, fn) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_arrays(v, fn) for v in tree]
    return tree
