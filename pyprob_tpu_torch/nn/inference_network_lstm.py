"""LSTM inference network, the inference-compilation architecture
(counterpart of ``pyprob_tpu/nn/inference_network_lstm.py``).

Per-address sample embeddings, learned address embeddings and
distribution-type embeddings feed an LSTM core whose features drive
per-address proposal heads.  On the batched tier the proposal step runs
once per site over the whole ``[N]`` particle batch: the observe embedding
is computed once per run and expanded, the LSTM state is ``[depth, N, H]``,
and the head's mixture is scored by the mixture kernel.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import util
from ..util import ObserveEmbedding
from ..vectorized import _draw
from .inference_network import InferenceNetwork
from .layers import (
    _tensor,
    lstm_from_numpy,
    lstm_init,
    lstm_step,
    lstm_zero_state,
    mlp_apply,
    mlp_from_numpy,
    mlp_init,
)
from .proposals import (
    head_apply,
    head_from_numpy,
    head_init,
    head_kind_for,
    prior_param_arrays,
)


class InferenceNetworkLSTM(InferenceNetwork):
    def __init__(
        self,
        lstm_dim=512,
        lstm_depth=1,
        sample_embedding_dim=4,
        address_embedding_dim=64,
        distribution_type_embedding_dim=8,
        proposal_mixture_components=10,
        *args,
        **kwargs,
    ):
        super().__init__(network_type="InferenceNetworkLSTM", *args, **kwargs)
        self._params["proposal"] = {}
        self._params["sample_embedding"] = {}
        self._params["address_embedding"] = {}
        self._params["dist_type_embedding"] = {}
        self._params["lstm"] = None
        self._head_meta = {}
        self._lstm_dim = lstm_dim
        self._lstm_depth = lstm_depth
        self._lstm_input_dim = None
        self._sample_embedding_dim = sample_embedding_dim
        self._address_embedding_dim = address_embedding_dim
        self._distribution_type_embedding_dim = distribution_type_embedding_dim
        self._proposal_mixture_components = proposal_mixture_components

    def _init_layers(self):
        self._lstm_input_dim = (
            self._observe_embedding_dim
            + self._sample_embedding_dim
            + 2 * (self._address_embedding_dim + self._distribution_type_embedding_dim)
        )
        self._params["lstm"] = lstm_init(
            self._generator(), self._lstm_input_dim, self._lstm_dim, self._device,
            self._lstm_depth,
        )

    def _polymorph(self, sub_batches):
        """Grow per-address layers for the controlled sites of each
        sub-batch's example trace."""
        g, device = self._generator(), self._device
        layers_changed = False
        for sub_batch in sub_batches:
            for variable in sub_batch[0].variables_controlled:
                address = variable.address
                distribution = variable.distribution
                if address not in self._params["address_embedding"]:
                    self._params["address_embedding"][address] = torch.randn(
                        (self._address_embedding_dim,), generator=g,
                        dtype=util.dtype(), device=device,
                    )
                    layers_changed = True
                if distribution.name not in self._params["dist_type_embedding"]:
                    self._params["dist_type_embedding"][distribution.name] = torch.randn(
                        (self._distribution_type_embedding_dim,), generator=g,
                        dtype=util.dtype(), device=device,
                    )
                    layers_changed = True
                if address not in self._params["proposal"]:
                    kind = head_kind_for(distribution)
                    if kind is None:
                        raise RuntimeError(
                            f"Distribution currently unsupported: {distribution.name}"
                        )
                    self._params["proposal"][address] = head_init(
                        g, kind, self._lstm_dim, device,
                        mixture_components=self._proposal_mixture_components,
                    )
                    value_shape = tuple(np.shape(variable.value)) or (1,)
                    self._params["sample_embedding"][address] = mlp_init(
                        g, value_shape, (self._sample_embedding_dim,), device,
                        num_layers=1,
                    )
                    self._head_meta[address] = {
                        "kind": kind,
                        "num_categories": None,
                        "dist_name": distribution.name,
                    }
                    self._head_train_iterations.setdefault(address, 0)
                    layers_changed = True
                    util.log_print(
                        f"New layers, address: {util.truncate_str(address)}, "
                        f"distribution: {distribution.name}"
                    )
        return layers_changed

    @classmethod
    def from_numpy(cls, model, params, meta, device=None):
        """A network carrying the JAX package's weights.

        ``params``: ``net.snapshot_params()["params"]`` of a
        ``pyprob_tpu`` ``InferenceNetworkLSTM``, with every ``Static`` leaf
        replaced by its ``.value``.  ``meta``: ``head_meta``,
        ``observe_meta``, ``observe_embedding_dim``, ``lstm_input_dim``,
        ``local_observe_dim`` and the constructor's dimensions
        (``lstm_dim``, ``lstm_depth``, ``sample_embedding_dim``,
        ``address_embedding_dim``, ``distribution_type_embedding_dim``,
        ``proposal_mixture_components``).  Linear weights ``[in, out]`` and
        LSTM weights ``[in, 4H]``, ``[H, 4H]`` are transposed to PyTorch's
        layout here."""
        if meta.get("local_observe_dim", 0):
            raise NotImplementedError(
                "per-step local observation slots (tied-instance Markov "
                "networks) come with the Markov/SMC slice"
            )
        net = cls(
            model=model,
            lstm_dim=meta["lstm_dim"],
            lstm_depth=meta["lstm_depth"],
            sample_embedding_dim=meta["sample_embedding_dim"],
            address_embedding_dim=meta["address_embedding_dim"],
            distribution_type_embedding_dim=meta["distribution_type_embedding_dim"],
            proposal_mixture_components=meta["proposal_mixture_components"],
            device=device,
        )
        d = net._device
        net._observe_params_from_numpy(params)
        net._observe_meta = {}
        for name, m in meta["observe_meta"].items():
            m = dict(m)
            # the JAX package's enum member, or its name
            m["embedding"] = ObserveEmbedding[getattr(m["embedding"], "name", m["embedding"])]
            net._observe_meta[name] = m
        net._observe_embedding_dim = meta["observe_embedding_dim"]
        net._lstm_input_dim = meta["lstm_input_dim"]
        net._params["lstm"] = lstm_from_numpy(params["lstm"], d)
        net._params["proposal"] = {
            a: head_from_numpy(p, d) for a, p in params["proposal"].items()
        }
        net._params["sample_embedding"] = {
            a: mlp_from_numpy(p, d) for a, p in params["sample_embedding"].items()
        }
        net._params["address_embedding"] = {
            a: _tensor(v, d) for a, v in params["address_embedding"].items()
        }
        net._params["dist_type_embedding"] = {
            n: _tensor(v, d) for n, v in params["dist_type_embedding"].items()
        }
        net._head_meta = {a: dict(m) for a, m in meta["head_meta"].items()}
        net._head_train_iterations = {a: 0 for a in net._head_meta}
        net._layers_initialized = True
        return net

    # ------------------------------------------------------------------
    # batched guided inference
    # ------------------------------------------------------------------
    def make_vectorized_proposal_step(self, observe=None):
        params = self._serving_params()
        head_meta = self._head_meta
        embed = self._embed_observe_pure
        device = self._device
        S, A, D = (
            self._sample_embedding_dim,
            self._address_embedding_dim,
            self._distribution_type_embedding_dim,
        )
        state = {}

        def reset(num_particles):
            state["n"] = num_particles
            state["lstm"] = lstm_zero_state(params["lstm"], (num_particles,), device)
            state["prev"] = None  # (address, [n] values, dist name)
            state["emb"] = None

        def _emb(observed):
            # the observe embedding is the same for every particle: one row
            # per run, expanded over the batch
            if state["emb"] is None:
                obs = {
                    name: util.to_tensor(observed[name], device).reshape(1, -1)
                    for name in params["observe"].keys()
                }
                state["emb"] = embed(params, obs)
            return state["emb"]

        def proposal_step(site, distribution, generator, observed, forced_value=None):
            """Propose (or, given ``forced_value`` [n], score) the values of
            one site for the whole batch: returns ([n] values, [n] log q)."""
            n = state["n"]
            addr = site.address
            if addr not in head_meta:
                value = forced_value if forced_value is not None else _draw(
                    distribution, n, generator
                )
                return value, distribution.log_prob(value).expand(n)
            emb = _emb(observed)
            prev = state["prev"]
            if prev is not None and prev[0] in params["sample_embedding"]:
                prev_addr, prev_value, prev_dist_name = prev
                prev_sample_emb = mlp_apply(
                    params["sample_embedding"][prev_addr], prev_value.reshape(n, -1)
                )
                prev_addr_emb = params["address_embedding"][prev_addr]
                prev_dist_emb = params["dist_type_embedding"][prev_dist_name]
            else:
                prev_sample_emb = torch.zeros((n, S), dtype=util.dtype(), device=device)
                prev_addr_emb = torch.zeros((A,), dtype=util.dtype(), device=device)
                prev_dist_emb = torch.zeros((D,), dtype=util.dtype(), device=device)
            x = torch.cat(
                [
                    emb.expand(n, -1),
                    prev_sample_emb,
                    prev_dist_emb.expand(n, -1),
                    prev_addr_emb.expand(n, -1),
                    params["dist_type_embedding"][distribution.name].expand(n, -1),
                    params["address_embedding"][addr].expand(n, -1),
                ],
                dim=1,
            )
            out, state["lstm"] = lstm_step(params["lstm"], x, state["lstm"])
            prior = {
                k: util.to_tensor(v, device)
                for k, v in prior_param_arrays(distribution).items()
            }
            d = head_apply(params["proposal"][addr], out, prior)
            if forced_value is not None:
                value = util.to_tensor(forced_value, device).reshape(n)
            else:
                value = d.sample(generator)
            plp = d.log_prob(value)
            state["prev"] = (addr, value, distribution.name)
            return value, plp

        proposal_step.reset = reset
        return proposal_step
