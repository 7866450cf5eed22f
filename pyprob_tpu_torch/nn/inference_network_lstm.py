"""LSTM inference network, the inference-compilation architecture
(counterpart of ``pyprob_tpu/nn/inference_network_lstm.py``).

Per-address sample embeddings, learned address embeddings and
distribution-type embeddings feed an LSTM core whose features drive
per-address proposal heads.  On the batched tier the proposal step runs
once per site over the whole ``[N]`` particle batch: the observe embedding
is computed once per run and expanded, the LSTM state is ``[depth, N, H]``,
and the head's mixture is scored by the mixture kernels.  For the retries
of a ``rejection_sample`` block the step proposes from a defensive mixture
with the prior and exposes its recurrent state (``get_state``,
``set_state``, ``select_state``), so each retry restarts from the
pre-block state and each lane continues from its accepted attempt's.
The training loss (``_make_loss_for``) runs the same layers over a packed
``[B]`` batch, one ``lstm_step`` per controlled site, and is −Σ log q of
the batch's values, its gradient reaching the heads through the mixture
kernels' backward.  A materialized batch of several trace types (a
variable-structure model on the interpreter tier) takes the gather-table
loss instead (``gather_loss.py``): one pass over the batch, the heads of
every active (step, trace) cell scored by one mixture-kernel call.  On the
interpreter tier ``_infer_step`` proposes one site of one trace: an LSTM
step and a head at one row on the network's device, its output copied to
the host once, the proposal returned with CPU parameters.
"""

from __future__ import annotations

import math
import warnings

import numpy as np
import torch

from .. import util
from ..vectorized import _draw, _select
from .inference_network import InferenceNetwork
from .layers import (
    _host,
    _tensor,
    lstm_from_numpy,
    lstm_init,
    lstm_step,
    lstm_to_numpy,
    lstm_zero_state,
    mlp_apply,
    mlp_from_numpy,
    mlp_init,
    mlp_to_numpy,
)
from . import gather_loss as gl
from .proposals import (
    head_apply,
    head_distribution,
    head_from_numpy,
    head_init,
    head_kind_for,
    head_to_numpy,
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
        self._gather_used = False
        self._gather_reg = None  # (version, GatherRegistry)

    def _subclass_state(self):
        return {
            "head_meta": self._head_meta,
            "lstm_dim": self._lstm_dim,
            "lstm_depth": self._lstm_depth,
            "lstm_input_dim": self._lstm_input_dim,
            "sample_embedding_dim": self._sample_embedding_dim,
            "address_embedding_dim": self._address_embedding_dim,
            "distribution_type_embedding_dim": self._distribution_type_embedding_dim,
            "proposal_mixture_components": self._proposal_mixture_components,
            "gather_used": self._gather_used,
        }

    def _load_subclass_state(self, state):
        for key, value in state.items():
            setattr(self, "_" + key, value)

    @property
    def _infer_lstm_state(self):
        return getattr(self._infer_tls, "lstm_state", None)

    @_infer_lstm_state.setter
    def _infer_lstm_state(self, v):
        self._infer_tls.lstm_state = v

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

    def _polymorph(self, batch):
        """Grow per-address layers for the controlled sites of each
        sub-batch's example trace."""
        g, device = self._generator(), self._device
        layers_changed = False
        for sub_batch in batch.sub_batches:
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
        net._params.update(net._params_from_numpy(params))
        net._set_meta_from_numpy(meta)
        net._lstm_input_dim = meta["lstm_input_dim"]
        return net

    def _params_from_numpy(self, params):
        """The port's parameter tree (PyTorch layout, on this network's
        device) from a tree in the JAX package's layout."""
        d = self._device
        out = self._observe_params_from_numpy(params)
        out["lstm"] = lstm_from_numpy(params["lstm"], d)
        out["proposal"] = {a: head_from_numpy(p, d) for a, p in params["proposal"].items()}
        out["sample_embedding"] = {
            a: mlp_from_numpy(p, d) for a, p in params["sample_embedding"].items()
        }
        out["address_embedding"] = {a: _tensor(v, d) for a, v in params["address_embedding"].items()}
        out["dist_type_embedding"] = {
            n: _tensor(v, d) for n, v in params["dist_type_embedding"].items()
        }
        return out

    def to_numpy(self, params=None):
        """``params`` (default: the network's own; also a tree of their
        gradients) in the JAX package's layout as numpy arrays: the inverse
        of ``from_numpy``, linear and LSTM weights transposed back."""
        p = self._params if params is None else params
        out = self._observe_params_to_numpy(p)
        out["lstm"] = lstm_to_numpy(p["lstm"])
        out["proposal"] = {a: head_to_numpy(h) for a, h in p["proposal"].items()}
        out["sample_embedding"] = {a: mlp_to_numpy(m) for a, m in p["sample_embedding"].items()}
        out["address_embedding"] = {a: _host(v) for a, v in p["address_embedding"].items()}
        out["dist_type_embedding"] = {n: _host(v) for n, v in p["dist_type_embedding"].items()}
        return out

    # ------------------------------------------------------------------
    # training loss
    # ------------------------------------------------------------------
    def _loss_params_subset(self, addrs, dist_names):
        """Only the keys the LSTM loss reads."""
        p = self._params
        keys = set(addrs)
        return {
            "observe": p["observe"],
            "observe_final": p["observe_final"],
            "lstm": p["lstm"],
            "proposal": {a: p["proposal"][a] for a in keys},
            "sample_embedding": {a: p["sample_embedding"][a] for a in keys},
            "address_embedding": {a: p["address_embedding"][a] for a in keys},
            "dist_type_embedding": {n: p["dist_type_embedding"][n] for n in set(dist_names)},
        }

    def _make_loss_for(self, addrs, dist_names):
        for addr in addrs:
            if addr not in self._params["proposal"]:
                raise RuntimeError(f"Address unknown by inference network: {addr}")
        embed = self._embed_observe_pure
        S = self._sample_embedding_dim
        A = self._address_embedding_dim
        D = self._distribution_type_embedding_dim

        def loss_fn(params, packed):
            emb = embed(params, packed["obs"])  # [B, O]
            B, device = emb.shape[0], emb.device
            state = lstm_zero_state(params["lstm"], (B,), device)
            total = torch.zeros((), dtype=util.dtype(), device=device)
            for t, addr in enumerate(addrs):
                if t == 0:
                    prev_sample_emb = torch.zeros((B, S), dtype=util.dtype(), device=device)
                    prev_addr_emb = torch.zeros((B, A), dtype=util.dtype(), device=device)
                    prev_dist_emb = torch.zeros((B, D), dtype=util.dtype(), device=device)
                else:
                    prev_addr = addrs[t - 1]
                    prev_sample_emb = mlp_apply(
                        params["sample_embedding"][prev_addr], packed["steps"][t - 1]["values"]
                    )
                    prev_addr_emb = params["address_embedding"][prev_addr].expand(B, A)
                    prev_dist_emb = params["dist_type_embedding"][dist_names[t - 1]].expand(B, D)
                x = torch.cat(
                    [
                        emb,
                        prev_sample_emb,
                        prev_dist_emb,
                        prev_addr_emb,
                        params["dist_type_embedding"][dist_names[t]].expand(B, D),
                        params["address_embedding"][addr].expand(B, A),
                    ],
                    dim=1,
                )
                out, state = lstm_step(params["lstm"], x, state)
                step = packed["steps"][t]
                d = head_apply(params["proposal"][addr], out, step["prior"])
                lp = d.log_prob(step["values"])
                lp = torch.clamp(lp, min=-1e38)  # -inf repair, as the JAX package
                total = total - lp.sum()
            return total

        return ("lstm", tuple(addrs)), loss_fn

    # ------------------------------------------------------------------
    # gather-table loss (gather_loss.py)
    # ------------------------------------------------------------------
    def _gather_registry(self):
        version = gl.GatherRegistry.version_of(self._params)
        if self._gather_reg is None or self._gather_reg[0] != version:
            self._gather_reg = (version, gl.GatherRegistry(self._params))
        return self._gather_reg[1]

    def _prepare_gather(self, batch):
        """(registry, packed, head group, sample-embedding group, addresses)
        for a materialized batch the gather loss serves, else None.  A
        batch of one trace type keeps the per-type loss until the gather
        loss has served this network once."""
        if not getattr(batch, "traces", None):
            return None
        if len(batch.sub_batches) <= 1 and not self._gather_used:
            return None
        reg = self._gather_registry()
        prep = gl.pack_batch(self, reg, batch)
        if prep is None:
            return None
        self._gather_used = True
        return (reg,) + prep

    def _try_gather_loss(self, batch):
        prep = self._prepare_gather(batch)
        if prep is None:
            return None
        reg, packed, head_gkey, semb_gkey, _ = prep
        tables = gl.stack_tables(self._params, reg, head_gkey, semb_gkey)
        return gl.make_gather_loss(self._embed_observe_pure)(tables, packed)

    # ------------------------------------------------------------------
    # stepwise inference, interpreter tier
    # ------------------------------------------------------------------
    def _infer_begin_trace(self):
        self._infer_lstm_state = None

    @torch.no_grad()
    def _infer_step(self, variable, prev_variable=None, proposal_min_train_iterations=None):
        """The proposal of ``variable``'s site given the previous controlled
        variable of the trace (None at its first), with CPU parameters; the
        prior itself where the network has no proposal for the site."""
        address = self._head_key(variable.address)
        distribution = variable.distribution
        params = self._serving_params()
        device = self._device
        S, A, D = (
            self._sample_embedding_dim,
            self._address_embedding_dim,
            self._distribution_type_embedding_dim,
        )
        if prev_variable is None:
            self._infer_lstm_state = lstm_zero_state(params["lstm"], (1,), device)
            prev_sample_emb = torch.zeros((1, S), dtype=util.dtype(), device=device)
            prev_addr_emb = torch.zeros((A,), dtype=util.dtype(), device=device)
            prev_dist_emb = torch.zeros((D,), dtype=util.dtype(), device=device)
        else:
            prev_address = self._head_key(prev_variable.address)
            if prev_address not in params["address_embedding"]:
                warnings.warn(f"Address of previous variable unknown by inference network: {prev_address}")
                return distribution
            prev_value = util.to_tensor(prev_variable.value, device).reshape(1, -1)
            prev_sample_emb = mlp_apply(params["sample_embedding"][prev_address], prev_value)
            prev_addr_emb = params["address_embedding"][prev_address]
            prev_dist_emb = params["dist_type_embedding"][prev_variable.distribution.name]
        if address not in params["address_embedding"]:
            warnings.warn(f"Using prior. No proposal for address: {address}")
            return distribution
        if (
            proposal_min_train_iterations is not None
            and self._head_train_iterations.get(address, 0) < proposal_min_train_iterations
        ):
            warnings.warn(f"Using prior. Proposal not sufficiently trained for address: {address}")
            return distribution
        x = torch.cat(
            [
                self._infer_observe_embedding[0],
                prev_sample_emb[0],
                prev_dist_emb,
                prev_addr_emb,
                params["dist_type_embedding"][distribution.name],
                params["address_embedding"][address],
            ]
        ).reshape(1, -1)
        feats, self._infer_lstm_state = lstm_step(params["lstm"], x, self._infer_lstm_state)
        head = params["proposal"][address]
        out = mlp_apply(head["ff"], feats, activation=torch.relu, activation_last=None).cpu()
        prior = {k: v.reshape(1, -1) for k, v in prior_param_arrays(distribution).items()}
        return head_distribution(head["meta"], out, prior)

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

        def proposal_step(site, distribution, generator, observed, forced_value=None,
                          defensive=None):
            """Propose (or, given ``forced_value`` [n], score) the values of
            one site for the whole batch: returns ([n] values, [n] log q).
            ``defensive=π``: each lane draws from q with probability π, else
            from the prior, and is scored against the mixture π·q + (1−π)·p
            (rejection_sample retries)."""
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
            elif defensive is not None:
                xq = d.sample(generator)
                xp = _draw(distribution, n, generator)
                u = torch.rand((n,), generator=generator, dtype=util.dtype(), device=device)
                value = torch.where(u < defensive, xq, xp)
            else:
                value = d.sample(generator)
            plp = d.log_prob(value)
            if defensive is not None:
                plp = torch.logaddexp(
                    math.log(defensive) + plp,
                    math.log1p(-defensive) + distribution.log_prob(value),
                )
            state["prev"] = (addr, value, distribution.name)
            return value, plp

        def get_state():
            """The step's recurrent state: the ``[depth, n, H]`` LSTM (h, c)
            and the previous site's (address, [n] value, distribution name),
            or None before the first site."""
            return state["lstm"], state["prev"]

        def set_state(s):
            state["lstm"], state["prev"] = s

        def select_state(mask, new, old):
            """Per lane, ``new`` where ``mask`` [n] holds, else ``old``; the
            two must have met the same previous site."""
            (h1, c1), prev1 = new
            (h0, c0), prev0 = old
            if (prev1 is None) != (prev0 is None) or (
                prev1 is not None and (prev1[0], prev1[2]) != (prev0[0], prev0[2])
            ):
                raise RuntimeError("proposal state structure changed across rejection attempts")
            lanes = mask.reshape(1, -1, 1)
            lstm = (torch.where(lanes, h1, h0), torch.where(lanes, c1, c0))
            if prev1 is None:
                return lstm, None
            return lstm, (prev1[0], _select(mask, prev1[1], prev0[1]), prev1[2])

        proposal_step.reset = reset
        proposal_step.get_state = get_state
        proposal_step.set_state = set_state
        proposal_step.select_state = select_state
        proposal_step.supports_defensive = True
        return proposal_step
