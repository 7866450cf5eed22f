"""Feedforward inference network: per-address proposal heads fed directly
by the observe embedding (counterpart of
``pyprob_tpu/nn/inference_network_feedforward.py``).

A head's proposal depends only on the observe embedding and the site's
prior parameters, so the network has no recurrent state.  The training
loss (``_make_loss_for``) applies, per controlled site of a trace type,
one head to the batch's observe embeddings and scores the batch's values
under its proposal: kernel 1 forward and kernel 1b backward on the card for
Normal heads, kernels 2 and 2b for the truncated-Normal heads (Uniform,
Beta, VonMises and Poisson priors); the event-shaped heads' values are
``[B, D]`` or ``[B, d, d]``.  A materialized batch of
several trace types takes one such loss per type (the gather-table loss
is the LSTM's).  On the batched tier the proposal step applies a head once
per site to the run's one observe-embedding row and expands its output
over the ``[N]`` particles; its state hooks are trivial, so the retries of
a ``rejection_sample`` block propose from the network (the defensive
mixture π·q + (1−π)·prior).  On the interpreter tier ``_infer_step``
applies the head on the network's device, copies its output to the host
once, and returns the proposal with CPU parameters.
"""

from __future__ import annotations

import math
import warnings

import torch

from .. import util
from ..vectorized import _draw
from .inference_network import InferenceNetwork
from .layers import mlp_apply
from .proposals import (
    event_dim_for,
    head_apply,
    head_distribution,
    head_from_numpy,
    head_init,
    head_kind_for,
    head_to_numpy,
    prior_param_arrays,
)


class InferenceNetworkFeedForward(InferenceNetwork):
    def __init__(self, proposal_mixture_components=10, *args, **kwargs):
        super().__init__(network_type="InferenceNetworkFeedForward", *args, **kwargs)
        self._params["proposal"] = {}
        self._head_meta = {}  # address -> {"kind", "num_categories"}
        self._proposal_mixture_components = proposal_mixture_components

    def _subclass_state(self):
        return {
            "head_meta": self._head_meta,
            "proposal_mixture_components": self._proposal_mixture_components,
        }

    def _load_subclass_state(self, state):
        self._head_meta = state["head_meta"]
        self._proposal_mixture_components = state["proposal_mixture_components"]

    def _init_layers(self):
        pass

    def _polymorph(self, batch):
        """Grow a head for each new controlled address of each sub-batch's
        example trace."""
        g, device = self._generator(), self._device
        layers_changed = False
        for sub_batch in batch.sub_batches:
            for variable in sub_batch[0].variables_controlled:
                address = self._head_key(variable.address)
                if address in self._params["proposal"]:
                    continue
                distribution = variable.distribution
                kind = head_kind_for(distribution)
                if kind is None:
                    raise RuntimeError(f"Distribution currently unsupported: {distribution.name}")
                num_categories = distribution.num_categories if kind == "categorical" else None
                self._params["proposal"][address] = head_init(
                    g, kind, self._observe_embedding_dim, device,
                    mixture_components=self._proposal_mixture_components,
                    num_categories=num_categories, event_dim=event_dim_for(distribution),
                )
                self._head_meta[address] = {"kind": kind, "num_categories": num_categories}
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

        ``params``: ``net.snapshot_params()["params"]`` of a ``pyprob_tpu``
        ``InferenceNetworkFeedForward``, with every ``Static`` leaf replaced
        by its ``.value``.  ``meta``: ``head_meta``, ``observe_meta``,
        ``observe_embedding_dim`` and ``proposal_mixture_components``.
        Linear weights ``[in, out]`` are transposed to PyTorch's layout
        here."""
        net = cls(
            model=model,
            proposal_mixture_components=meta["proposal_mixture_components"],
            device=device,
        )
        net._params.update(net._params_from_numpy(params))
        net._set_meta_from_numpy(meta)
        return net

    def _params_from_numpy(self, params):
        out = self._observe_params_from_numpy(params)
        out["proposal"] = {a: head_from_numpy(p, self._device) for a, p in params["proposal"].items()}
        return out

    def to_numpy(self, params=None):
        """``params`` (default: the network's own; also a tree of their
        gradients) in the JAX package's layout as numpy arrays."""
        p = self._params if params is None else params
        out = self._observe_params_to_numpy(p)
        out["proposal"] = {a: head_to_numpy(h) for a, h in p["proposal"].items()}
        return out

    # ------------------------------------------------------------------
    # training loss
    # ------------------------------------------------------------------
    def _loss_params_subset(self, addrs, dist_names):
        """Only the keys the feedforward loss reads."""
        p = self._params
        return {
            "observe": p["observe"],
            "observe_final": p["observe_final"],
            "proposal": {k: p["proposal"][k] for k in {self._head_key(a) for a in addrs}},
        }

    def _make_loss_for(self, addrs, dist_names):
        keys = tuple(self._head_key(a) for a in addrs)
        for addr in keys:
            if addr not in self._params["proposal"]:
                raise RuntimeError(f"Address unknown by inference network: {addr}")
        embed = self._embed_observe_pure

        def loss_fn(params, packed):
            emb = embed(params, packed["obs"])  # [B, O]
            total = torch.zeros((), dtype=util.dtype(), device=emb.device)
            for t, addr in enumerate(keys):
                step = packed["steps"][t]
                d = head_apply(params["proposal"][addr], emb, step["prior"])
                lp = torch.clamp(d.log_prob(step["values"]), min=-1e38)  # -inf repair
                total = total - lp.sum()
            return total

        return ("ff", tuple(addrs)), loss_fn

    # ------------------------------------------------------------------
    # stepwise inference, interpreter tier
    # ------------------------------------------------------------------
    @torch.no_grad()
    def _infer_step(self, variable, prev_variable=None, proposal_min_train_iterations=None):
        """The proposal of ``variable``'s site with CPU parameters; the
        prior itself where the network has no proposal for the site."""
        address = self._head_key(variable.address)
        distribution = variable.distribution
        if address not in self._params["proposal"]:
            warnings.warn(f"Using prior. No proposal for address: {address}")
            return distribution
        if (
            proposal_min_train_iterations is not None
            and self._head_train_iterations.get(address, 0) < proposal_min_train_iterations
        ):
            warnings.warn(f"Using prior. Proposal not sufficiently trained for address: {address}")
            return distribution
        head = self._serving_params()["proposal"][address]
        out = mlp_apply(
            head["ff"], self._infer_observe_embedding, activation=torch.relu, activation_last=None
        ).cpu()
        prior = {k: v.reshape(1, -1) for k, v in prior_param_arrays(distribution).items()}
        return head_distribution(head["meta"], out, prior)

    # ------------------------------------------------------------------
    # batched guided inference
    # ------------------------------------------------------------------
    def make_vectorized_proposal_step(self, observe=None):
        params = self._serving_params()
        head_meta = self._head_meta
        head_key = self._head_key
        embed = self._embed_observe_pure
        device = self._device
        state = {}

        def reset(num_particles):
            state["n"] = num_particles
            state["emb"] = None

        def _emb(observed):
            # the observe embedding is the same for every particle: one row
            # per run
            if state["emb"] is None:
                obs = {
                    name: util.to_tensor(observed[name], device).reshape(1, -1)
                    for name in params["observe"].keys()
                }
                state["emb"] = embed(params, obs)
            return state["emb"]

        def proposal_step(site, distribution, generator, observed, forced_value=None,
                          defensive=None):
            """Propose (or, given ``forced_value`` [n, *event], score) the
            values of one site for the whole batch: returns ([n, *event]
            values, [n] log q).
            The head runs once on the observe embedding's row and its output
            is expanded over the batch (the prior's parameters may differ
            per particle).  ``defensive=π``: each lane draws from q with
            probability π, else from the prior, and is scored against the
            mixture π·q + (1−π)·p (rejection_sample retries)."""
            n = state["n"]
            addr = head_key(site.address)
            if addr not in head_meta:
                value = forced_value if forced_value is not None else _draw(distribution, n, generator)
                return value, distribution.log_prob(value).expand(n)
            head = params["proposal"][addr]
            out = mlp_apply(head["ff"], _emb(observed), activation=torch.relu, activation_last=None)
            prior = {k: util.to_tensor(v, device) for k, v in prior_param_arrays(distribution).items()}
            d = head_distribution(head["meta"], out.expand(n, -1), prior)
            ev = tuple(distribution.event_shape)
            if forced_value is not None:
                value = util.to_tensor(forced_value, device).reshape((n,) + ev)
            elif defensive is not None:
                xq = d.sample(generator)
                xp = _draw(distribution, n, generator)
                u = torch.rand((n,) + (1,) * len(ev), generator=generator, dtype=util.dtype(), device=device)
                value = torch.where(u < defensive, xq, xp)
            else:
                value = d.sample(generator)
            plp = d.log_prob(value)
            if defensive is not None:
                plp = torch.logaddexp(
                    math.log(defensive) + plp,
                    math.log1p(-defensive) + distribution.log_prob(value),
                )
            return value, plp

        # stateless per site (the observe embedding is a per-run constant):
        # trivial state hooks let rejection_sample retries propose from the
        # network with nothing to restore or select per lane
        proposal_step.reset = reset
        proposal_step.get_state = lambda: None
        proposal_step.set_state = lambda s: None
        proposal_step.select_state = lambda mask, new, old: new
        proposal_step.supports_defensive = True
        return proposal_step
