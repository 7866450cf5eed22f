"""Gather-table training loss for variable-structure models (counterpart of
``pyprob_tpu/nn/gather_loss.py``).

The per-type loss (``InferenceNetworkLSTM._make_loss_for``) runs one pass
per controlled-address sequence: a model with data-dependent trace shapes
(the while-loop Marsaglia model) brings many trace types to each batch,
and each would score its heads with its own kernel launches.  Here the
addresses become data instead:

* the per-address parameters are stacked into tables (heads and sample
  embeddings grouped by structure, the address and distribution-type
  embeddings as ``[N, A]`` / ``[N, D]`` tables);
* a batch of mixed trace types packs into ``[T, B]`` arrays of values,
  prior parameters and table indices at the batch's own T and B, in
  sub-batch column order (the observation rows too: a trace's values
  must meet its own observations);
* the LSTM runs over the ``[T, B]`` rectangle, and the head stage over the
  active (step, trace) cells only, gathered exactly: one gathered MLP for
  every head of the group and one call to the mixture's autograd
  Function (kernel 2 forward and kernel 2b backward on the card for the
  Uniform heads).

The tables are ``torch.stack`` of the per-address leaves, so the backward
returns each table's gradient to the leaves it was stacked from (the JAX
package's ``scatter_table_grads``), and the optimizer steps the
per-address parameters as after the per-type loss.  The JAX package's
pow2 buckets of T, B and the active count, and its padded rows, bound XLA
compiles and are not ported.  The value equals the per-type loss's and so
does every gradient, within float32 round-off; batches that are not
table-uniform (mixed head structures, observations of different widths)
and batches with an event-shaped head (MultivariateNormal, Dirichlet,
LKJCholesky sites, as in the JAX package) give None and take the per-type
loss.
"""

from __future__ import annotations

import numpy as np
import torch

from .layers import lstm_step, lstm_zero_state, mlp_input
from .proposals import head_distribution, prior_param_arrays


def _structure(tree):
    """A hashable structure of a parameter tree: its metadata and the
    shapes of its tensors."""
    if isinstance(tree, torch.Tensor):
        return tuple(tree.shape)
    if isinstance(tree, dict):
        return tuple((k, _structure(tree[k])) for k in sorted(tree))
    if isinstance(tree, (list, tuple)):
        return tuple(_structure(v) for v in tree)
    return tree


class GatherRegistry:
    """Index maps from the per-address parameter dicts to stacked tables.
    Structure only (no tensors): rebuilt when polymorph changes the layer
    set.  Heads and sample embeddings are grouped by structure: members of
    a group have the same math, so one gathered apply serves them all."""

    def __init__(self, params):
        self.head_groups, self.head_of = self._grouped(params["proposal"])
        self.semb_groups, self.semb_of = self._grouped(params["sample_embedding"])
        self.a_addrs = list(params["address_embedding"].keys())
        self.a_of = {a: i for i, a in enumerate(self.a_addrs)}
        self.d_names = list(params["dist_type_embedding"].keys())
        self.d_of = {n: i for i, n in enumerate(self.d_names)}

    @staticmethod
    def _grouped(param_dict):
        groups, of = {}, {}
        for addr, p in param_dict.items():
            g = groups.setdefault(_structure(p), [])
            of[addr] = (_structure(p), len(g))
            g.append(addr)
        return groups, of

    @staticmethod
    def version_of(params):
        return tuple(
            len(params[k])
            for k in ("proposal", "sample_embedding", "address_embedding", "dist_type_embedding")
        )


def _stack(trees):
    """Trees of one structure as one tree of stacked tensors (metadata from
    the first)."""
    first = trees[0]
    if isinstance(first, torch.Tensor):
        return torch.stack(trees)
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees]) for k in first}
    if isinstance(first, list):
        return [_stack([t[i] for t in trees]) for i in range(len(first))]
    return first


def stack_group(param_dict, addrs):
    return _stack([param_dict[a] for a in addrs])


def stack_tables(params, registry, head_gkey, semb_gkey):
    """The tables the loss gathers from, stacked from the current parameter
    leaves (differentiably) every step."""
    return {
        "observe": params["observe"],
        "observe_final": params["observe_final"],
        "lstm": params["lstm"],
        "heads": stack_group(params["proposal"], registry.head_groups[head_gkey]),
        "sembs": stack_group(params["sample_embedding"], registry.semb_groups[semb_gkey]),
        "aemb": torch.stack([params["address_embedding"][a] for a in registry.a_addrs]),
        "demb": torch.stack([params["dist_type_embedding"][n] for n in registry.d_names]),
    }


def gathered_mlp(table, idx, x, activation=torch.relu, activation_last=torch.relu):
    """``mlp_apply`` with per-row parameters: row i of ``x`` goes through
    the MLP stacked at ``idx[i]`` of ``table`` (a ``stack_group`` of MLPs)."""
    meta = table["meta"]
    x = mlp_input(meta, x)
    n = len(table["layers"])
    for i, layer in enumerate(table["layers"]):
        x = torch.bmm(layer["w"][idx], x.unsqueeze(-1)).squeeze(-1) + layer["b"][idx]
        act = activation_last if i == n - 1 else activation
        if act is not None:
            x = act(x)
    return x.reshape((-1,) + tuple(meta["out_shape"]))


def pack_batch(net, registry, batch):
    """Pack a materialized batch of mixed trace types into the loss's
    arrays on the network's device.  Returns (packed, head_gkey,
    semb_gkey, addresses present) or None when the batch is not
    table-uniform."""
    traces = getattr(batch, "traces", None)
    if not traces:
        return None
    head_key = net._head_key
    params = net._params
    T = max(t.length_controlled for t in traces)
    if T == 0:
        return None
    B = len(traces)
    # every array's columns follow the sub-batches (traces grouped by
    # type), and so must the observation rows: batch.traces is the
    # generation order, and a trace packed against another trace's
    # observations trains the marginal
    ordered = [tr for sub in batch.sub_batches for tr in sub]
    obs = {}
    for name in params["observe"].keys():
        rows = [np.asarray(tr.named_value(name), np.float32).reshape(-1) for tr in ordered]
        if len({r.shape for r in rows}) != 1:
            return None
        obs[name] = np.stack(rows)

    idx = np.zeros((4, T, B), np.int64)  # head, sample embedding, address, dist type
    mask = np.zeros((T, B), bool)
    values, prior, prior_keys = None, {}, None
    head_gkey = semb_gkey = None
    present = {}
    b = 0
    for sub in batch.sub_batches:
        example = sub[0].variables_controlled
        L, n = len(example), len(sub)
        if L == 0:
            return None
        cols = slice(b, b + n)
        for t, v in enumerate(example):
            ak = head_key(v.address)
            hk, sk = registry.head_of.get(ak), registry.semb_of.get(ak)
            ai, di = registry.a_of.get(ak), registry.d_of.get(v.distribution.name)
            if hk is None or sk is None or ai is None or di is None:
                return None  # an unknown address: the per-type loss raises
            if params["proposal"][ak]["meta"].get("event_dim") is not None:
                return None  # an event-shaped head: the per-type loss scores it
            if head_gkey is None:
                head_gkey, semb_gkey = hk[0], sk[0]
            elif hk[0] != head_gkey or sk[0] != semb_gkey:
                return None  # mixed table structures
            idx[:, t, cols] = np.array([hk[1], sk[1], ai, di])[:, None]
            present[ak] = None
        for t in range(L):
            variables = [tr.variables_controlled[t] for tr in sub]
            vals = np.stack([np.asarray(v.value, np.float32).reshape(-1) for v in variables])
            if values is None:
                values = np.zeros((T, B, vals.shape[1]), np.float32)
            elif vals.shape[1] != values.shape[2]:
                return None
            values[t, cols] = vals
            rows = [prior_param_arrays(v.distribution) for v in variables]
            keys = tuple(sorted(rows[0]))
            if prior_keys is None:
                prior_keys = keys
            elif keys != prior_keys:
                return None
            for k in keys:
                col = np.stack([np.asarray(r[k], np.float32).reshape(-1) for r in rows])
                if k not in prior:
                    prior[k] = np.zeros((T, B, col.shape[1]), np.float32)
                elif col.shape[1] != prior[k].shape[2]:
                    return None
                prior[k][t, cols] = col
        mask[:L, cols] = True
        # steps past a trace's end repeat its last step: the LSTM runs over
        # the whole rectangle, and its inputs there stay finite
        idx[:, L:, cols] = idx[:, L - 1 : L, cols]
        values[L:, cols] = values[L - 1, cols]
        for k in prior:
            prior[k][L:, cols] = prior[k][L - 1, cols]
        b += n

    device = net._device

    def dev(a):
        return torch.from_numpy(a).to(device)

    idx = dev(idx)
    packed = {
        "obs": {name: dev(a) for name, a in obs.items()},
        "norm": float(B),
        "values": dev(values),
        "prior": {k: dev(a) for k, a in prior.items()},
        "head_idx": idx[0],
        "semb_idx": idx[1],
        "a_idx": idx[2],
        "d_idx": idx[3],
        "active_idx": dev(np.flatnonzero(mask.reshape(-1))),
    }
    return packed, head_gkey, semb_gkey, list(present)


def make_gather_loss(embed_fn):
    """The table-driven loss: the per-type loss's math (observe embedding
    once a trace; the LSTM input at step t is [obs, prev sample emb, prev
    dist emb, prev address emb, dist emb, address emb], zeros for "prev"
    at t = 0; −Σ log q of the values, each −inf clipped to −1e38), divided
    by the batch's trace count, with every per-address parameter gathered
    from the tables by the packed indices."""

    def loss_fn(tables, packed):
        emb = embed_fn(tables, packed["obs"])  # [B, O]
        values = packed["values"]  # [T, B, Kv]
        T, B = values.shape[0], values.shape[1]
        flat_vals = values.reshape(T * B, -1)
        cur_a = tables["aemb"][packed["a_idx"]]  # [T, B, A]
        cur_d = tables["demb"][packed["d_idx"]]  # [T, B, D]
        semb = gathered_mlp(tables["sembs"], packed["semb_idx"].reshape(-1), flat_vals).reshape(T, B, -1)

        def prev(x):
            return torch.cat([torch.zeros_like(x[:1]), x[:-1]])

        lstm_in = torch.cat(
            [emb.expand(T, B, -1), prev(semb), prev(cur_d), prev(cur_a), cur_d, cur_a], dim=-1
        )
        state = lstm_zero_state(tables["lstm"], (B,), emb.device)
        outs = []
        for t in range(T):
            out, state = lstm_step(tables["lstm"], lstm_in[t], state)
            outs.append(out)
        feats = torch.stack(outs).reshape(T * B, -1)
        # the head stage on the active cells only
        ai = packed["active_idx"]
        heads = tables["heads"]
        out = gathered_mlp(
            heads["ff"], packed["head_idx"].reshape(-1)[ai], feats[ai], activation_last=None
        )
        prior = {k: v.reshape(T * B, -1)[ai] for k, v in packed["prior"].items()}
        d = head_distribution(heads["meta"], out, prior)
        lp = d.log_prob(flat_vals[ai].reshape(-1))
        lp = torch.clamp(lp, min=-1e38)  # -inf repair, as the per-type loss
        return -lp.sum() / packed["norm"]

    return loss_fn
