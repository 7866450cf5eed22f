"""Functional neural layers over dicts of tensors.

Counterpart of ``pyprob_tpu/nn/layers.py`` (linear, MLP, LSTM): each layer
is a pair ``*_init(generator, ...) -> params`` and ``*_apply(params, x)``
over plain dicts, so a network's per-address layers are dict entries, as
in the JAX package.  Weights use PyTorch's layout (``[out, in]``, LSTM
``[4H, in]`` and ``[4H, H]`` with gates in the order i, f, g, o) and its
default initialisation, U(−1/√fan_in, 1/√fan_in).  The ``*_from_numpy``
functions take the JAX package's parameter dicts (weights ``[in, out]``,
``Static`` metadata already unwrapped) and own every transpose; the
``*_to_numpy`` functions give that layout back.  Matmuls stay with cuBLAS
in full float32.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from .. import util


def _uniform(generator, shape, bound, device):
    u = torch.rand(shape, generator=generator, dtype=util.dtype(), device=device)
    return u * (2.0 * bound) - bound


def _tensor(a, device):
    return torch.tensor(np.asarray(a), dtype=util.dtype(), device=device).contiguous()


def _host(t):
    return t.detach().to("cpu", copy=True).numpy()


def linear_init(generator, in_dim, out_dim, device):
    bound = 1.0 / math.sqrt(max(in_dim, 1))
    return {
        "w": _uniform(generator, (out_dim, in_dim), bound, device),
        "b": _uniform(generator, (out_dim,), bound, device),
    }


def linear_apply(params, x):
    return F.linear(x, params["w"], params["b"])


def linear_from_numpy(p, device):
    return {"w": _tensor(np.asarray(p["w"]).T, device), "b": _tensor(p["b"], device)}


def linear_to_numpy(p):
    return {"w": _host(p["w"]).T.copy(), "b": _host(p["b"])}


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------


def mlp_init(generator, input_shape, output_shape, device, num_layers=3, one_hot_dim=None):
    """An MLP over inputs of ``input_shape``; with ``one_hot_dim``, over
    category indices, each taken as its one-hot vector of that length
    (the sample embedding of a categorical site)."""
    input_shape = tuple(input_shape)
    output_shape = (output_shape,) if isinstance(output_shape, int) else tuple(output_shape)
    in_dim = int(np.prod(input_shape)) if len(input_shape) else 1
    out_dim = int(np.prod(output_shape))
    if one_hot_dim is not None:
        in_dim = one_hot_dim
    if num_layers < 1:
        raise ValueError("Expecting num_layers >= 1")
    dims = (
        [in_dim, out_dim]
        if num_layers == 1
        else [in_dim] + [int((in_dim + out_dim) / 2)] * (num_layers - 1) + [out_dim]
    )
    return {
        "layers": [
            linear_init(generator, dims[i], dims[i + 1], device)
            for i in range(len(dims) - 1)
        ],
        "meta": {"in_dim": in_dim, "out_shape": output_shape, "one_hot_dim": one_hot_dim},
    }


def mlp_input(meta, x):
    """An MLP's input rows ``[B, in_dim]``: ``x`` flattened to rows, or for
    a one-hot MLP each value truncated to an integer index and taken as its
    one-hot row (all zeros outside [0, one_hot_dim), as ``jax.nn.one_hot``)."""
    n = meta.get("one_hot_dim")
    if n is None:
        return x.reshape(-1, meta["in_dim"])
    idx = x.reshape(-1, 1).long()
    return (idx == torch.arange(n, device=x.device)).to(util.dtype())


def mlp_apply(params, x, activation=torch.relu, activation_last=torch.relu):
    meta = params["meta"]
    x = mlp_input(meta, x)
    n = len(params["layers"])
    for i, layer in enumerate(params["layers"]):
        x = linear_apply(layer, x)
        if i == n - 1:
            if activation_last is not None:
                x = activation_last(x)
        else:
            x = activation(x)
    return x.reshape((-1,) + tuple(meta["out_shape"]))


def mlp_from_numpy(p, device):
    meta = dict(p["meta"])
    meta["out_shape"] = tuple(meta["out_shape"])
    return {
        "layers": [linear_from_numpy(layer, device) for layer in p["layers"]],
        "meta": meta,
    }


def mlp_to_numpy(p):
    return {"layers": [linear_to_numpy(layer) for layer in p["layers"]], "meta": dict(p["meta"])}


# ---------------------------------------------------------------------------
# LSTM
# ---------------------------------------------------------------------------


def lstm_init(generator, input_dim, hidden_dim, device, depth=1):
    bound = 1.0 / math.sqrt(hidden_dim)
    layers = []
    for d in range(depth):
        in_d = input_dim if d == 0 else hidden_dim
        layers.append(
            {
                "w_ih": _uniform(generator, (4 * hidden_dim, in_d), bound, device),
                "w_hh": _uniform(generator, (4 * hidden_dim, hidden_dim), bound, device),
                "b_ih": _uniform(generator, (4 * hidden_dim,), bound, device),
                "b_hh": _uniform(generator, (4 * hidden_dim,), bound, device),
            }
        )
    return {"layers": layers, "meta": {"hidden_dim": hidden_dim, "depth": depth}}


def lstm_cell(layer, x, h, c):
    """One LSTM cell step; gates in torch order (i, f, g, o)."""
    gates = F.linear(x, layer["w_ih"], layer["b_ih"]) + F.linear(
        h, layer["w_hh"], layer["b_hh"]
    )
    i, f, g, o = gates.chunk(4, dim=-1)
    i = torch.sigmoid(i)
    f = torch.sigmoid(f)
    g = torch.tanh(g)
    o = torch.sigmoid(o)
    c_new = f * c + i * g
    h_new = o * torch.tanh(c_new)
    return h_new, c_new


def lstm_step(params, x, state):
    """One time step through all depth layers.  x: [B, I]; state: (h, c),
    each [depth, B, H]."""
    h_all, c_all = state
    hs, cs = [], []
    inp = x
    for d, layer in enumerate(params["layers"]):
        h_new, c_new = lstm_cell(layer, inp, h_all[d], c_all[d])
        hs.append(h_new)
        cs.append(c_new)
        inp = h_new
    return inp, (torch.stack(hs), torch.stack(cs))


def lstm_zero_state(params, batch_shape, device):
    meta = params["meta"]
    shape = (meta["depth"],) + tuple(batch_shape) + (meta["hidden_dim"],)
    z = torch.zeros(shape, dtype=util.dtype(), device=device)
    return (z, z.clone())


def lstm_from_numpy(p, device):
    return {
        "layers": [
            {
                "w_ih": _tensor(np.asarray(layer["w_ih"]).T, device),
                "w_hh": _tensor(np.asarray(layer["w_hh"]).T, device),
                "b_ih": _tensor(layer["b_ih"], device),
                "b_hh": _tensor(layer["b_hh"], device),
            }
            for layer in p["layers"]
        ],
        "meta": dict(p["meta"]),
    }


def lstm_to_numpy(p):
    return {
        "layers": [
            {
                "w_ih": _host(layer["w_ih"]).T.copy(),
                "w_hh": _host(layer["w_hh"]).T.copy(),
                "b_ih": _host(layer["b_ih"]),
                "b_hh": _host(layer["b_hh"]),
            }
            for layer in p["layers"]
        ],
        "meta": dict(p["meta"]),
    }


def map_tensors(tree, fn):
    """Apply ``fn`` to every tensor leaf of a nested dict/list."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: map_tensors(v, fn) for k, v in tree.items()}
    if isinstance(tree, list):
        return [map_tensors(v, fn) for v in tree]
    return tree


def tensor_leaves(tree):
    """The tensor leaves of a nested dict/list, in a fixed order (dict keys
    sorted, as the JAX package flattens its pytrees)."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in tensor_leaves(tree[k])]
    if isinstance(tree, list):
        return [t for v in tree for t in tensor_leaves(v)]
    return []
