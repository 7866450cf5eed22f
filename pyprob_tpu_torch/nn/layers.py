"""Functional neural layers over dicts of tensors.

Counterpart of ``pyprob_tpu/nn/layers.py`` (linear, MLP, LSTM, the
5-convolution CNNs): each layer
is a pair ``*_init(generator, ...) -> params`` and ``*_apply(params, x)``
over plain dicts, so a network's per-address layers are dict entries, as
in the JAX package.  Weights use PyTorch's layout (``[out, in]``, LSTM
``[4H, in]`` and ``[4H, H]`` with gates in the order i, f, g, o) and its
default initialisation, U(−1/√fan_in, 1/√fan_in).  The ``*_from_numpy``
functions take the JAX package's parameter dicts (weights ``[in, out]``,
``Static`` metadata already unwrapped) and own every transpose; the
``*_to_numpy`` functions give that layout back.  Matmuls stay with cuBLAS
and convolutions with cuDNN (``F.conv2d``/``conv3d``, VALID padding, as
the JAX package's ``lax.conv_general_dilated``), in full float32.
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


# ---------------------------------------------------------------------------
# CNNs (the 5-convolution observe embeddings)
# ---------------------------------------------------------------------------


def conv_init(generator, in_ch, out_ch, kernel_shape, device):
    """Weights ``[out, in, *kernel]`` (OIHW / OIDHW, the JAX package's layout
    too) and bias, U(−1/√fan_in, 1/√fan_in)."""
    fan_in = in_ch * int(np.prod(kernel_shape))
    bound = 1.0 / math.sqrt(fan_in)
    return {
        "w": _uniform(generator, (out_ch, in_ch) + tuple(kernel_shape), bound, device),
        "b": _uniform(generator, (out_ch,), bound, device),
    }


def conv_apply(params, x, ndim):
    """x: ``[B, C, *spatial]``; stride 1, VALID padding."""
    conv = F.conv2d if ndim == 2 else F.conv3d
    return conv(x, params["w"], params["b"])


def max_pool(x, ndim, window=2):
    pool = F.max_pool2d if ndim == 2 else F.max_pool3d
    return pool(x, window)


def _cnn_forward(params, x, ndim):
    convs = params["convs"]
    x = torch.relu(conv_apply(convs[0], x, ndim))
    x = torch.relu(conv_apply(convs[1], x, ndim))
    x = max_pool(x, ndim)
    for c in convs[2:]:
        x = torch.relu(conv_apply(c, x, ndim))
    x = max_pool(x, ndim)
    return x.reshape(x.shape[0], -1)


def _cnn_flat_dim(spatial):
    """The flattened size per channel after the five convolutions and two
    pools; raises where an input is too small to leave a pixel."""
    out = []
    for n in spatial:
        m = ((n - 4) // 2 - 6) // 2
        if n - 4 < 2 or (n - 4) // 2 - 6 < 2:
            raise ValueError(
                f"a 5-convolution embedding needs every spatial side >= 20, got {tuple(spatial)}"
            )
        out.append(m)
    return int(np.prod(out))


def _cnn_init(generator, input_shape, output_shape, device, ndim):
    input_shape = tuple(input_shape)
    if len(input_shape) == ndim:
        input_shape = (1,) + input_shape
    output_shape = (output_shape,) if isinstance(output_shape, int) else tuple(output_shape)
    out_dim = int(np.prod(output_shape))
    k = (3,) * ndim
    chans = [input_shape[0], 64, 64, 128, 128, 128]
    convs = [conv_init(generator, chans[i], chans[i + 1], k, device) for i in range(5)]
    cnn_dim = 128 * _cnn_flat_dim(input_shape[1:])
    return {
        "convs": convs,
        "lin1": linear_init(generator, cnn_dim, out_dim, device),
        "lin2": linear_init(generator, out_dim, out_dim, device),
        "meta": {"input_shape": input_shape, "out_shape": output_shape},
    }


def _cnn_apply(params, x, ndim):
    meta = params["meta"]
    B = x.shape[0]
    x = _cnn_forward(params, x.reshape((B,) + tuple(meta["input_shape"])), ndim)
    x = torch.relu(linear_apply(params["lin1"], x))
    x = torch.relu(linear_apply(params["lin2"], x))
    return x.reshape((B,) + tuple(meta["out_shape"]))


def cnn2d5c_init(generator, input_shape, output_shape, device):
    """Five 3×3 convolutions (64, 64, pool, 128, 128, 128, pool) and two
    linear layers, over ``[C, H, W]`` inputs (pyprob's EmbeddingCNN2D5C)."""
    return _cnn_init(generator, input_shape, output_shape, device, 2)


def cnn2d5c_apply(params, x):
    return _cnn_apply(params, x, 2)


def cnn3d5c_init(generator, input_shape, output_shape, device):
    """The 3×3×3 variant over ``[C, D, H, W]`` inputs (EmbeddingCNN3D5C)."""
    return _cnn_init(generator, input_shape, output_shape, device, 3)


def cnn3d5c_apply(params, x):
    return _cnn_apply(params, x, 3)


def cnn_from_numpy(p, device):
    """A CNN's parameters from the JAX package's (convolution weights carried
    as they are, linear weights transposed)."""
    meta = dict(p["meta"])
    meta["input_shape"] = tuple(meta["input_shape"])
    meta["out_shape"] = tuple(meta["out_shape"])
    return {
        "convs": [{"w": _tensor(c["w"], device), "b": _tensor(c["b"], device)} for c in p["convs"]],
        "lin1": linear_from_numpy(p["lin1"], device),
        "lin2": linear_from_numpy(p["lin2"], device),
        "meta": meta,
    }


def cnn_to_numpy(p):
    return {
        "convs": [{"w": _host(c["w"]), "b": _host(c["b"])} for c in p["convs"]],
        "lin1": linear_to_numpy(p["lin1"]),
        "lin2": linear_to_numpy(p["lin2"]),
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
