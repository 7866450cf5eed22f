"""Shared set-up of the parity tests between pyprob_tpu and pyprob_tpu_torch.

The Gaussian-unknown-mean body and its Marsaglia variants (the prior drawn
by the polar method inside ``rejection_sample``, and in a plain while loop
that branches on ``float`` of the sampled values) are defined once here
and both packages' models call them: an address embeds the source line of
its ``sample`` call and the function-name chain, so the two packages'
sites get equal addresses and carried proposal heads land on the right
address.  The ``rejection_sample`` body takes its ``sqrt`` and ``log``
from the caller.  ``port_trace`` rebuilds a JAX package trace in the
port's records, so both packages' losses can run on the same traces.
"""

import math

import numpy as np
import jax.numpy as jnp
import torch

import pyprob_tpu
import pyprob_tpu_torch
from pyprob_tpu.nn import InferenceNetworkFeedForward as JaxFF, InferenceNetworkLSTM as JaxLSTM
from pyprob_tpu.nn.layers import Static
from pyprob_tpu_torch.nn import InferenceNetworkFeedForward as TorchFF, InferenceNetworkLSTM as TorchLSTM

OBSERVE = {"obs0": 8.0, "obs1": 9.0}
POSTERIOR_MEAN, POSTERIOR_STDDEV = 7.25, math.sqrt(1.0 / 1.2)


def gum_body(pp):
    mu = pp.sample(pp.distributions.Normal(1.0, math.sqrt(5.0)))
    likelihood = pp.distributions.Normal(mu, math.sqrt(2.0))
    pp.observe(likelihood, name="obs0")
    pp.observe(likelihood, name="obs1")
    return mu


class JaxGUM(pyprob_tpu.Model):
    def forward(self):
        return gum_body(pyprob_tpu)


class TorchGUM(pyprob_tpu_torch.Model):
    def forward(self):
        return gum_body(pyprob_tpu_torch)


def marsaglia_body(pp, sqrt, log):
    uniform = pp.distributions.Uniform(-1.0, 1.0)

    def attempt():
        x = pp.sample(uniform)
        y = pp.sample(uniform)
        s = x * x + y * y
        return (x, s), s < 1.0

    x, s = pp.rejection_sample(attempt)
    mu = 1.0 + math.sqrt(5.0) * (x * sqrt(-2.0 * log(s) / s))
    likelihood = pp.distributions.Normal(mu, math.sqrt(2.0))
    pp.observe(likelihood, name="obs0")
    pp.observe(likelihood, name="obs1")
    return mu


class JaxMarsaglia(pyprob_tpu.Model):
    def forward(self):
        return marsaglia_body(pyprob_tpu, jnp.sqrt, jnp.log)


class TorchMarsaglia(pyprob_tpu_torch.Model):
    def forward(self):
        return marsaglia_body(pyprob_tpu_torch, torch.sqrt, torch.log)


def marsaglia_while_body(pp):
    uniform = pp.distributions.Uniform(-1.0, 1.0)
    while True:
        x = pp.sample(uniform)
        y = pp.sample(uniform)
        s = float(x) ** 2 + float(y) ** 2
        if s < 1:
            break
    mu = 1.0 + math.sqrt(5.0) * (float(x) * math.sqrt(-2.0 * math.log(s) / s))
    likelihood = pp.distributions.Normal(mu, math.sqrt(2.0))
    pp.observe(likelihood, name="obs0")
    pp.observe(likelihood, name="obs1")
    return mu


class JaxMarsagliaWhile(pyprob_tpu.Model):
    def forward(self):
        return marsaglia_while_body(pyprob_tpu)


class TorchMarsagliaWhile(pyprob_tpu_torch.Model):
    def forward(self):
        return marsaglia_while_body(pyprob_tpu_torch)


def _port_distribution(d):
    if d is None:
        return None
    D = pyprob_tpu_torch.distributions
    f = lambda a: torch.tensor(np.asarray(a), dtype=torch.float32)  # noqa: E731
    if type(d).__name__ == "Uniform":
        return D.Uniform(f(d.low), f(d.high))
    if type(d).__name__ == "Normal":
        return D.Normal(f(d.mean), f(d.stddev))
    raise TypeError(type(d).__name__)


def port_trace(jtrace):
    """A JAX package trace (pruned or whole) as the port's ``Trace``: the
    same addresses and values, Uniform and Normal distributions on the CPU."""
    from pyprob_tpu_torch.trace import Trace, Variable

    tr = Trace()
    for v in jtrace.variables:
        tr.add(Variable(
            distribution=_port_distribution(v.distribution),
            value=None if v.value is None else np.asarray(v.value, np.float32),
            address_base=v.address_base, address=v.address, instance=v.instance,
            control=v.control, name=v.name, observed=v.observed, tagged=v.tagged,
        ))
    tr.end(None, None)
    return tr


def unwrap_static(tree):
    if isinstance(tree, Static):
        return tree.value
    if isinstance(tree, dict):
        return {k: unwrap_static(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [unwrap_static(v) for v in tree]
    return np.asarray(tree) if hasattr(tree, "shape") else tree


def jax_network(model, lstm_dim=16, mixture_components=3, observe_dim=4, seed=7, vectorized=None):
    """An untrained pyprob_tpu LSTM network for ``model``: constructor plus
    layer pre-generation on two prior traces (``vectorized`` picks the
    tier that draws them)."""
    pyprob_tpu.seed(seed)
    net = JaxLSTM(
        model=model,
        observe_embeddings={"obs0": {"dim": observe_dim}, "obs1": {"dim": observe_dim}},
        lstm_dim=lstm_dim,
        proposal_mixture_components=mixture_components,
    )
    net._pre_generate_layers(model.prior(num_traces=2, vectorized=vectorized).get_values())
    return net


def carry(jnet, model):
    """The port's network with ``jnet``'s weights."""
    params = unwrap_static(jnet.snapshot_params()["params"])
    meta = {
        "head_meta": jnet._head_meta,
        "observe_meta": jnet._observe_meta,
        "observe_embedding_dim": jnet._observe_embedding_dim,
        "lstm_input_dim": jnet._lstm_input_dim,
        "local_observe_dim": jnet._local_observe_dim,
        "lstm_dim": jnet._lstm_dim,
        "lstm_depth": jnet._lstm_depth,
        "sample_embedding_dim": jnet._sample_embedding_dim,
        "address_embedding_dim": jnet._address_embedding_dim,
        "distribution_type_embedding_dim": jnet._distribution_type_embedding_dim,
        "proposal_mixture_components": jnet._proposal_mixture_components,
    }
    net = TorchLSTM.from_numpy(model, params, meta, device="cpu")
    model._inference_network = net
    return net


def jax_ff_network(model, mixture_components=3, observe_dim=4, seed=7, vectorized=None):
    """An untrained pyprob_tpu feedforward network for ``model``, its heads
    grown from two prior traces (``vectorized`` picks the tier that draws
    them)."""
    pyprob_tpu.seed(seed)
    net = JaxFF(
        model=model,
        observe_embeddings={"obs0": {"dim": observe_dim}, "obs1": {"dim": observe_dim}},
        proposal_mixture_components=mixture_components,
    )
    net._pre_generate_layers(model.prior(num_traces=2, vectorized=vectorized).get_values())
    return net


def carry_ff(jnet, model):
    """The port's feedforward network with ``jnet``'s weights."""
    params = unwrap_static(jnet.snapshot_params()["params"])
    meta = {
        "head_meta": jnet._head_meta,
        "observe_meta": jnet._observe_meta,
        "observe_embedding_dim": jnet._observe_embedding_dim,
        "proposal_mixture_components": jnet._proposal_mixture_components,
    }
    net = TorchFF.from_numpy(model, params, meta, device="cpu")
    model._inference_network = net
    return net
