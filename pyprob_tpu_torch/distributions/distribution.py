"""Distribution base class (counterpart of
``pyprob_tpu/distributions/distribution.py``).

Parameters are float32 tensors on one device: that of a tensor argument,
else ``util.param_device()`` (the CPU inside an interpreter-tier trace,
else the entry points' device).  Sampling takes an explicit
``torch.Generator``; with none, the generator of the parameters' device
that ``pyprob_tpu_torch.seed`` installs is used.  On the batched tier a
distribution's parameters are scalars or ``[N]`` tensors over the particle
batch, and ``log_prob`` broadcasts.
"""

from __future__ import annotations

import torch

from .. import util


def _common_device(*values):
    for v in values:
        if isinstance(v, torch.Tensor):
            return v.device
    return util.param_device()


def _tensors(*values):
    """Float tensors of the parameters on one device (``_common_device``)."""
    device = _common_device(*values)
    return [util.to_tensor(v, device) for v in values]


def _clip_tiny(x):
    """``clip(x, 1e-38)`` as the JAX package computes it under XLA, which
    flushes float32 subnormals (1e-38 among them) to zero: 0 below the
    smallest normal float32."""
    return torch.where(x < torch.finfo(x.dtype).tiny, torch.zeros_like(x), x)


def _broadcast_shapes(*shapes):
    """``torch.broadcast_shapes``, with a fast path for equal shapes (the
    interpreter tier builds distributions of 0-d tensors at every site)."""
    first = tuple(shapes[0])
    if all(tuple(s) == first for s in shapes[1:]):
        return first
    return tuple(torch.broadcast_shapes(*shapes))


class Distribution:
    """Subclasses set ``_param_names`` and implement ``_finish_init``,
    ``_sample(generator, shape)`` and ``log_prob``."""

    _param_names: tuple = ()
    # per parameter, how many trailing dims are event dims (the rest are
    # batch dims); None means 0 for every parameter
    _param_event_dims = None
    # attributes that are not parameters but fix the distribution's shape
    # (LKJCholesky's dim), carried by ``_with_leaves``
    _aux_names: tuple = ()

    def __init__(self, name, address_suffix="", batch_shape=()):
        self._name = name
        self._address_suffix = address_suffix
        self._batch_shape = tuple(batch_shape)

    @property
    def name(self):
        return self._name

    @property
    def address_suffix(self):
        return self._address_suffix

    @property
    def batch_shape(self):
        return self._batch_shape

    @property
    def event_shape(self):
        return ()

    @property
    def device(self):
        return self._leaves()[0].device

    def sample(self, generator=None, sample_shape=()):
        if generator is None:
            generator = util.generator(self.device)
        return self._sample(generator, tuple(sample_shape))

    def _sample(self, generator, shape):
        raise NotImplementedError()

    def _rand(self, generator, shape, like):
        """U[0, 1) draws of ``shape`` + the batch shape, like ``like``."""
        return torch.rand(
            shape + self._batch_shape, generator=generator, dtype=like.dtype, device=like.device
        )

    def _randn(self, generator, shape, like):
        return torch.randn(
            shape + self._batch_shape, generator=generator, dtype=like.dtype, device=like.device
        )

    def _standard_gamma(self, generator, shape, concentration):
        """Gamma(concentration, 1) draws of ``shape`` + the batch shape."""
        return torch._standard_gamma(
            concentration.expand(shape + self._batch_shape).contiguous(), generator=generator
        )

    def log_prob(self, value, sum=False):
        raise NotImplementedError()

    def prob(self, value, sum=False):
        return torch.exp(self.log_prob(value, sum=sum))

    def cdf(self, value):
        raise NotImplementedError(f"cdf not implemented for {self._name}")

    def icdf(self, value):
        raise NotImplementedError(f"icdf not implemented for {self._name}")

    @property
    def mean(self):
        raise NotImplementedError(f"mean not implemented for {self._name}")

    @property
    def variance(self):
        raise NotImplementedError(f"variance not implemented for {self._name}")

    @property
    def stddev(self):
        return torch.sqrt(self.variance)

    def _leaves(self):
        return [getattr(self, "_" + n) for n in self._param_names]

    def _with_leaves(self, leaves):
        """A distribution of this class with ``leaves`` in place of
        ``_leaves()`` (used to rebuild per-trace distributions from batched
        leaves); the wrappers, whose leaves begin with their base
        distribution's, override it."""
        d = type(self).__new__(type(self))
        for n in self._aux_names:
            setattr(d, n, getattr(self, n))
        for n, leaf in zip(self._param_names, leaves):
            setattr(d, "_" + n, leaf)
        d._finish_init()
        return d

    def __repr__(self):
        ps = ", ".join(
            f"{n}={v}" for n, v in zip(self._param_names, self._leaves())
        )
        return f"{type(self).__name__}({ps})"
