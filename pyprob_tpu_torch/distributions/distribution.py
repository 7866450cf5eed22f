"""Distribution base class (counterpart of
``pyprob_tpu/distributions/distribution.py``).

Parameters are float32 tensors on one device.  Sampling takes an explicit
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
    return util.device()


class Distribution:
    """Subclasses set ``_param_names`` and implement ``_finish_init``,
    ``_sample(generator, shape)`` and ``log_prob``."""

    _param_names: tuple = ()
    # per parameter, how many trailing dims are event dims (the rest are
    # batch dims); None means 0 for every parameter
    _param_event_dims = None

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

    def log_prob(self, value, sum=False):
        raise NotImplementedError()

    def prob(self, value, sum=False):
        return torch.exp(self.log_prob(value, sum=sum))

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

    @classmethod
    def _rebuild(cls, leaves):
        """A distribution of this class with the given parameter tensors
        (used to rebuild per-trace distributions from batched leaves)."""
        d = cls.__new__(cls)
        for n, leaf in zip(cls._param_names, leaves):
            setattr(d, "_" + n, leaf)
        d._finish_init()
        return d

    def __repr__(self):
        ps = ", ".join(
            f"{n}={v}" for n, v in zip(self._param_names, self._leaves())
        )
        return f"{type(self).__name__}({ps})"
