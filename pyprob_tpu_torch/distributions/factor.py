"""Factor pseudo-distribution for soft conditioning (counterpart of
``pyprob_tpu/distributions/factor.py``).

It carries a fixed log-probability, or a callable that scores a value;
``pyprob_tpu_torch.factor`` observes one.  It has no parameter tensors, so
a materialized trace of the batched tier holds no distribution at a
factor site (as at a mixture's).
"""

from __future__ import annotations

import torch

from .. import util
from .distribution import Distribution, _common_device


class Factor(Distribution):
    _param_names = ()

    def __init__(self, log_prob=None, log_prob_func=None):
        if (log_prob is None) == (log_prob_func is None):
            raise ValueError("Provide exactly one of log_prob, log_prob_func")
        self._log_prob_value = log_prob
        self._log_prob_func = log_prob_func
        super().__init__(name="Factor", address_suffix="Factor", batch_shape=())

    @property
    def device(self):
        return _common_device(self._log_prob_value)

    def sample(self, generator=None, sample_shape=()):
        return torch.zeros((), dtype=util.dtype(), device=self.device)

    def log_prob(self, value=None, sum=False):
        if self._log_prob_func is not None:
            return self._log_prob_func(value)
        return util.to_tensor(self._log_prob_value, self.device)

    @property
    def mean(self):
        raise NotImplementedError("Factor has no mean")

    @property
    def variance(self):
        raise NotImplementedError("Factor has no variance")