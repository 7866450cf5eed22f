"""Empirical: weighted sample container, the posterior result type.

Counterpart of ``pyprob_tpu/distributions/empirical.py`` in memory mode.
An Empirical is built once from its values and log-weights.  Weight math
is float64 on the host.  Array-valued results are kept as one numpy
array, and the weighted moments are single vectorised float64 sums over it
(the JAX package loops over the values in Python).  Adding values, the
file modes, concatenation and the transforms are not ported yet.
"""

from __future__ import annotations

import math

import numpy as np

from .. import util
from .distribution import Distribution


class Empirical(Distribution):
    def __init__(self, values=None, log_weights=None, name="Empirical",
                 effective_sample_size=None):
        super().__init__(name=name, address_suffix="Empirical", batch_shape=())
        values = [] if values is None else values
        if log_weights is None:
            lw = np.zeros(len(values), dtype=np.float64)
        else:
            lw = np.asarray(log_weights, dtype=np.float64).reshape(-1)
        if len(lw) != len(values):
            raise ValueError("values and weights must have equal length")
        lw = np.nan_to_num(lw, nan=-np.inf)
        self._values = values
        self._log_weights = lw
        self._metadata = []
        self._mean_cache = None
        self._variance_cache = None
        m = lw.max() if lw.size else -np.inf
        if not lw.size:
            self._probs = lw
        elif np.isinf(m) and m < 0:
            self._probs = np.full_like(lw, 1.0 / lw.size)
        else:
            self._probs = np.exp(lw - (m + math.log(np.exp(lw - m).sum())))
        if effective_sample_size is None:
            effective_sample_size = util.effective_sample_size(lw)
        self._ess = float(effective_sample_size)

    @classmethod
    def from_arrays(cls, values, log_weights=None, name="Empirical",
                    effective_sample_size=None):
        """Bulk construction from arrays.  ``effective_sample_size``, when
        given, is the ESS already computed from these weights (the batched
        tier takes it from the device-side log-weight statistics)."""
        return cls(
            np.asarray(values), log_weights, name=name,
            effective_sample_size=effective_sample_size,
        )

    @property
    def length(self):
        return len(self._values)

    def __len__(self):
        return len(self._values)

    def rename(self, name):
        self._name = name
        return self

    def add_metadata(self, **kwargs):
        self._metadata.append(dict(kwargs))

    @property
    def metadata(self):
        return self._metadata

    def get_values(self):
        return list(self._values)

    @property
    def log_weights(self):
        return self._log_weights

    @property
    def weights(self):
        return self._probs

    @property
    def effective_sample_size(self):
        return self._ess

    def expectation(self, func):
        total = None
        for v, p in zip(self._values, self._probs):
            term = np.asarray(func(v), dtype=np.float64) * p
            total = term if total is None else total + term
        return total

    @property
    def mean(self):
        if self._mean_cache is None:
            if isinstance(self._values, np.ndarray):
                self._mean_cache = np.tensordot(
                    self._probs, self._values.astype(np.float64), axes=1
                )
            else:
                self._mean_cache = self.expectation(
                    lambda v: np.asarray(v, dtype=np.float64)
                )
        return self._mean_cache

    @property
    def variance(self):
        if self._variance_cache is None:
            m = self.mean
            if isinstance(self._values, np.ndarray):
                d = self._values.astype(np.float64) - m
                self._variance_cache = np.tensordot(self._probs, d * d, axes=1)
            else:
                self._variance_cache = self.expectation(
                    lambda v: (np.asarray(v, dtype=np.float64) - m) ** 2
                )
        return self._variance_cache

    @property
    def stddev(self):
        return np.sqrt(self.variance)

    def __repr__(self):
        return f"Empirical(name:{self._name}, length:{self.length:,})"
