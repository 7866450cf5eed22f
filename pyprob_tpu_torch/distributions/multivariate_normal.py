"""Multivariate normal distribution, event shape (k,) (counterpart of
``pyprob_tpu/distributions/multivariate_normal.py``).

Parameterized by ``loc`` and either a full ``covariance_matrix`` or its
lower-Cholesky factor ``scale_tril``; only the factor is stored (one
``cholesky`` at construction), so sampling is a matmul and ``log_prob`` a
triangular solve.  The factorization goes through ``ops.blocked_linalg``:
on the card at k ≥ 128 the panel Cholesky with its diagonal-tile kernel.
"""

from __future__ import annotations

import math

import torch

from .. import util
from ..ops import blocked_linalg
from .distribution import Distribution, _common_device

_LOG_2PI = math.log(2.0 * math.pi)


class MultivariateNormal(Distribution):
    _param_names = ("loc", "scale_tril")
    _param_event_dims = (1, 2)

    def __init__(self, loc, covariance_matrix=None, scale_tril=None):
        if (covariance_matrix is None) == (scale_tril is None):
            raise ValueError("Provide exactly one of covariance_matrix, scale_tril")
        device = _common_device(loc, covariance_matrix, scale_tril)
        self._loc = util.to_tensor(loc, device)
        if self._loc.dim() < 1:
            raise ValueError("MultivariateNormal loc must be at least 1-D")
        if scale_tril is not None:
            self._scale_tril = util.to_tensor(scale_tril, device)
        else:
            self._scale_tril = blocked_linalg.cholesky(util.to_tensor(covariance_matrix, device))
        self._finish_init()

    def _finish_init(self):
        k = self._loc.shape[-1]
        self._event_size = k
        batch_shape = torch.broadcast_shapes(self._loc.shape[:-1], self._scale_tril.shape[:-2])
        super().__init__(
            name="MultivariateNormal",
            address_suffix=f"MultivariateNormal(len:{k})",
            batch_shape=batch_shape,
        )

    @property
    def event_shape(self):
        return (self._event_size,)

    @property
    def loc(self):
        return self._loc

    @property
    def scale_tril(self):
        return self._scale_tril

    @property
    def covariance_matrix(self):
        L = self._scale_tril
        return torch.matmul(L, L.mT)

    def _sample(self, generator, shape):
        z = torch.randn(
            shape + self._batch_shape + (self._event_size,),
            generator=generator,
            dtype=self._loc.dtype,
            device=self._loc.device,
        )
        return self._loc + torch.matmul(self._scale_tril, z.unsqueeze(-1)).squeeze(-1)

    def log_prob(self, value, sum=False):
        x = util.to_tensor(value, self._loc.device)
        diff = x - self._loc
        # broadcast L against diff's batch dims before the triangular solve
        batch = torch.broadcast_shapes(diff.shape[:-1], self._scale_tril.shape[:-2])
        k = self._event_size
        L = self._scale_tril.expand(batch + (k, k))
        z = blocked_linalg.tri_solve_lower(L, diff.expand(batch + (k,)))
        half_log_det = torch.log(torch.diagonal(L, dim1=-2, dim2=-1)).sum(-1)
        lp = -0.5 * (z * z).sum(-1) - half_log_det - 0.5 * k * _LOG_2PI
        return lp.sum() if sum else lp

    @property
    def mean(self):
        return self._loc

    @property
    def variance(self):
        L = self._scale_tril
        return (L * L).sum(-1)
