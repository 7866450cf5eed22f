"""LKJ distribution over Cholesky factors of correlation matrices, event
shape (d, d), and the CPC-chart proposal over them (counterpart of
``pyprob_tpu/distributions/lkj.py``).

``LKJCholesky(d, η)``: with W = L Lᵀ the implied correlation matrix has
density ∝ det(W)^(η−1).  Draws use the onion method (one Beta radius and
one direction on the sphere a row, d − 1 steps, no rejection).

``LKJCholeskyCPCNormal(loc, log_scale, d)``: independent Normals on the
d(d−1)/2 tanh canonical partial correlations, pushed through the chart
``_cpc_to_chol``; its density over L includes the chart's exact
log-Jacobian, so prior/proposal importance ratios are exact.  It is the
``lkj_cpc_normal`` proposal head's distribution.
"""

from __future__ import annotations

import math

import torch

from .. import util
from .beta import betaln
from .distribution import Distribution, _common_device

_LOG_PI = math.log(math.pi)
_LOG_2PI = math.log(2.0 * math.pi)


class LKJCholesky(Distribution):
    _param_names = ("concentration",)
    _aux_names = ("_dim",)

    def __init__(self, dim, concentration=1.0):
        self._dim = int(dim)
        if self._dim < 2:
            raise ValueError("LKJCholesky needs dim >= 2")
        self._concentration = util.to_tensor(concentration, _common_device(concentration))
        self._finish_init()

    def _finish_init(self):
        super().__init__(
            name="LKJCholesky",
            address_suffix=f"LKJCholesky(len:{self._dim})",
            batch_shape=tuple(self._concentration.shape),
        )

    @property
    def event_shape(self):
        return (self._dim, self._dim)

    @property
    def dim(self):
        return self._dim

    @property
    def concentration(self):
        return self._concentration

    def _sample(self, generator, shape):
        # onion method: row i in 1..d-1 has squared radius y ~ Beta(i/2,
        # η + (d-1-i)/2) and direction u uniform on the (i-1)-sphere
        d = self._dim
        out_shape = shape + self._batch_shape
        eta = self._concentration.expand(out_shape)
        like = dict(dtype=eta.dtype, device=eta.device)
        rows = [torch.cat([torch.ones(out_shape + (1,), **like), torch.zeros(out_shape + (d - 1,), **like)], -1)]
        for i in range(1, d):
            b = (eta + (d - 1.0 - i) / 2.0).contiguous()
            x = torch._standard_gamma(torch.full_like(b, i / 2.0), generator=generator)
            y = x / (x + torch._standard_gamma(b, generator=generator))
            u = torch.randn(out_shape + (i,), generator=generator, **like)
            u = u / torch.linalg.vector_norm(u, dim=-1, keepdim=True)
            head = torch.sqrt(y)[..., None] * u
            diag = torch.sqrt(1.0 - y)[..., None]
            rows.append(torch.cat([head, diag, torch.zeros(out_shape + (d - 1 - i,), **like)], -1))
        return torch.stack(rows, -2)

    def log_prob(self, value, sum=False):
        """Σ_i [2(b_i − 1) log L_ii − log B(i/2, b_i) − (i/2) log π +
        log Γ(i/2)], b_i the onion Beta parameters."""
        L = util.to_tensor(value, self._concentration.device)
        d = self._dim
        diag = torch.diagonal(L, dim1=-2, dim2=-1)
        i = torch.arange(1.0, d, dtype=L.dtype, device=L.device)
        eta = self._concentration[..., None] if self._batch_shape else self._concentration
        b_i = eta + (d - 1.0 - i) / 2.0
        log_diag = torch.log(torch.clamp(diag[..., 1:], min=1e-30))
        lp = (
            2.0 * (b_i - 1.0) * log_diag
            - betaln(i / 2.0, b_i)
            - (i / 2.0) * _LOG_PI
            + torch.lgamma(i / 2.0)
        ).sum(-1)
        return lp.sum() if sum else lp


def _cpc_to_chol(z, d):
    """The tanh canonical-partial-correlation chart, batched over leading
    dims: z [..., d(d−1)/2] -> (L [..., d, d], log|dL/dz| [...])."""
    batch = tuple(z.shape[:-1])
    like = dict(dtype=z.dtype, device=z.device)
    rows = [torch.cat([torch.ones(batch + (1,), **like), torch.zeros(batch + (d - 1,), **like)], -1)]
    logdet = torch.zeros(batch, **like)
    idx = 0
    for i in range(1, d):
        entries = []
        s = torch.zeros(batch, **like)
        for _ in range(i):
            w = torch.tanh(z[..., idx])
            rem = torch.clamp(1.0 - s, min=1e-30)
            entry = w * torch.sqrt(rem)
            logdet = logdet + 0.5 * torch.log(rem) + torch.log1p(-(w * w))
            s = s + entry * entry
            entries.append(entry)
            idx += 1
        diag = torch.sqrt(torch.clamp(1.0 - s, min=1e-30))
        rows.append(torch.stack(entries + [diag] + [torch.zeros_like(diag)] * (d - 1 - i), -1))
    return torch.stack(rows, -2), logdet


def _chol_to_cpc(L, d):
    """The inverse chart: L [..., d, d] -> z [..., d(d−1)/2]."""
    out = []
    for i in range(1, d):
        s = torch.zeros(L.shape[:-2], dtype=L.dtype, device=L.device)
        for j in range(i):
            rem = torch.clamp(1.0 - s, min=1e-30)
            w = torch.clamp(L[..., i, j] / torch.sqrt(rem), -1.0 + 1e-6, 1.0 - 1e-6)
            out.append(torch.atanh(w))
            s = s + L[..., i, j] * L[..., i, j]
    return torch.stack(out, -1)


class LKJCholeskyCPCNormal(Distribution):
    _param_names = ("loc", "log_scale")
    _param_event_dims = (1, 1)
    _aux_names = ("_dim",)

    def __init__(self, loc, log_scale, dim):
        device = _common_device(loc, log_scale)
        self._dim = int(dim)
        self._loc = util.to_tensor(loc, device)
        self._log_scale = util.to_tensor(log_scale, device)
        self._finish_init()

    def _finish_init(self):
        d = self._dim
        k = d * (d - 1) // 2
        if self._loc.shape[-1:] != (k,):
            raise ValueError(f"loc must have trailing dim d(d-1)/2 = {k}, got {tuple(self._loc.shape)}")
        super().__init__(
            name="LKJCholeskyCPCNormal",
            address_suffix=f"LKJCholesky(len:{d})",
            batch_shape=tuple(self._loc.shape[:-1]),
        )

    @property
    def event_shape(self):
        return (self._dim, self._dim)

    @property
    def dim(self):
        return self._dim

    @property
    def loc(self):
        return self._loc

    @property
    def log_scale(self):
        return self._log_scale

    def _sample(self, generator, shape):
        loc = self._loc
        eps = torch.randn(shape + tuple(loc.shape), generator=generator, dtype=loc.dtype, device=loc.device)
        L, _ = _cpc_to_chol(loc + torch.exp(self._log_scale) * eps, self._dim)
        return L

    def log_prob(self, value, sum=False):
        L = util.to_tensor(value, self._loc.device)
        z = _chol_to_cpc(L, self._dim)
        lp_z = (
            -0.5 * ((z - self._loc) / torch.exp(self._log_scale)) ** 2 - self._log_scale - 0.5 * _LOG_2PI
        ).sum(-1)
        _, logdet = _cpc_to_chol(z, self._dim)
        lp = lp_z - logdet
        return lp.sum() if sum else lp
