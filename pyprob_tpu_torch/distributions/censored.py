"""Censored observation wrapper, the Tobit likelihood (counterpart of
``pyprob_tpu/distributions/censored.py``).

It wraps a base distribution with a ``cdf``.  A value at or below
``lower`` scores log cdf(lower), the lower tail's mass; one at or above
``upper`` scores log1p(−cdf(upper)), the upper tail's; one between them the
base density.  The cdf is clamped to [ε, 1 − ε] at the float32 epsilon
first, so both tails stay finite.  The branches are ``torch.where``
selects, so a batch of values scores at once on the batched tier.  As a
latent site's prior it draws base draws clipped to the bounds.  Its
``name`` and ``address_suffix`` are ``Censored(<base>)``, as in the JAX
package; its leaves are its base's, then ``lower`` and ``upper``.
"""

from __future__ import annotations

import math

import torch

from .. import util
from .distribution import Distribution, _broadcast_shapes


class Censored(Distribution):
    _param_names = ("lower", "upper")

    def __init__(self, base, lower=None, upper=None):
        if lower is None and upper is None:
            raise ValueError("Censored needs at least one of lower, upper")
        if not isinstance(base, Distribution):
            raise TypeError("Censored wraps a Distribution")
        device = base.device
        self._base = base
        self._lower = util.to_tensor(-math.inf if lower is None else lower, device)
        self._upper = util.to_tensor(math.inf if upper is None else upper, device)
        self._finish_init()

    def _finish_init(self):
        super().__init__(
            name=f"Censored({self._base.name})",
            address_suffix=f"Censored({self._base.address_suffix})",
            batch_shape=_broadcast_shapes(self._base.batch_shape, self._lower.shape, self._upper.shape),
        )

    @property
    def base(self):
        return self._base

    @property
    def lower(self):
        return self._lower

    @property
    def upper(self):
        return self._upper

    def _leaves(self):
        return self._base._leaves() + [self._lower, self._upper]

    @property
    def _param_event_dims(self):
        dims = self._base._param_event_dims
        return None if dims is None else tuple(dims) + (0, 0)

    def _with_leaves(self, leaves):
        d = Censored.__new__(Censored)
        d._base = self._base._with_leaves(leaves[:-2])
        d._lower, d._upper = leaves[-2:]
        d._finish_init()
        return d

    def __repr__(self):
        return f"Censored(base={self._base!r}, lower={self._lower}, upper={self._upper})"

    def _sample(self, generator, shape):
        x = self._base._sample(generator, shape)
        return torch.minimum(torch.maximum(x, self._lower), self._upper)

    def log_prob(self, value, sum=False):
        x = util.to_tensor(value, self.device)
        interior = self._base.log_prob(x)
        eps = torch.finfo(util.dtype()).eps
        cdf_x = torch.clamp(self._base.cdf(x), eps, 1.0 - eps)
        lp = torch.where(x <= self._lower, torch.log(cdf_x), interior)
        lp = torch.where(x >= self._upper, torch.log1p(-cdf_x), lp)
        return lp.sum() if sum else lp

    def cdf(self, value):
        x = util.to_tensor(value, self.device)
        c = self._base.cdf(x)
        c = torch.where(x < self._lower, torch.zeros_like(c), c)
        return torch.where(x >= self._upper, torch.ones_like(c), c)
