"""Dirichlet distribution, event shape (k,) (counterpart of
``pyprob_tpu/distributions/dirichlet.py``).

Values carry a trailing simplex dimension and ``log_prob`` reduces over
it.  Draws are taken in log space, as ``jax.random.dirichlet`` takes them:
log Γ(α) = log Γ(α + 1) + log(U)/α, then a softmax over the components.
Gamma draws made directly underflow to 0 in float32 at α near 1e-4 (the
proposal head's α can fall that low), in every component of a row at
once, and normalising such a row gives 0/0; in log space a row always
sums to 1.  A single component can still underflow to 0 after the
softmax, and ``log_prob`` scores that value as the JAX package does
(``xlogy``: +inf where α < 1).
"""

from __future__ import annotations

import torch

from .. import util
from .distribution import Distribution, _common_device


class Dirichlet(Distribution):
    _param_names = ("concentration",)
    _param_event_dims = (1,)

    def __init__(self, concentration):
        self._concentration = util.to_tensor(concentration, _common_device(concentration))
        if self._concentration.dim() < 1:
            raise ValueError("Dirichlet concentration must be at least 1-D")
        self._finish_init()

    def _finish_init(self):
        shape = tuple(self._concentration.shape)
        self._event_size = int(shape[-1])
        super().__init__(
            name="Dirichlet",
            address_suffix=f"Dirichlet(len:{self._event_size})",
            batch_shape=shape[:-1],
        )

    @property
    def event_shape(self):
        return (self._event_size,)

    @property
    def concentration(self):
        return self._concentration

    def _sample(self, generator, shape):
        a = self._concentration.expand(shape + self._batch_shape + (self._event_size,)).contiguous()
        log_gamma = torch.log(torch._standard_gamma(a + 1.0, generator=generator))
        # U in (0, 1]: log U finite
        u = 1.0 - torch.rand(a.shape, generator=generator, dtype=a.dtype, device=a.device)
        return torch.softmax(log_gamma + torch.log(u) / a, dim=-1)

    def log_prob(self, value, sum=False):
        x = util.to_tensor(value, self._concentration.device)
        a = self._concentration
        lp = (
            torch.xlogy(a - 1.0, x).sum(-1)
            + torch.lgamma(a.sum(-1))
            - torch.lgamma(a).sum(-1)
        )
        return lp.sum() if sum else lp

    @property
    def mean(self):
        a = self._concentration
        return a / a.sum(-1, keepdim=True)

    @property
    def variance(self):
        a = self._concentration
        a0 = a.sum(-1, keepdim=True)
        m = a / a0
        return m * (1.0 - m) / (a0 + 1.0)
