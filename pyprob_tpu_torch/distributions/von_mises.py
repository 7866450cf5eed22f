"""Von Mises distribution (counterpart of ``pyprob_tpu/distributions/von_mises.py``).

Sampling is Best and Fisher's (1979) rejection algorithm, as the JAX
package's: rounds of three uniforms on (1e-7, 1 − 1e-7), each lane keeping
its first accepted proposal, for at most 32 rounds (the JAX package runs
all 32; here the rounds stop once every lane has accepted), the angle
wrapped to [−π, π) around ``loc``.  ``log_prob`` uses log I0(κ) =
log i0e(κ) + κ, which does not overflow.
"""

from __future__ import annotations

import math

import torch

from .. import util
from .distribution import Distribution, _broadcast_shapes, _tensors

_MAX_REJECTION_ROUNDS = 32  # P(all rejected) < 1e-12 for any concentration


class VonMises(Distribution):
    _param_names = ("loc", "concentration")

    def __init__(self, loc, concentration):
        self._loc, self._concentration = _tensors(loc, concentration)
        self._finish_init()

    def _finish_init(self):
        batch_shape = _broadcast_shapes(self._loc.shape, self._concentration.shape)
        super().__init__(name="VonMises", address_suffix="VonMises", batch_shape=batch_shape)

    @property
    def loc(self):
        return self._loc

    @property
    def concentration(self):
        return self._concentration

    def _sample(self, generator, shape):
        full = shape + self._batch_shape
        kappa = self._concentration.expand(full)
        b = 1.0 + torch.sqrt(1.0 + 4.0 * kappa**2)
        rho = (b - torch.sqrt(2.0 * b)) / (2.0 * kappa)
        r = (1.0 + rho**2) / (2.0 * rho)
        out = torch.zeros(full, dtype=kappa.dtype, device=kappa.device)
        accepted = torch.zeros(full, dtype=torch.bool, device=kappa.device)
        for _ in range(_MAX_REJECTION_ROUNDS):
            u = torch.rand((3,) + full, generator=generator, dtype=kappa.dtype, device=kappa.device)
            u = u * (1.0 - 2e-7) + 1e-7
            z = torch.cos(math.pi * u[0])
            f = (1.0 + r * z) / (r + z)
            c = kappa * (r - f)
            accept = ((c * (2.0 - c) - u[1]) > 0) | ((torch.log(c / u[1]) + 1.0 - c) >= 0)
            x = torch.sign(u[2] - 0.5) * torch.arccos(torch.clamp(f, -1.0, 1.0))
            out = torch.where(accepted | ~accept, out, x)
            accepted = accepted | accept
            if bool(accepted.all()):
                break
        return torch.remainder(out + self._loc + math.pi, 2.0 * math.pi) - math.pi

    def log_prob(self, value, sum=False):
        x = util.to_tensor(value, self._loc.device)
        kappa = self._concentration
        log_i0 = torch.log(torch.special.i0e(kappa)) + kappa
        lp = kappa * torch.cos(x - self._loc) - math.log(2.0 * math.pi) - log_i0
        return lp.sum() if sum else lp

    @property
    def mean(self):
        return self._loc

    @property
    def variance(self):
        k = self._concentration
        return 1.0 - torch.special.i1(k) / torch.special.i0(k)
