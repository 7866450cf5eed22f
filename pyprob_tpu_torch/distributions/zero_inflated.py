"""Zero-inflated count wrapper, e.g. the zero-inflated Poisson (counterpart
of ``pyprob_tpu/distributions/zero_inflated.py``).

With probability ``gate`` the outcome is a structural zero, else a draw
of the base: p(0) = g + (1 − g)·p_base(0), p(k) = (1 − g)·p_base(k).  The
gate is clipped to [1e-12, 1 − 1e-12] in ``log_prob``, and the value 0
scores the log-sum-exp of log g and the nonzero term.  A draw takes its
own uniform for the gate beside the base's draw.  Its ``name`` and
``address_suffix`` are ``ZeroInflated(<base>)``, as in the JAX package;
its leaves are its base's, then ``gate``.
"""

from __future__ import annotations

import torch

from .. import util
from .distribution import Distribution, _broadcast_shapes


class ZeroInflated(Distribution):
    _param_names = ("gate",)

    def __init__(self, base, gate):
        if not isinstance(base, Distribution):
            raise TypeError("ZeroInflated wraps a Distribution")
        self._base = base
        self._gate = util.to_tensor(gate, base.device)
        self._finish_init()

    def _finish_init(self):
        super().__init__(
            name=f"ZeroInflated({self._base.name})",
            address_suffix=f"ZeroInflated({self._base.address_suffix})",
            batch_shape=_broadcast_shapes(self._base.batch_shape, self._gate.shape),
        )

    @property
    def base(self):
        return self._base

    @property
    def gate(self):
        return self._gate

    def _leaves(self):
        return self._base._leaves() + [self._gate]

    @property
    def _param_event_dims(self):
        dims = self._base._param_event_dims
        return None if dims is None else tuple(dims) + (0,)

    def _with_leaves(self, leaves):
        d = ZeroInflated.__new__(ZeroInflated)
        d._base = self._base._with_leaves(leaves[:-1])
        d._gate = leaves[-1]
        d._finish_init()
        return d

    def __repr__(self):
        return f"ZeroInflated(base={self._base!r}, gate={self._gate})"

    def _sample(self, generator, shape):
        x = self._base._sample(generator, shape)
        u = torch.rand(x.shape, generator=generator, dtype=x.dtype, device=x.device)
        return torch.where(u >= self._gate, x, torch.zeros_like(x))

    def log_prob(self, value, sum=False):
        x = util.to_tensor(value, self.device)
        g = torch.clamp(self._gate, 1e-12, 1.0 - 1e-12)
        lp_nonzero = torch.log(1.0 - g) + self._base.log_prob(x)
        lp_zero = torch.logaddexp(torch.log(g), lp_nonzero)
        lp = torch.where(x == 0, lp_zero, lp_nonzero)
        return lp.sum() if sum else lp

    @property
    def mean(self):
        return (1.0 - self._gate) * self._base.mean

    @property
    def variance(self):
        g = self._gate
        m = self._base.mean
        return (1.0 - g) * (self._base.variance + g * m * m)
