"""LARC: layer-wise adaptive rate control for large-batch training
(counterpart of ``pyprob_tpu/nn/optimizer_larc.py``; arXiv:1708.03888).

Per parameter leaf (a "layer"):

    local_lr = trust_coefficient * ||p|| / (||g|| + weight_decay*||p|| + eps)
    clip mode:  g <- (g + weight_decay*p) * min(local_lr / lr, 1)
    scale mode: g <- (g + weight_decay*p) * local_lr

with the scale 1 where ``||p||`` or ``||g||`` is zero.  ``larc_scale``
computes it over a list of tensors; ``LARC`` wraps any ``torch.optim``
optimizer and scales its parameters' gradients in place before each
``step``, as pyprob's apex-derived wrapper does.  The weight decay lives
here: the wrapped optimizer is left without one, or it would be counted
twice.
"""

from __future__ import annotations

import torch


def larc_scale(grads, params, learning_rate, trust_coefficient=0.002, clip=True, eps=1e-8,
               weight_decay=0.0):
    """The LARC-scaled gradients of ``params`` (lists of tensors of equal
    shapes); a None gradient stays None."""
    out = []
    for g, p in zip(grads, params):
        if g is None:
            out.append(None)
            continue
        p_norm = torch.linalg.vector_norm(p.detach())
        g_norm = torch.linalg.vector_norm(g)
        adaptive_lr = trust_coefficient * p_norm / (g_norm + weight_decay * p_norm + eps)
        ok = (p_norm > 0) & (g_norm > 0)
        one = torch.ones_like(adaptive_lr)
        if clip:
            scale = torch.where(ok, torch.minimum(adaptive_lr / learning_rate, one), one)
        else:
            scale = torch.where(ok, adaptive_lr, one)
        out.append((g + weight_decay * p.detach()) * scale)
    return out


class LARC:
    """``LARC(optimizer)`` scales the gradients of ``optimizer``'s
    parameters by :func:`larc_scale` at each group's learning rate, in
    place, then steps ``optimizer``.  ``step``, ``zero_grad``,
    ``state_dict``, ``load_state_dict`` and ``param_groups`` are the
    wrapped optimizer's.  ``trust_coefficient`` defaults to pyprob's
    0.002 (the JAX package's wrapper has 0.02, its ``larc_scale`` 0.002)."""

    def __init__(self, optimizer, trust_coefficient=0.002, clip=True, eps=1e-8, weight_decay=0.0):
        if not any(len(g["params"]) for g in getattr(optimizer, "param_groups", [])):
            raise ValueError("LARC needs an optimizer with parameters to scale")
        self.optim = optimizer
        self.trust_coefficient = trust_coefficient
        self.clip = clip
        self.eps = eps
        self.weight_decay = weight_decay

    @property
    def param_groups(self):
        return self.optim.param_groups

    @property
    def state(self):
        return self.optim.state

    def state_dict(self):
        return self.optim.state_dict()

    def load_state_dict(self, state_dict):
        self.optim.load_state_dict(state_dict)

    def zero_grad(self, set_to_none=True):
        self.optim.zero_grad(set_to_none=set_to_none)

    @torch.no_grad()
    def scale_gradients(self):
        """Scale every parameter's ``.grad`` in place at its group's
        learning rate."""
        for group in self.optim.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            scaled = larc_scale(
                [p.grad for p in params], params, group["lr"], self.trust_coefficient, self.clip,
                self.eps, self.weight_decay,
            )
            for p, g in zip(params, scaled):
                p.grad.copy_(g)

    def step(self, closure=None):
        self.scale_gradients()
        return self.optim.step(closure)

    def __repr__(self):
        return f"LARC({self.optim!r}, trust_coefficient={self.trust_coefficient}, clip={self.clip})"
