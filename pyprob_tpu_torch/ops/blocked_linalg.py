"""Panel Cholesky of batched SPD matrices, and the Cholesky / triangular-solve
dispatch of the MultivariateNormal.

Counterpart of ``pyprob_tpu/ops/blocked_linalg.py`` (its iterative panel
path, ``chol_panels`` … ``blocked_cholesky``; ``chol_panels`` writes each
panel into one output L, so ``assemble_panels`` has no counterpart) and of
the dispatch in
``pyprob_tpu/backend.py`` (``cholesky``, ``tri_solve_lower``).  The panel
path is the right-looking blocked algorithm with panel width 64: per panel
the diagonal tile is factored together with its inverse by the
``chol_inv_tile`` kernel (``ops/tile_chol.py``), the panel solve is one
batched GEMM against that inverse, and the trailing update is one rank-64
batched GEMM (``torch.baddbmm``, ``S22 − L21 L21ᵀ`` with the subtraction
in the GEMM's epilogue, which saves one ``[B, m, m]`` temporary), all in
full float32 (TF32 is off, ``util``), as the JAX package runs them at
``Precision.HIGHEST``.

Dispatch: on ``cuda`` at N ≥ 128 ``cholesky`` takes the panel path; else
``torch.linalg.cholesky_ex`` with the lower triangle of a
non-positive-definite matrix's factor set to NaN, which is what
``jnp.linalg.cholesky`` returns (``torch.linalg.cholesky`` would raise, and
sync with the host to find out).  ``tri_solve_lower`` is
``torch.linalg.solve_triangular`` on every device and size: the JAX
package's ``solve_lower_vec`` is stock XLA, not a kernel, so the port uses
the library call.  Not ported: the recursive ``chol_inv_lower``, the
``PYPROB_TPU_BLOCKED_CHOL`` / ``PYPROB_TPU_TILE_KERNEL`` opt-outs and
``_panel_for``'s P = 128 branch (TPU tuning), and
``mvn_quad_logdet_panels`` (the port's ``mvn_quad_logdet`` is one fused
kernel, ``ops/mvn_logpdf.py``).
"""

from __future__ import annotations

import math

import torch

from .tile_chol import chol_inv_tile

_PANEL = 64
_PANEL_MIN_N = 128  # smallest event size the panel path takes on the card


def chol_panels(a, panel=_PANEL):
    """Panel factorization of batched SPD ``a`` [..., N, N].

    Returns ``(L, minvs)``: the lower Cholesky factor [..., N, N], each
    panel's columns written straight into it (column block k from the
    diagonal down is the JAX package's ``strips[k]``, so there is no strip
    list to assemble), and ``minvs[k]``, the inverse of the k-th
    [≤P, ≤P] diagonal tile."""
    n = a.shape[-1]
    batch = a.shape[:-2]
    S = a.reshape((-1, n, n))
    L = torch.empty_like(S)
    minvs = []
    for k0 in range(0, n, panel):
        p = min(panel, n - k0)
        k1 = k0 + p
        lkk, mkk = chol_inv_tile(S[:, :p, :p].contiguous())
        L[:, k0:k1, k0:k1] = lkk
        L[:, k0:k1, k1:] = 0
        if k1 < n:
            l21 = torch.matmul(S[:, p:, :p], mkk.mT)
            L[:, k1:, k0:k1] = l21
            S = torch.baddbmm(S[:, p:, p:], l21, l21.mT, alpha=-1.0)
        minvs.append(mkk.reshape(batch + (p, p)))
    return L.reshape(a.shape), minvs


def panel_cholesky(a, panel=_PANEL):
    """Lower Cholesky factor of batched SPD ``a`` by the panel path."""
    return chol_panels(a, panel)[0]


def blocked_cholesky(a):
    """Lower Cholesky factor of batched SPD ``a`` [..., N, N] (the JAX
    package's name for the panel path)."""
    return panel_cholesky(a)


def _use_panels(a):
    return a.is_cuda and a.dim() >= 2 and a.shape[-1] >= _PANEL_MIN_N


def cholesky_nan(a):
    """``torch.linalg.cholesky_ex`` with the lower triangle of a
    non-positive-definite matrix's factor set to NaN, as
    ``jnp.linalg.cholesky`` returns it."""
    L, info = torch.linalg.cholesky_ex(a)
    n = a.shape[-1]
    lower = torch.ones((n, n), dtype=torch.bool, device=a.device).tril()
    return L.masked_fill((info != 0)[..., None, None] & lower, math.nan)


def cholesky(a):
    """Lower Cholesky factor of ``a`` [..., N, N]; NaN where ``a`` is not
    positive definite."""
    if _use_panels(a):
        return panel_cholesky(a)
    return cholesky_nan(a)


def tri_solve_lower(L, b):
    """Solve ``L z = b`` for lower-triangular ``L`` [..., N, N] and one
    right-hand side ``b`` [..., N]."""
    return torch.linalg.solve_triangular(L, b.unsqueeze(-1), upper=False).squeeze(-1)
