"""Fused multivariate-normal quadratic form and half log-determinant.

Counterpart of ``pyprob_tpu/ops/mvn_logpdf.py``: ``mvn_quad_logdet(cov,
diff)`` returns ``(diffᵀ K⁻¹ diff, ½ log|K|)`` per matrix, the GP family's
log marginal likelihood up to ``−½ quad − half_logdet − ½ N log 2π``.  On
CUDA tensors one hand-written kernel (``csrc/mvn_quad_logdet.cu``) serves
both TPU kernels: the stacked entry for a batch (``_quad_logdet_stacked``)
and the single one for one matrix (``_quad_logdet_single``; fewer matrices
than SMs launch 512 threads a block, more 256); each counts its own
launches.  The kernel is the TPU kernels' left-looking panel Cholesky in
Hopper's terms: panels of 32 columns; the panel update a GEMM whose
operands stream into shared memory by ``cp.async`` and whose FMAs run in
8 × 8 register micro-tiles, split along k between groups of 128 threads;
the 32 × 32 diagonal tile factored by one warp with shuffles; the rows
below solved a thread per row; and the forward substitution folded in by
factoring ``[K; diffᵀ]`` (its last row ends as ``z = L⁻¹ diff``).  A
persistent grid keeps each block's finished panels, column-major, in a
slot of one workspace (``launch_plan``), read back through L2.  On CPU
tensors both entries take the plain version, ``mvn_quad_logdet_plain``
(the JAX package's ``_quad_logdet_reference``), which on the card is the
library route (cuSOLVER's batched Cholesky, then a triangular solve).  The
TPU's identity padding of N to a multiple of 128 and its particles per grid
cell are TPU tile rules and have no counterpart.

``MvnQuadLogdet`` carries the JAX package's custom VJP (``_bwd``): a
plain-PyTorch recompute with ``cholesky_solve`` on both devices, as the
JAX package's backward is stock XLA.  As in the JAX package,
``MultivariateNormal.log_prob`` does not call this entry point.
"""

from __future__ import annotations

import ctypes

import torch

from . import build
from .blocked_linalg import cholesky_nan
from .kernels import _check, _raise_on_error


def mvn_quad_logdet_plain(cov, diff):
    """Plain PyTorch version: ``(quad, half_logdet)`` by Cholesky and a
    triangular solve."""
    chol = cholesky_nan(cov)
    z = torch.linalg.solve_triangular(chol, diff.unsqueeze(-1), upper=False).squeeze(-1)
    quad = (z * z).sum(-1)
    half_logdet = torch.log(torch.diagonal(chol, dim1=-2, dim2=-1)).sum(-1)
    return quad, half_logdet


def launch_plan(B, N, device):
    """The kernel's launch for B matrices of size N on a CUDA ``device``:
    panel width, threads per block, blocks (the persistent grid), the
    workspace it needs, in floats (a slot of N columns of N + 1 rows,
    rounded up to 4, per block), and its dynamic shared memory a block."""
    plan = (ctypes.c_int64 * 5)()
    err = build.library().pyprob_mvn_quad_logdet_plan(B, N, device.index, ctypes.addressof(plan))
    _raise_on_error("mvn_quad_logdet", err)
    return dict(zip(("panel", "threads", "blocks", "workspace_floats", "shared_bytes"), plan))


def _launch(cov, diff, B, N):
    """The kernel over ``cov`` [B, N, N], ``diff`` [B, N] -> [B, 2]."""
    device = cov.device
    work = torch.empty(launch_plan(B, N, device)["workspace_floats"], dtype=torch.float32, device=device)
    out = torch.empty((B, 2), dtype=torch.float32, device=device)
    err = build.library().pyprob_mvn_quad_logdet_f32(
        cov.data_ptr(), diff.data_ptr(), work.data_ptr(), out.data_ptr(), B, N,
        device.index, torch.cuda.current_stream(device).cuda_stream,
    )
    _raise_on_error("mvn_quad_logdet", err)
    return out[:, 0], out[:, 1]


def _quad_logdet_stacked(cov, diff):
    """cov [B, N, N], diff [B, N] -> (quad [B], half_logdet [B])."""
    if cov.device.type == "cpu":
        return mvn_quad_logdet_plain(cov, diff)
    B, N = diff.shape
    if B == 0:
        return diff.new_empty((0,)), diff.new_empty((0,))
    q, ld = _launch(cov, diff, B, N)
    _quad_logdet_stacked.launches += 1
    return q, ld


_quad_logdet_stacked.launches = 0


def _quad_logdet_single(cov, diff):
    """cov [N, N], diff [N] -> (quad, half_logdet), 0-d."""
    if cov.device.type == "cpu":
        return mvn_quad_logdet_plain(cov, diff)
    N = diff.shape[0]
    q, ld = _launch(cov, diff, 1, N)
    _quad_logdet_single.launches += 1
    return q[0], ld[0]


_quad_logdet_single.launches = 0


def _quad_logdet_impl(cov, diff):
    batch = cov.shape[:-2]
    if not batch:
        return _quad_logdet_single(cov, diff)
    N = cov.shape[-1]
    q, ld = _quad_logdet_stacked(cov.reshape((-1, N, N)), diff.reshape((-1, N)))
    return q.reshape(batch), ld.reshape(batch)


class MvnQuadLogdet(torch.autograd.Function):
    """The fused forward with the JAX package's VJP: with α = K⁻¹ diff,
    d quad/dK = −α αᵀ, d quad/d diff = 2α, d half_logdet/dK = ½ K⁻¹."""

    @staticmethod
    def forward(ctx, cov, diff):
        ctx.save_for_backward(cov, diff)
        return _quad_logdet_impl(cov, diff)

    @staticmethod
    def backward(ctx, g_quad, g_logdet):
        cov, diff = ctx.saved_tensors
        return mvn_quad_logdet_backward(cov, diff, g_quad, g_logdet)


def mvn_quad_logdet_backward(cov, diff, g_quad, g_logdet):
    """(d cov, d diff) for the cotangents of (quad, half_logdet)."""
    chol = cholesky_nan(cov)
    alpha = torch.cholesky_solve(diff.unsqueeze(-1), chol).squeeze(-1)
    n = cov.shape[-1]
    eye = torch.eye(n, dtype=cov.dtype, device=cov.device).expand(cov.shape)
    kinv = torch.cholesky_solve(eye, chol)
    g_quad = g_quad[..., None, None]
    g_logdet = g_logdet[..., None, None]
    d_cov = -g_quad * alpha[..., :, None] * alpha[..., None, :] + 0.5 * g_logdet * kinv
    d_diff = 2.0 * g_quad[..., 0] * alpha
    return d_cov, d_diff


def mvn_quad_logdet(cov, diff):
    """``(quad, half_logdet)`` = ``(diffᵀ K⁻¹ diff, ½ log|K|)`` for
    ``cov`` [..., N, N] (float32, contiguous, positive definite; NaN where
    it is not) and ``diff`` [..., N].  Differentiable."""
    if cov.dim() < 2 or cov.shape[-1] != cov.shape[-2]:
        raise ValueError("mvn_quad_logdet: expected cov [..., N, N]")
    _check("mvn_quad_logdet", (cov, diff), (tuple(cov.shape), tuple(cov.shape[:-1])))
    return MvnQuadLogdet.apply(cov, diff)
