"""Joint Cholesky factor and inverse of batched SPD diagonal tiles.

Counterpart of ``pyprob_tpu/ops/tile_chol.py``: ``chol_inv_tile`` maps
``[..., P, P]`` tiles to ``(L, L⁻¹)``, the diagonal-tile step of the panel
Cholesky (``ops/blocked_linalg.py``).  On a CUDA tensor it launches the
hand-written kernel (``csrc/tile_chol.cu``: one block per tile, any
P ≤ 64); on a CPU tensor it takes the plain version, the same right-looking
column loop vectorised over the batch.  The TPU kernel's transposed
``[P, P, B]`` layout, its padding of the batch to 128 lanes and its
``P == 64`` gate are TPU tile rules and have no counterpart here.
"""

from __future__ import annotations

import torch

from . import build
from .kernels import _check, _raise_on_error

MAX_TILE = 64  # largest P the kernel takes


def chol_inv_tile_plain(tile):
    """Plain PyTorch version: the kernel's column loop over ``[B, P, P]``
    with dense rank-1 updates, each product and difference rounded on its
    own.  A tile that is not positive definite gives NaN from its first
    failing column on (rsqrt of a negative number), as the kernel does."""
    P = tile.shape[-1]
    S = tile.reshape(-1, P, P).clone()
    R = torch.eye(P, dtype=tile.dtype, device=tile.device).expand_as(S).clone()
    L = torch.zeros_like(S)
    M = torch.zeros_like(S)
    idx = torch.arange(P, device=tile.device)
    zero = torch.zeros((), dtype=tile.dtype, device=tile.device)
    for j in range(P):
        d = torch.rsqrt(S[:, j, j])[:, None]
        col = S[:, :, j] * d
        colm = torch.where(idx >= j, col, zero)
        L[:, :, j] = colm
        S = S - colm[:, :, None] * colm[:, None, :]
        cols = torch.where(idx > j, col, zero)
        mrow = torch.where(idx <= j, R[:, j, :] * d, zero)
        M[:, j, :] = mrow
        R = R - cols[:, :, None] * mrow[:, None, :]
    return L.reshape(tile.shape), M.reshape(tile.shape)


def chol_inv_tile(tile):
    """``(L, L⁻¹)`` of SPD tiles ``[..., P, P]`` (float32, contiguous,
    P ≤ 64), both lower triangular with zeros above the diagonal."""
    if tile.dim() < 2 or tile.shape[-1] != tile.shape[-2]:
        raise ValueError("chol_inv_tile: expected tiles [..., P, P]")
    P = tile.shape[-1]
    if not 1 <= P <= MAX_TILE:
        raise ValueError(f"chol_inv_tile: tile size {P} not in 1..{MAX_TILE}")
    device = _check("chol_inv_tile", (tile,), (tuple(tile.shape),))
    if device.type == "cpu":
        return chol_inv_tile_plain(tile)
    L = torch.empty_like(tile)
    M = torch.empty_like(tile)
    B = tile.numel() // (P * P)
    if B == 0:
        return L, M
    err = build.library().pyprob_tile_chol_inv_f32(
        tile.data_ptr(), L.data_ptr(), M.data_ptr(), B, P, device.index,
        torch.cuda.current_stream(device).cuda_stream,
    )
    _raise_on_error("chol_inv_tile", err)
    chol_inv_tile.launches += 1
    return L, M


chol_inv_tile.launches = 0
