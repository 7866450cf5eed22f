"""Joint Cholesky factor and inverse of batched SPD diagonal tiles.

Counterpart of ``pyprob_tpu/ops/tile_chol.py``: ``chol_inv_tile`` maps
``[..., P, P]`` tiles to ``(L, L⁻¹)``, the diagonal-tile step of the panel
Cholesky (``ops/blocked_linalg.py``).  On a CUDA tensor it launches the
hand-written kernel (``csrc/tile_chol.cu``: a block per tile of P ≤ 64,
or 64 tiles of P ≤ 8 a block, read in place through their strides); on
a CPU tensor it takes the plain version, the same right-looking column loop
vectorised over the batch.  ``chol_inv_tile_into`` serves the panel loop:
it writes L straight into the panel's rows of the full factor.  The TPU
kernel's transposed ``[P, P, B]`` layout, its padding of the batch to 128 lanes and its
``P == 64`` gate are TPU tile rules and have no counterpart here.
"""

from __future__ import annotations

import torch

from . import build
from .kernels import _raise_on_error

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


def _check_tile(name, tile):
    """P of SPD tiles ``[..., P, P]`` (float32, on the CPU or a card, rows
    of unit stride: the kernel reads a strided view in place)."""
    if tile.dim() < 2 or tile.shape[-1] != tile.shape[-2]:
        raise ValueError(f"{name}: expected tiles [..., P, P]")
    P = tile.shape[-1]
    if not 1 <= P <= MAX_TILE:
        raise ValueError(f"{name}: tile size {P} not in 1..{MAX_TILE}")
    if tile.dtype != torch.float32:
        raise TypeError(f"{name}: expected float32 tiles, got {tile.dtype}")
    if tile.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {tile.device}")
    if P > 1 and tile.stride(-1) != 1:
        raise ValueError(f"{name}: tile rows must have unit stride, got {tile.stride(-1)}")
    return P


def _launch(tile, l_out):
    """Launch the kernel on ``tile`` [B, P, P] writing L into the rows
    ``l_out`` [B, P, W] (zeros past the diagonal); returns L⁻¹ [B, P, P]."""
    B, P, _ = tile.shape
    M = torch.empty((B, P, P), dtype=tile.dtype, device=tile.device)
    if B == 0:
        return M
    err = build.library().pyprob_tile_chol_inv_f32(
        tile.data_ptr(), tile.stride(0), tile.stride(1),
        l_out.data_ptr(), l_out.stride(0), l_out.stride(1), l_out.shape[-1],
        M.data_ptr(), B, P, tile.device.index,
        torch.cuda.current_stream(tile.device).cuda_stream,
    )
    _raise_on_error("chol_inv_tile", err)
    chol_inv_tile.launches += 1
    return M


def chol_inv_tile(tile):
    """``(L, L⁻¹)`` of SPD tiles ``[..., P, P]`` (float32, P ≤ 64,
    contiguous or a view whose rows have unit stride), both lower
    triangular with zeros above the diagonal, contiguous."""
    P = _check_tile("chol_inv_tile", tile)
    if tile.device.type == "cpu":
        return chol_inv_tile_plain(tile)
    flat = tile.reshape(-1, P, P)  # a view unless the batch dims do not collapse
    L = torch.empty(flat.shape, dtype=tile.dtype, device=tile.device)
    M = _launch(flat, L)
    return L.reshape(tile.shape), M.reshape(tile.shape)


def chol_inv_tile_into(tile, l_out):
    """The panel loop's entry: factors the tiles ``tile`` [B, P, P] (a view
    whose rows have unit stride, read in place), writes L into the first
    P columns of the rows ``l_out`` [B, P, W ≥ P] (a view of the full
    factor, rows of unit stride) and zeros into the rest, and returns
    L⁻¹ [B, P, P], contiguous."""
    P = _check_tile("chol_inv_tile_into", tile)
    if tile.dim() != 3:
        raise ValueError("chol_inv_tile_into: expected tiles [B, P, P]")
    B = tile.shape[0]
    if (l_out.dim() != 3 or tuple(l_out.shape[:2]) != (B, P) or l_out.shape[2] < P
            or l_out.dtype != tile.dtype or l_out.device != tile.device):
        raise ValueError(
            f"chol_inv_tile_into: l_out must be float32 [{B}, {P}, >= {P}] on "
            f"{tile.device}, got {l_out.dtype} {tuple(l_out.shape)} on {l_out.device}"
        )
    if l_out.shape[2] > 1 and l_out.stride(2) != 1:
        raise ValueError("chol_inv_tile_into: l_out rows must have unit stride")
    if tile.device.type == "cpu":
        L, M = chol_inv_tile_plain(tile)
        l_out[:, :, :P] = L
        l_out[:, :, P:] = 0
        return M
    return _launch(tile, l_out)


chol_inv_tile.launches = 0
