#!/usr/bin/env python3
"""Where the time of the panel Cholesky's diagonal-tile kernel (kernel 4) goes.

Builds a copy of ``pyprob_tpu_torch/ops/csrc/tile_chol.cu`` in which
thread 0 of each block reads ``clock64()`` at the kernel's section
comments (``// ---- the lower triangle``, ``// ---- the column loop``,
``// ---- out``) and at its end, and keeps each phase's cycles: the load
(the tile into shared memory and registers, two barriers), the column loop
(one barrier a column) and the stores of L and L^-1.  It runs the copy on
the diagonal tiles of chip_smoke.py's GP covariances as the panel loop
launches the kernel (the tile read in place, L written into rows of width
N) and prints one JSON line per shape: the kernel's time (CUDA events),
the instrumented blocks' cycles and each phase's share.  Needs one CUDA
card and nvcc; run from the repository root:

    python3 profile_tile_chol.py [BxNxP ...]     (default 8192x256x64 2048x512x64 8192x200x8 8192x130x2)
"""

import ctypes
import json
import sys

import torch

from chip_smoke import check_tile, time_ms
from kernel_profile import block_cycles, build_copy, counters, insert, shares
from pyprob_tpu_torch.ops import build, tile_chol

PHASES = ("load", "column_loop", "store")
MAX_BLOCKS = 8192


def instrumented_source():
    declare, start, store = counters(PHASES, MAX_BLOCKS)
    src = (build.SOURCE_DIR / "tile_chol.cu").read_text()
    src = insert(src, "// G x G micro-tiles", declare)
    src = insert(src, "  // ---- the lower triangle", start)
    src = insert(src, "  // ---- the column loop", "  MARK(0);\n")
    src = insert(src, "  // ---- out:", "  MARK(1);\n")
    # thread 0 holds the block's first tile, which always exists
    return insert(src, "      Mb[i * P + k] = k < i ? T[k * LD + i] : k == i ? dinv[i] : 0.0f;\n    }\n  }\n",
                  "  MARK(2);\n" + store, before=False)


def main():
    shapes = sys.argv[1:] or ["8192x256x64", "2048x512x64", "8192x200x8", "8192x130x2"]
    lib = build_copy("tile_chol_phases", instrumented_source())
    P_, I_ = ctypes.c_void_p, ctypes.c_int64
    lib.pyprob_tile_chol_inv_f32.argtypes = [P_, I_, I_, P_, I_, I_, I_, P_, I_, I_, I_, P_]
    for shape in shapes:
        B, N, P = map(int, shape.split("x"))
        k0 = N - P if N % 64 else 0  # a ragged last panel, else the first
        tiles, rows, _ = check_tile(B, P, "cuda", N, k0)
        M = torch.empty(B, P, P, device="cuda")

        def launch():
            err = lib.pyprob_tile_chol_inv_f32(
                tiles.data_ptr(), tiles.stride(0), tiles.stride(1), rows.data_ptr(), rows.stride(0),
                rows.stride(1), rows.shape[-1], M.data_ptr(), B, P, tiles.device.index,
                torch.cuda.current_stream().cuda_stream,
            )
            if err != 0:
                raise RuntimeError(f"instrumented launch failed with error {err}")

        blocks = block_cycles(lib, launch, PHASES, MAX_BLOCKS)
        total, share = shares(blocks, PHASES)
        print(json.dumps({
            "B": B, "N": N, "P": P, "l_row_width": rows.shape[-1],
            "device": torch.cuda.get_device_name(0),
            "ms": time_ms(lambda: tile_chol.chol_inv_tile_into(tiles, rows), iters=20),
            "blocks": len(blocks), "tiles_per_block": -(-B // len(blocks)),
            "block_kcycles": total / 1e3, "column_loop_cycles_per_column": total * share["column_loop"] / P,
            "share": share,
        }), flush=True)
        del tiles, rows, M


if __name__ == "__main__":
    main()
