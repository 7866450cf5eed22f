#!/usr/bin/env python3
"""Where the time of the fused MVN quad/log-det kernel (kernels 5/6) goes.

Builds a copy of ``pyprob_tpu_torch/ops/csrc/mvn_quad_logdet.cu`` in which
thread 0 of each block reads ``clock64()`` at the kernel's section comments
(``// ---- GEMM``, ``// ---- epilogue``, ``// ---- diagonal tile``,
``// ---- rows below``) and sums the cycles of each phase, runs it on the GP
covariances of chip_smoke.py's linalg phase, and prints one JSON line per
shape: the uninstrumented kernel's time (CUDA events), the instrumented
block's cycles per matrix and each phase's share of them.  The phases are
the GEMM; the epilogue (the split-k groups' sums into the panel, or the
wait for A where there is no GEMM); the diagonal tile with its barrier;
the rows below with the next chunk's start (its barrier and its loads);
and the last chunk's rows below.  Needs one CUDA card and nvcc; run from
the repository root:

    python3 profile_mvn_quad_logdet.py [BxN ...]     (default 8192x256 2048x512 8192x200 1x256)
"""

import ctypes
import json
import sys

import torch

from chip_smoke import gp_covariances, time_ms
from kernel_profile import block_cycles, build_copy, counters, insert, shares
from pyprob_tpu_torch.ops import build

PHASES = ("gemm", "epilogue", "tile", "rows_below_last", "rows_below_and_chunk_start")
MAX_BLOCKS = 4096


def instrumented_source():
    declare, start, store = counters(PHASES, MAX_BLOCKS)
    src = (build.SOURCE_DIR / "mvn_quad_logdet.cu").read_text()
    src = insert(src, "namespace {", declare)
    src = insert(src, "  Smem& s = *reinterpret_cast<Smem*>(smem_raw);\n", start, before=False)
    src = insert(src, "        // ---- GEMM", "        MARK(4);\n")
    src = insert(src, "        // ---- epilogue", "        MARK(0);\n")
    src = insert(src, "        // ---- diagonal tile", "        MARK(1);\n")
    src = insert(src, "        // ---- rows below", "        MARK(2);\n")
    src = insert(src, "    __syncthreads();\n    if (tid == 0) {\n      out[", "    MARK(3);\n")
    return insert(src, "      out[2 * static_cast<int64_t>(b) + 1] = logdet;\n    }\n  }\n", store,
                  before=False)


def load():
    lib = build_copy("mvn_quad_logdet_phases", instrumented_source())
    P, I = ctypes.c_void_p, ctypes.c_int64
    lib.pyprob_mvn_quad_logdet_plan.argtypes = [I, I, I, P]
    lib.pyprob_mvn_quad_logdet_f32.argtypes = [P, P, P, P, I, I, I, P]
    return lib


def main():
    shapes = [tuple(map(int, a.split("x"))) for a in sys.argv[1:]] or [
        (8192, 256), (2048, 512), (8192, 200), (1, 256)]
    lib = load()
    from pyprob_tpu_torch.ops import mvn_logpdf

    device = torch.device("cuda", torch.cuda.current_device())
    stream = torch.cuda.current_stream().cuda_stream
    for B, N in shapes:
        cov, diff = gp_covariances(N, B, "cuda", seed=N)
        plan = mvn_logpdf.launch_plan(B, N, device)
        if plan["blocks"] > MAX_BLOCKS:
            raise RuntimeError(f"more than {MAX_BLOCKS} blocks")
        work = torch.empty(plan["workspace_floats"], device=device)
        out = torch.empty(B, 2, device=device)

        def launch():
            err = lib.pyprob_mvn_quad_logdet_f32(cov.data_ptr(), diff.data_ptr(), work.data_ptr(),
                                                 out.data_ptr(), B, N, device.index, stream)
            if err != 0:
                raise RuntimeError(f"instrumented launch failed with error {err}")

        total, share = shares(block_cycles(lib, launch, PHASES, MAX_BLOCKS), PHASES)
        blocks = plan["blocks"]
        matrices_per_block = -(-B // blocks)
        print(json.dumps({
            "B": B, "N": N, "device": torch.cuda.get_device_name(0), "launch": plan,
            "ms": time_ms(lambda: mvn_logpdf.mvn_quad_logdet(cov, diff), iters=5, warmup=1),
            "block_kcycles_per_matrix": total / matrices_per_block / 1e3,
            "share": share,
        }), flush=True)
        del cov, diff, work


if __name__ == "__main__":
    main()
