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
import subprocess
import sys

import torch

from chip_smoke import gp_covariances, time_ms
from pyprob_tpu_torch.ops import build

PHASES = ("gemm", "epilogue", "tile", "rows_below_last", "rows_below_and_chunk_start")
MAX_BLOCKS = 4096


def instrumented_source():
    src = (build.SOURCE_DIR / "mvn_quad_logdet.cu").read_text()

    def insert(anchor, text, before=True):
        nonlocal src
        if src.count(anchor) != 1:
            raise RuntimeError(f"anchor not found once in the kernel source: {anchor!r}")
        src = src.replace(anchor, text + anchor if before else anchor + text)

    insert("namespace {", f"__device__ unsigned long long phase_cycles[{MAX_BLOCKS}][5];\n")
    insert("  Smem& s = *reinterpret_cast<Smem*>(smem_raw);\n",
           "  long long t_last = clock64();\n"
           "  unsigned long long cycles[5] = {0, 0, 0, 0, 0};\n"
           "#define MARK(n) do { if (threadIdx.x == 0) { const long long t_ = clock64();"
           " cycles[n] += t_ - t_last; t_last = t_; } } while (0)\n", before=False)
    insert("        // ---- GEMM", "        MARK(4);\n")
    insert("        // ---- epilogue", "        MARK(0);\n")
    insert("        // ---- diagonal tile", "        MARK(1);\n")
    insert("        // ---- rows below", "        MARK(2);\n")
    insert("    __syncthreads();\n    if (tid == 0) {\n      out[", "    MARK(3);\n")
    insert("      out[2 * static_cast<int64_t>(b) + 1] = logdet;\n    }\n  }\n",
           "  if (threadIdx.x == 0) for (int n = 0; n < 5; ++n) phase_cycles[blockIdx.x][n] = cycles[n];\n",
           before=False)
    return src + ('\nextern "C" int read_phase_cycles(unsigned long long* dst) {\n'
                  "  return (int)cudaMemcpyFromSymbol(dst, phase_cycles, sizeof(phase_cycles));\n}\n")


def load():
    out = build.BUILD_DIR / "profile"
    out.mkdir(parents=True, exist_ok=True)
    (out / "mvn_quad_logdet_phases.cu").write_text(instrumented_source())
    subprocess.run(
        [build.nvcc_path(), *build.NVCC_FLAGS, "-shared", "-o", str(out / "phases.so"),
         str(out / "mvn_quad_logdet_phases.cu")],
        check=True,
    )
    lib = ctypes.CDLL(str(out / "phases.so"))
    P, I = ctypes.c_void_p, ctypes.c_int64
    lib.pyprob_mvn_quad_logdet_plan.argtypes = [I, I, I, P]
    lib.pyprob_mvn_quad_logdet_f32.argtypes = [P, P, P, P, I, I, I, P]
    lib.read_phase_cycles.argtypes = [P]
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
        err = lib.pyprob_mvn_quad_logdet_f32(cov.data_ptr(), diff.data_ptr(), work.data_ptr(),
                                             out.data_ptr(), B, N, device.index, stream)
        torch.cuda.synchronize()
        if err != 0:
            raise RuntimeError(f"instrumented launch failed with error {err}")
        cycles = (ctypes.c_ulonglong * (MAX_BLOCKS * 5))()
        if lib.read_phase_cycles(ctypes.addressof(cycles)) != 0:
            raise RuntimeError("reading the phase cycles failed")
        blocks = plan["blocks"]
        per_phase = [sum(cycles[b * 5 + n] for b in range(blocks)) / blocks for n in range(5)]
        total = sum(per_phase)
        matrices_per_block = -(-B // blocks)
        print(json.dumps({
            "B": B, "N": N, "device": torch.cuda.get_device_name(0), "launch": plan,
            "ms": time_ms(lambda: mvn_logpdf.mvn_quad_logdet(cov, diff), iters=5, warmup=1),
            "block_kcycles_per_matrix": total / matrices_per_block / 1e3,
            "share": {name: c / total for name, c in zip(PHASES, per_phase)},
        }), flush=True)
        del cov, diff, work


if __name__ == "__main__":
    main()
