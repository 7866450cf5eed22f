#!/usr/bin/env python3
"""Where the time of the two mixture backward kernels (1b and 2b) goes.

Builds copies of ``pyprob_tpu_torch/ops/csrc/mixture_normal_backward.cu``
and ``mixture_truncated_normal_backward.cu`` in which thread 0 of each
block reads ``clock64()`` at the kernels' section comments (``// ----
load``, ``// ---- compute``, ``// ---- store``, the row's sums) and at
their end, and keeps each phase's cycles: the loads (until their data has
arrived), the arithmetic with the group's shuffled sums, and the stores.
With ``--baseline DIR`` it does the same for the sources in DIR (a
``pyprob_tpu_torch/ops/csrc`` of an earlier tree, unpacked with ``git
archive``), whose one-thread-a-row design staged its rows through shared
memory: there the phases end at its barriers.  It times each version's
uninstrumented copy at each shape with CUDA events, in turns (baseline,
current, current, baseline), and prints one JSON line per kernel, shape
and version: the times, the blocks of the launch, a block's
cycles and each phase's share.  Needs one CUDA card and nvcc; run from
the repository root:

    python3 profile_mixture_backward.py [--baseline DIR] [BxK ...]   (default 256x10 512x10 262144x10)
"""

import argparse
import json
import subprocess

import torch

from chip_smoke import mixture_inputs, time_ms, tnorm_inputs
from kernel_profile import block_cycles, build_copy, counters, insert, launcher, shares
from pyprob_tpu_torch.ops import build
from pyprob_tpu_torch.ops import kernels as K

PHASES = ("load", "compute", "store")
MAX_BLOCKS = 32768
SOURCES = {
    "mixture_normal_log_prob_backward": "mixture_normal_backward.cu",
    "mixture_truncated_normal_log_prob_backward": "mixture_truncated_normal_backward.cu",
}
ENTRY = {
    "mixture_normal_log_prob_backward": "pyprob_mixture_normal_log_prob_backward_f32",
    "mixture_truncated_normal_log_prob_backward": "pyprob_mixture_truncated_normal_log_prob_backward_f32",
}
# the values each phase of the lane design waits for, by kernel
LOADED = {
    "mixture_normal_log_prob_backward": ("xv + o + gv + mk + sdk + lk", "gr + ds + sum_dmean", "sum_dmean"),
    "mixture_truncated_normal_log_prob_backward": (
        "xv + lo + hi + o + graw + mk + sdk + lk", "r + dm + ds + sum_dx + sum_dlow + sum_dhigh",
        "sum_dx + sum_dlow + sum_dhigh",
    ),
}
# the code after the row's sums, and its last store
AFTER_SUMS = {
    "mixture_normal_log_prob_backward": (
        "  if (dx != nullptr && live && j == 0) dx[row] = -sum_dmean;\n",
    ) * 2,
    "mixture_truncated_normal_log_prob_backward": (
        "  if (live && j == 0) {\n",
        "    if (dhigh != nullptr) dhigh[row] = finite_or_zero(-sum_dhigh);\n  }\n",
    ),
}


def instrumented_source(name, src):
    """``src`` with the clock marks at its phases: the lane design's
    section comments, or the staged design's barriers."""
    declare, start, store = counters(PHASES, MAX_BLOCKS)
    src = insert(src, "namespace {\n", declare)
    if "extern __shared__" in src:  # one thread a row, staged in shared memory
        src = insert(src, "  extern __shared__ float tile[];", start)
        src = insert(src, "  if (threadIdx.x < rows) {\n", "  MARK(0);\n")
        src = insert(src, "  for (int64_t i = threadIdx.x; i < n; i += blockDim.x) {\n    dmeans[",
                     "  MARK(1);\n")
        return insert(src, "    dlogits[base + i] = lg[i];\n  }\n", "  MARK(2);\n" + store, before=False)
    loaded, computed, summed = LOADED[name]
    src = insert(src, "  const int S = K < 32", start)
    src = insert(src, "      // ---- compute\n", f"      MARK_AFTER(0, {loaded});\n")
    src = insert(src, "      // ---- store\n", f"      MARK_AFTER(1, {computed});\n")
    src = insert(src, "  // ---- the row's sum", "  MARK(2);\n")
    sums_used, last_store = AFTER_SUMS[name]
    src = insert(src, sums_used, f"  MARK_AFTER(1, {summed});\n")
    return insert(src, last_store, "  MARK(2);\n" + store, before=False)


def load(tag, name, src, instrumented, directory):
    lib = build_copy(f"{tag}_{name}{'_phases' if instrumented else ''}",
                     instrumented_source(name, src) if instrumented else src, instrumented, directory)
    entry = getattr(lib, ENTRY[name])
    entry.restype, entry.argtypes = build._SIGNATURES[ENTRY[name]]
    return lib, entry


def arguments(name, B, Kc):
    """The entry's arguments at B rows of Kc components (outputs
    preallocated, dx and the bounds' gradients requested)."""
    if name == "mixture_normal_log_prob_backward":
        inputs = mixture_inputs(B, Kc, "cuda", seed=B)
        out = K.mixture_normal_log_prob(*inputs)
        g = torch.randn(B, device="cuda")
        ins = inputs + [out, g]
        outs = [torch.empty(B, device="cuda")] + [torch.empty(B, Kc, device="cuda") for _ in range(3)]
    else:
        *inputs, g = tnorm_inputs(B, Kc, "cuda", seed=B)
        out = K.mixture_truncated_normal_log_prob(*inputs)
        ins = inputs + [out, g]
        outs = ([torch.empty(B, device="cuda")] + [torch.empty(B, Kc, device="cuda") for _ in range(3)]
                + [torch.empty(B, device="cuda") for _ in range(2)])
    return [t.data_ptr() for t in ins + outs] + [B, Kc, torch.cuda.current_device(),
                                                 torch.cuda.current_stream().cuda_stream], ins + outs


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--baseline", help="a directory holding an earlier tree's kernel sources")
    parser.add_argument("shapes", nargs="*", default=["256x10", "512x10", "262144x10"])
    opts = parser.parse_args()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    versions = {"current": build.SOURCE_DIR}
    if opts.baseline:
        versions["baseline"] = opts.baseline
    for name, file in SOURCES.items():
        libs = {}
        for tag, directory in versions.items():
            src = open(f"{directory}/{file}").read()
            libs[tag] = (load(tag, name, src, False, directory), load(tag, name, src, True, directory))
        for shape in opts.shapes:
            B, Kc = map(int, shape.split("x"))
            args, keep = arguments(name, B, Kc)
            order = ["baseline", "current", "current", "baseline"] if opts.baseline else ["current"] * 2
            ms = {tag: [] for tag in versions}
            for tag in order:
                ms[tag].append(time_ms(launcher(libs[tag][0][1], args)))
            for tag in versions:
                (lib, entry) = libs[tag][1]
                blocks = block_cycles(lib, launcher(entry, args), PHASES, MAX_BLOCKS)
                total, share = shares(blocks, PHASES)
                print(json.dumps({
                    "kernel": name, "version": tag, "B": B, "K": Kc, "nvidia_smi": smi,
                    "ms": ms[tag], "blocks": len(blocks), "block_kcycles": total / 1e3, "share": share,
                }), flush=True)
            del keep


if __name__ == "__main__":
    main()
