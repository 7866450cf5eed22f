#!/usr/bin/env python3
"""Where the time of the log-weight statistics kernel (kernel 3) goes.

Builds an uninstrumented copy of ``pyprob_tpu_torch/ops/csrc/log_weight_stats.cu``
and one in which thread 0 of each block reads ``clock64()`` at the
kernel's section comments (``// ---- load``, ``// ---- compute``,
``// ---- merge``, ``// ---- end``) and keeps each phase's cycles: the
loads (until their data has arrived), the warps' maxes, exps and sums
with the block's merge of its warps, and the merge across blocks (the
ticket, and in the last block the triples' merge and the store).  With ``--baseline DIR`` (repeatable) it also
builds the sources in DIR (a ``pyprob_tpu_torch/ops/csrc`` of an earlier
tree, unpacked with ``git archive``; the two-launch kernel before the
one-launch design has its own C interface, which is recognised), each
named by DIR's last component.  At each N it times the versions with CUDA
events in turns (the baselines, current, current, the baselines again),
checks each output against the plain version (m exact, s1 and s2 within
rtol 1e-5; it stops at the first that is not) and prints one JSON line
per N and version: the times, the
bound and the launch floor, the relative error, whether the output is bit
for bit the first baseline's, and for the current kernel the blocks, a block's
mean cycles with each phase's share, and the last block's merge cycles.
First, each version's outputs on ``chip_smoke``'s special inputs, beside
the reference's values.  Needs one CUDA card and nvcc; run from the
repository root:

    python3 profile_log_weight_stats.py [--baseline DIR ...] [N ...]
    (default 256 512 2048 8192 32768 1000000)
"""

import argparse
import ctypes
import json
import os
import subprocess

import torch

from chip_smoke import bound, check, special_stats_vectors, stats_cost, stats_inputs, time_ms
from kernel_profile import block_cycles, build_copy, counters, insert, launcher, shares
from pyprob_tpu_torch.ops import build
from pyprob_tpu_torch.ops import kernels as K

PHASES = ("load", "compute", "merge")
MAX_BLOCKS = 4096
SOURCE = "log_weight_stats.cu"


def instrumented_source(src):
    declare, start, store = counters(PHASES, MAX_BLOCKS)
    src = insert(src, "namespace {\n", declare)
    src = insert(src, "  // the float4 body starts at the first 16-byte boundary\n", start)
    src = insert(src, "    // ---- compute", "    MARK_AFTER(0, v[0].x + v[1].x + v[2].x + v[3].x + x);\n")
    src = insert(src, "    // ---- merge", "    MARK_AFTER(1, s1);\n")
    return insert(src, "  // ---- end", "  MARK(2);\n" + store)


class Version:
    """A built copy of the kernel's source and a launch of it on a [N]
    tensor, through its own C interface: the one-launch kernel's (scratch,
    counter, capacity) or the two-launch kernel's (partial triples)."""

    def __init__(self, tag, src, directory, instrumented=False):
        name = f"stats_{tag}{'_phases' if instrumented else ''}"
        self.lib = build_copy(name, instrumented_source(src) if instrumented else src, instrumented, directory)
        self.entry = self.lib.pyprob_log_weight_stats_f32
        self.one_launch = hasattr(self.lib, "pyprob_log_weight_stats_capacity")
        device = torch.cuda.current_device()
        if self.one_launch:
            self.entry.restype, self.entry.argtypes = build._SIGNATURES["pyprob_log_weight_stats_f32"]
            cap = self.lib.pyprob_log_weight_stats_capacity
            cap.restype, cap.argtypes = ctypes.c_int64, [ctypes.c_int64]
            self.capacity = cap(device)
            self.scratch = torch.empty(3 * self.capacity, device="cuda")
            self.counter = torch.zeros(1, dtype=torch.int32, device="cuda")
        else:
            self.entry.restype = ctypes.c_int
            self.entry.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int64] * 3 + [ctypes.c_void_p]
            blocks = self.lib.pyprob_log_weight_stats_blocks
            blocks.restype, blocks.argtypes = ctypes.c_int64, [ctypes.c_int64]
            self.blocks = blocks

    def launch(self, lw, out):
        """A launch that writes (m, s1, s2) of ``lw`` into ``out``."""
        n, device = lw.shape[0], torch.cuda.current_device()
        stream = torch.cuda.current_stream().cuda_stream
        if self.one_launch:
            args = (lw.data_ptr(), self.scratch.data_ptr(), self.counter.data_ptr(), out.data_ptr(),
                    n, self.capacity, device, stream)
        else:
            blocks = self.blocks(n)
            self.partial = torch.empty(3 * blocks, device="cuda")
            args = (lw.data_ptr(), self.partial.data_ptr(), out.data_ptr(), n, blocks, device, stream)
        return launcher(self.entry, args)


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--baseline", action="append", default=[],
                        help="a directory holding an earlier tree's kernel sources")
    parser.add_argument("sizes", nargs="*", type=int, default=[256, 512, 2048, 8192, 32768, 1_000_000])
    opts = parser.parse_args()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    versions = {os.path.basename(os.path.normpath(d)): Version(os.path.basename(os.path.normpath(d)),
                                                               open(f"{d}/{SOURCE}").read(), d)
                for d in opts.baseline}
    versions["current"] = Version("current", (build.SOURCE_DIR / SOURCE).read_text(), build.SOURCE_DIR)
    probe = Version("current", (build.SOURCE_DIR / SOURCE).read_text(), build.SOURCE_DIR, instrumented=True)
    tags = list(versions)
    out = torch.empty(3, device="cuda")

    special = {}
    for name, (lw_np, want) in special_stats_vectors().items():
        lw = torch.tensor(lw_np, device="cuda")
        special[name] = {"reference": [repr(v) for v in want]}
        for tag in tags:
            versions[tag].launch(lw, out)()
            special[name][tag] = [repr(v) for v in out.tolist()]
    print(json.dumps({"kernel": "log_weight_stats", "special": special, "nvidia_smi": smi}), flush=True)

    one = torch.zeros(1, device="cuda")
    floor = min(time_ms(lambda: torch.cuda._sleep(0)), time_ms(lambda: one.add_(1.0)))
    for n in opts.sizes:
        _, lw = stats_inputs(n, "cuda", seed=n)
        ms = {tag: [] for tag in tags}
        for tag in tags + tags[::-1]:
            ms[tag].append(time_ms(versions[tag].launch(lw, out)))
        pm, ps1, ps2 = (float(v) for v in K.log_weight_stats_plain(lw))
        bound_ms, bound_by = bound(*stats_cost(n))
        outs = {}
        for tag in tags:
            versions[tag].launch(lw, out)()
            outs[tag] = out.clone()
        for tag in tags:
            m, s1, s2 = outs[tag].tolist()
            rel_err = max(abs(s1 - ps1) / ps1, abs(s2 - ps2) / ps2)
            check(m == pm and rel_err <= 1e-5, f"{tag} at N={n}: {(m, s1, s2)}, plain {(pm, ps1, ps2)}")
            line = {
                "kernel": "log_weight_stats", "version": tag, "N": n, "nvidia_smi": smi, "ms": ms[tag],
                "bound_ms": bound_ms, "bound_by": bound_by, "launch_floor_ms": floor,
                "max_equal": m == pm, "max_rel_err": rel_err,
            }
            if len(tags) > 1:
                line["bit_equal_baseline"] = bool(torch.equal(outs[tag], outs[tags[0]]))
            if tag == "current":
                blocks = block_cycles(probe.lib, probe.launch(lw, out), PHASES, MAX_BLOCKS)
                total, share = shares(blocks, PHASES)
                line.update(blocks=len(blocks), block_kcycles=total / 1e3, share=share,
                            last_merge_kcycles=max(c[2] for c in blocks) / 1e3)
            print(json.dumps(line), flush=True)


if __name__ == "__main__":
    main()
