#!/usr/bin/env python3
"""Where the time of the two mixture forward kernels (1 and 2) goes.

Builds copies of ``pyprob_tpu_torch/ops/csrc/mixture_normal.cu`` and
``mixture_truncated_normal.cu`` in which thread 0 of each block reads
``clock64()`` at the lane kernels' section comments (``// ---- load``,
``// ---- compute``, ``// ---- store``) and at their end, and keeps each
phase's cycles: the loads (until their data has arrived), the terms with
the fold of the row's lanes, and the store.  Where a source holds both
mappings (a row on lanes below ``kThreadRowsFrom`` rows, one thread a row
from there on, the threshold in ``mixture_lanes.cuh``), it also builds the
copies ``lanes`` and ``rows`` that take one mapping at every B (the
threshold defined before the source), each with its phases; a one-thread-a-row kernel's
loop (loads and arithmetic) counts as compute, its store as store.  With
``--baseline DIR`` it does the same for the sources in DIR (a
``pyprob_tpu_torch/ops/csrc`` of an earlier tree, unpacked with ``git
archive``).  It times each version's uninstrumented copy
at each shape with CUDA events, in turns (baseline, current, lanes, rows,
then the same backwards), checks each version's output against the plain
version, and prints one JSON line per kernel, shape and version: the
times, the max abs error, whether the output is bit for bit the
baseline's (on these random finite rows), the blocks of the launch, a
block's cycles and each phase's share; first, each version's outputs on the special rows
of ``chip_smoke.set_special_rows``.  Needs one CUDA card and nvcc; run from the
repository root:

    python3 profile_mixture_forward.py [--baseline DIR] [BxK ...]
    (default 256x10 512x10 24576x10 28672x10 32768x10 65536x10 262144x10)
"""

import argparse
import json
import re
import subprocess

import torch

from chip_smoke import mixture_inputs, nan_pattern_equal, set_special_rows, time_ms, tnorm_inputs
from kernel_profile import block_cycles, build_copy, counters, insert, launcher, shares
from pyprob_tpu_torch.ops import build
from pyprob_tpu_torch.ops import kernels as K

PHASES = ("load", "compute", "store")
MAX_BLOCKS = 32768
SOURCES = {
    "mixture_normal_log_prob": "mixture_normal.cu",
    "mixture_truncated_normal_log_prob": "mixture_truncated_normal.cu",
}
ENTRY = {
    "mixture_normal_log_prob": "pyprob_mixture_normal_log_prob_f32",
    "mixture_truncated_normal_log_prob": "pyprob_mixture_truncated_normal_log_prob_f32",
}
# the values the lane kernel's load phase waits for, and its store
LOADED = {
    "mixture_normal_log_prob": "xv + mk + sdk + lk",
    "mixture_truncated_normal_log_prob": "xv + lo + hi + mk + sdk + lk",
}
# the header that holds the row threshold, and the define that overrides it
HEADER = '#include "mixture_lanes.cuh"'
FORCE = "#define MIXTURE_THREAD_ROWS_FROM {}\n"


def instrumented_source(name, src, rows=False):
    """``src`` with the clock marks at its phases: the lane kernel's section
    comments or, for a source without them or where ``rows``, the
    one-thread-a-row kernel's loop (its load and compute) and store."""
    declare, start, store = counters(PHASES, MAX_BLOCKS)
    src = insert(src, "namespace {\n", declare)
    if rows or "// ---- load" not in src:
        src = insert(src, re.search(r"  (?:const |for \()int64_t row = blockIdx\.x", src).group(0), start)
        src = insert(src, "out[row] = (m == -INFINITY", "MARK(1);\n")
        last = re.search(r"out\[row\] = \(m == -INFINITY[^\n]*\n", src).group(0)
        return insert(src, last, "MARK(2);\n" + store, before=False)
    src = insert(src, "  const RowLanes r(B, K);", start)
    src = insert(src, "      // ---- compute", f"      MARK_AFTER(0, {LOADED[name]});\n")
    src = insert(src, "  // ---- store", "  MARK_AFTER(1, s);\n")
    last = re.search(r"  if \(r\.live && r\.j == 0\)\s*out\[r\.row\] = [^\n]*\n", src).group(0)
    return insert(src, last, "  MARK(2);\n" + store, before=False)


def versions(directory, tag):
    """(tag, source) of each version a source directory gives: the source as
    it is and, for the current sources where they hold both mappings, one
    copy forced to each (the header's row threshold defined before it)."""
    out = {}
    for name, file in SOURCES.items():
        src = open(f"{directory}/{file}").read()
        out[(tag, name)] = src
        if tag == "current" and HEADER in src:
            out[("lanes", name)] = FORCE.format("INT64_MAX") + src
            out[("rows", name)] = FORCE.format(0) + src
    return out


def load(tag, name, src, instrumented, directory):
    lib = build_copy(f"fwd_{tag}_{name}{'_phases' if instrumented else ''}",
                     instrumented_source(name, src, tag == "rows") if instrumented else src, instrumented,
                     directory)
    entry = getattr(lib, ENTRY[name])
    entry.restype, entry.argtypes = build._SIGNATURES[ENTRY[name]]
    return lib, entry


def arguments(name, B, Kc, special=False):
    """The entry's arguments at B rows of Kc components, its output and the
    plain version's output; ``special``: with ``chip_smoke``'s special rows."""
    if name == "mixture_normal_log_prob":
        inputs = mixture_inputs(B, Kc, "cuda", seed=B)
    else:
        inputs = tnorm_inputs(B, Kc, "cuda", seed=B)[:6]
    if special:
        set_special_rows(inputs)
    ref = getattr(K, name + "_plain")(*inputs)
    out = torch.empty(B, device="cuda")
    args = [t.data_ptr() for t in inputs + [out]] + [
        B, Kc, torch.cuda.current_device(), torch.cuda.current_stream().cuda_stream]
    return args, inputs, out, ref


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--baseline", help="a directory holding an earlier tree's kernel sources")
    parser.add_argument("shapes", nargs="*",
                        default=["256x10", "512x10", "24576x10", "28672x10", "32768x10", "65536x10",
                                 "262144x10"])
    opts = parser.parse_args()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    sources = versions(build.SOURCE_DIR, "current")
    if opts.baseline:
        sources.update(versions(opts.baseline, "baseline"))
    directory = {tag: opts.baseline if tag == "baseline" else build.SOURCE_DIR for tag, _ in sources}
    for name in SOURCES:
        tags = [tag for tag, n in sources if n == name]
        libs = {tag: load(tag, name, sources[(tag, name)], False, directory[tag]) for tag in tags}
        # the phases of each mapping (forced where the source has both) and
        # of the baseline
        phased = [tag for tag in tags if tag != "current" or "lanes" not in tags]
        probes = {tag: load(tag, name, sources[(tag, name)], True, directory[tag]) for tag in phased}
        # each version's outputs on the special rows (two +inf logits, a NaN
        # logit, all -inf, one -inf, ..., a NaN logit among -inf ones)
        args, inputs, out, ref = arguments(name, 8, 10, special=True)
        special = {"plain": [repr(float(v)) for v in ref]}
        for tag in tags:
            launcher(libs[tag][1], args)()
            special[tag] = [repr(float(v)) for v in out]
        print(json.dumps({"kernel": name, "special_rows": special}), flush=True)
        for shape in opts.shapes:
            B, Kc = map(int, shape.split("x"))
            args, inputs, out, ref = arguments(name, B, Kc)
            ms = {tag: [] for tag in tags}
            for tag in tags + tags[::-1]:
                ms[tag].append(time_ms(launcher(libs[tag][1], args)))
            outs = {}
            for tag in tags:
                launcher(libs[tag][1], args)()
                torch.cuda.synchronize()
                outs[tag] = out.clone()
            for tag in tags:
                out.copy_(outs[tag])
                finite = torch.isfinite(ref)
                line = {
                    "kernel": name, "version": tag, "B": B, "K": Kc, "nvidia_smi": smi, "ms": ms[tag],
                    "max_abs_err": float((out - ref).abs()[finite].max()),
                    "pattern_equal": nan_pattern_equal(out, ref)
                    and bool((torch.isinf(out) == torch.isinf(ref)).all()),
                }
                if "baseline" in outs:  # finite random rows: the same bits?
                    line["bit_equal_baseline"] = bool(torch.equal(out, outs["baseline"]))
                if tag in probes:
                    lib, entry = probes[tag]
                    blocks = block_cycles(lib, launcher(entry, args), PHASES, MAX_BLOCKS)
                    if blocks:  # none where B sends the launch to one thread a row
                        total, share = shares(blocks, PHASES)
                        line.update(blocks=len(blocks), block_kcycles=total / 1e3, share=share)
                print(json.dumps(line), flush=True)
            del inputs


if __name__ == "__main__":
    main()
