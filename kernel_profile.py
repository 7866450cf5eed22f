"""Per-phase cycles of a hand-written CUDA kernel, for the profiling scripts.

A profiling script makes a copy of a kernel source in which thread 0 of
each block reads ``clock64()`` at the kernel's section comments: it
inserts ``counters``' three pieces of text and a ``MARK(n)`` (the cycles
since the last mark go to phase n) at anchors of the source with
``insert``, builds the copy with ``build_copy`` and reads each block's
cycles back with ``block_cycles`` after a launch.  Needs nvcc and a CUDA
card.
"""

import ctypes
import subprocess

from pyprob_tpu_torch.ops import build

_READ = """
extern "C" int read_phase_cycles(unsigned long long* dst) {
  return (int)cudaMemcpyFromSymbol(dst, phase_cycles, sizeof(phase_cycles));
}
extern "C" int reset_phase_cycles() {
  void* p = nullptr;
  cudaError_t err = cudaGetSymbolAddress(&p, phase_cycles);
  return (int)(err != cudaSuccess ? err : cudaMemset(p, 0, sizeof(phase_cycles)));
}
"""


def insert(src, anchor, text, before=True):
    """``src`` with ``text`` put before (or after) ``anchor``, which must
    occur in it exactly once."""
    if src.count(anchor) != 1:
        raise RuntimeError(f"anchor not found once in the kernel source: {anchor!r}")
    return src.replace(anchor, text + anchor if before else anchor + text)


def counters(phases, max_blocks):
    """The text an instrumented copy inserts: the array of cycles per block
    and phase (at file scope), the clock's start and ``MARK`` (at the
    kernel's start), and the store of thread 0's cycles (at its end)."""
    n = len(phases)
    declare = f"__device__ unsigned long long phase_cycles[{max_blocks}][{n}];\n\n"
    start = (
        "  long long t_last = clock64();\n"
        f"  unsigned long long cycles[{n}] = {{}};\n"
        "#define MARK(n) do { if (threadIdx.x == 0) { const long long t_ = clock64();"
        " cycles[n] += t_ - t_last; t_last = t_; } } while (0)\n"
    )
    store = (
        f"  if (threadIdx.x == 0 && blockIdx.x < {max_blocks})"
        f" for (int n = 0; n < {n}; ++n) phase_cycles[blockIdx.x][n] = cycles[n];\n"
    )
    return declare, start, store


def build_copy(name, src):
    """Build the instrumented ``src`` into ``ops/_build/profile/`` and load
    it; its entry points take the production kernel's arguments."""
    out = build.BUILD_DIR / "profile"
    out.mkdir(parents=True, exist_ok=True)
    cu, so = out / f"{name}.cu", out / f"{name}.so"
    cu.write_text(src + _READ)
    subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-shared", "-o", str(so), str(cu)], check=True)
    lib = ctypes.CDLL(str(so))
    lib.read_phase_cycles.argtypes = [ctypes.c_void_p]
    lib.reset_phase_cycles.argtypes = []
    return lib


def block_cycles(lib, launch, phases, max_blocks):
    """Each block's cycles per phase in one ``launch()`` of the copy, for
    the blocks that ran (at most ``max_blocks``)."""
    import torch

    if lib.reset_phase_cycles() != 0:
        raise RuntimeError("resetting the phase cycles failed")
    launch()
    torch.cuda.synchronize()
    n = len(phases)
    cycles = (ctypes.c_ulonglong * (max_blocks * n))()
    if lib.read_phase_cycles(ctypes.addressof(cycles)) != 0:
        raise RuntimeError("reading the phase cycles failed")
    blocks = [cycles[b * n : (b + 1) * n] for b in range(max_blocks)]
    return [c for c in blocks if any(c)]


def shares(blocks, phases):
    """Mean cycles per block and each phase's share of them."""
    per_phase = [sum(c[n] for c in blocks) / len(blocks) for n in range(len(phases))]
    total = sum(per_phase)
    return total, {name: c / total for name, c in zip(phases, per_phase)}
