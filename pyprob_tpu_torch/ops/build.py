"""Build and load the hand-written CUDA kernels.

The sources under ``csrc/`` are compiled with ``nvcc`` for ``sm_90a``
(Hopper) into one shared library with a plain C interface, loaded with
``ctypes``.  The build runs at first use, one ``nvcc`` per source started
together, then one link; the library lands in ``ops/_build/`` under a name
keyed on a hash of the sources and flags, so an edited source rebuilds and
an unchanged one is loaded as is.  Nothing here runs at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

_HERE = Path(__file__).resolve().parent
SOURCE_DIR = _HERE / "csrc"
BUILD_DIR = _HERE / "_build"
SOURCES = (
    "mixture_normal.cu",
    "mixture_normal_backward.cu",
    "mixture_truncated_normal.cu",
    "mixture_truncated_normal_backward.cu",
    "log_weight_stats.cu",
    "tile_chol.cu",
    "mvn_quad_logdet.cu",
)
HEADERS = ("mixture_lanes.cuh",)  # included by sources; part of the key
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
)

_lock = threading.Lock()
_lib = None
build_seconds = None  # wall time of the build this process ran, if any
build_log = ""  # nvcc's output (ptxas register/spill report per kernel)

_P = ctypes.c_void_p
_I = ctypes.c_int64
_SIGNATURES = {
    # name: (restype, argtypes)
    "pyprob_mixture_normal_log_prob_f32": (ctypes.c_int, [_P, _P, _P, _P, _P, _I, _I, _I, _P]),
    "pyprob_mixture_normal_log_prob_backward_f32": (
        ctypes.c_int, [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
    ),
    "pyprob_mixture_truncated_normal_log_prob_f32": (
        ctypes.c_int, [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
    ),
    "pyprob_mixture_truncated_normal_log_prob_backward_f32": (
        ctypes.c_int, [_P] * 14 + [_I, _I, _I, _P],
    ),
    "pyprob_log_weight_stats_capacity": (ctypes.c_int64, [_I]),
    "pyprob_log_weight_stats_f32": (ctypes.c_int, [_P, _P, _P, _P, _I, _I, _I, _P]),
    "pyprob_tile_chol_inv_f32": (ctypes.c_int, [_P, _I, _I, _P, _I, _I, _I, _P, _I, _I, _I, _P]),
    "pyprob_mvn_quad_logdet_plan": (ctypes.c_int, [_I, _I, _I, _P]),
    "pyprob_mvn_quad_logdet_f32": (ctypes.c_int, [_P, _P, _P, _P, _I, _I, _I, _P]),
}


def nvcc_path():
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [os.path.join(cuda_home, "bin", "nvcc")] if cuda_home else []
    candidates += [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    for c in candidates:
        if c and os.path.isfile(c):
            return c
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME); the CUDA kernels of "
        "pyprob_tpu_torch are built from source at first use"
    )


def _source_key():
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((SOURCE_DIR / name).read_bytes())
    return h.hexdigest()[:16]


def _build(target):
    global build_seconds, build_log
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        for name in SOURCES:
            obj = os.path.join(tmp, name + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-c", str(SOURCE_DIR / name), "-o", obj]
            procs.append((cmd, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
            )))
        logs, failed = [], []
        for cmd, _, p in procs:
            out, _ = p.communicate()
            logs.append(" ".join(cmd) + "\n" + out)
            if p.returncode != 0:
                failed.append(cmd[-3])
        if failed:
            raise RuntimeError(
                f"nvcc failed for {failed}:\n" + "\n".join(logs)
            )
        so_tmp = os.path.join(tmp, target.name)
        link = [nvcc, "-shared", *[o for _, o, _ in procs], "-o", so_tmp]
        res = subprocess.run(link, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        logs.append(" ".join(link) + "\n" + res.stdout)
        if res.returncode != 0:
            raise RuntimeError("nvcc link failed:\n" + "\n".join(logs))
        os.replace(so_tmp, target)  # atomic: concurrent builds agree
    build_seconds = time.perf_counter() - t0
    build_log = "\n".join(logs)
    (BUILD_DIR / (target.stem + ".log")).write_text(build_log)


def library():
    """The loaded kernel library, built first if needed."""
    global _lib, build_log
    with _lock:
        if _lib is None:
            target = BUILD_DIR / f"libpyprob_tpu_torch_kernels_{_source_key()}.so"
            if not target.exists():
                _build(target)
            else:  # built by an earlier process: its nvcc output is beside it
                log = BUILD_DIR / (target.stem + ".log")
                build_log = log.read_text() if log.exists() else ""
            lib = ctypes.CDLL(str(target))
            for name, (restype, argtypes) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.restype = restype
                fn.argtypes = argtypes
            _lib = lib
        return _lib
