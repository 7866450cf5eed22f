#!/usr/bin/env python3
"""Where the time of one guided importance-sampling run goes on the card.

Runs pyprob_tpu_torch's guided IS for GaussianUnknownMean (a freshly built
LSTM network, lstm_dim 512, 10 mixture components, 16-d observe
embeddings) over 1,000,000 traces once to warm up, then once under
``torch.profiler``, and prints one JSON line: wall time, device time summed
by kernel (top entries and groups), the device's idle share of the wall
time, and the peak device memory.  With the argument ``marsaglia`` it
serves GaussianUnknownMeanMarsagliaRejection instead, with a network
trained first by bench.py's Marsaglia recipe (lstm_dim 128, 25,600
traces), and adds the retry rounds per chunk.  With ``gp`` it runs prior
IS of GaussianProcessRegression at N = 256 over 8,192 traces (``gp 512``:
N = 512 over 2,048), the sizes of chip_smoke.py's GP phase.  With
``lockstep`` it runs bench.py's while-loop Marsaglia arm on the
interpreter tier, as chip_smoke.py's interpreter phases do (seed 123,
25,600 training traces, then 12,000 traces of lockstep guided IS after
1,000 to warm up, once without the profiler), and adds the rounds and the
wall time spent answering them (host packing, device step and copies)
against the workers' own.
Needs one CUDA card; run from the repository root:

    python3 profile_guided_is.py [marsaglia | lockstep | gp [256 | 512]]
"""

import json
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile

import pyprob_tpu_torch as pp
from chip_smoke import (
    GP_RUNS, INTERPRETER, MARSAGLIA, NUM_TRACES, OBSERVE, gp_model, guided_model,
    marsaglia_train_kwargs,
)
from pyprob_tpu_torch import interpreter_lockstep
from pyprob_tpu_torch.models import GaussianUnknownMeanMarsaglia, GaussianUnknownMeanMarsagliaRejection

LSTM_DIM = 512


def device_us(event):
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(event, attr):
            return getattr(event, attr)
    return 0.0


def group(name):
    n = name.lower()
    if "mixture_normal_log_prob_kernel" in n:
        return "mixture_normal_log_prob (CUDA kernel)"
    if "mixture_truncated_normal_log_prob_kernel" in n:
        return "mixture_truncated_normal_log_prob (CUDA kernel)"
    if "lw_stats" in n:
        return "log_weight_stats (CUDA kernel)"
    if "tile_chol_inv_kernel" in n:
        return "chol_inv_tile (CUDA kernel)"
    if "trsm" in n or "trsv" in n:
        return "triangular solve (cuBLAS)"
    if "gemm" in n or "cutlass" in n or "cublas" in n:
        return "matmul (cuBLAS)"
    if "memcpy" in n or "memset" in n:
        return "copies"
    if "elementwise" in n or "vectorized" in n or "reduce" in n:
        return "elementwise and reductions (PyTorch)"
    return "other"


def main():
    if not torch.cuda.is_available():
        raise SystemExit("profile_guided_is: no CUDA device is available")
    pp.set_device("cuda")
    pp.seed(0)
    pp.set_verbosity(0)
    engine = pp.InferenceEngine.IMPORTANCE_SAMPLING_WITH_INFERENCE_NETWORK
    arm = sys.argv[1] if len(sys.argv) > 1 else "gum"
    num_traces, observe, vectorized = NUM_TRACES, OBSERVE, True
    answer_s = []  # wall seconds of each lockstep round's answer
    if arm == "lockstep":
        lstm_dim, num_traces, vectorized = MARSAGLIA["lstm_dim"], INTERPRETER["traces"], False
        pp.seed(INTERPRETER["seed"])
        model = GaussianUnknownMeanMarsaglia()
        model.learn_inference_network(num_traces=MARSAGLIA["train_traces"], **marsaglia_train_kwargs())
        model.posterior_results(
            INTERPRETER["warm_up"], observe=observe, vectorized=False, inference_engine=engine
        )
        answer = interpreter_lockstep.LockstepCoordinator._answer

        def timed_answer(self, batch):
            t0 = time.perf_counter()
            answer(self, batch)
            answer_s.append(time.perf_counter() - t0)

        interpreter_lockstep.LockstepCoordinator._answer = timed_answer
    elif arm == "marsaglia":
        lstm_dim = MARSAGLIA["lstm_dim"]
        model = GaussianUnknownMeanMarsagliaRejection()
        model.learn_inference_network(num_traces=MARSAGLIA["train_traces"], **marsaglia_train_kwargs())
    elif arm == "gp":
        N = int(sys.argv[2]) if len(sys.argv) > 2 else 256
        lstm_dim, engine = None, pp.InferenceEngine.IMPORTANCE_SAMPLING
        num_traces = dict(GP_RUNS)[N]
        model, y = gp_model(N)
        observe = {"y": y}
    else:
        lstm_dim = LSTM_DIM
        model = guided_model(LSTM_DIM)

    def run():
        return model.posterior_results(
            num_traces, observe=observe, vectorized=vectorized, inference_engine=engine
        )

    unprofiled = None
    if vectorized:
        run()  # warm-up
    else:
        t0 = time.perf_counter()
        run()
        unprofiled = {"wall_ms": (time.perf_counter() - t0) * 1e3, "rounds": len(answer_s),
                      "answer_ms": sum(answer_s) * 1e3}
        answer_s.clear()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        post = run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.key_averages() if device_us(e) > 0 and e.device_type.name == "CUDA"]
    busy_us = sum(device_us(e) for e in kernels)
    groups = {}
    for e in kernels:
        g = group(e.key)
        groups[g] = groups.get(g, 0.0) + device_us(e)
    top = sorted(kernels, key=device_us, reverse=True)[:12]
    print(json.dumps({
        "card": torch.cuda.get_device_name(0),
        "model": type(model).__name__, "traces": num_traces, "lstm_dim": lstm_dim,
        "wall_ms": wall_us / 1e3, "traces_per_s": num_traces / (wall_us / 1e6),
        "device_busy_ms": busy_us / 1e3, "idle_share": 1.0 - busy_us / wall_us,
        "groups_ms": {k: v / 1e3 for k, v in sorted(groups.items(), key=lambda kv: -kv[1])},
        "top_kernels": [
            {"name": e.key[:100], "ms": device_us(e) / 1e3, "calls": e.count} for e in top
        ],
        "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30,
        "ess_fraction": post.effective_sample_size / num_traces,
        "rejection_rounds_per_chunk": [
            r for meta in post.metadata for r in meta.get("rejection_rounds", [])
        ],
        "lockstep_rounds": len(answer_s) or None,
        "lockstep_answer_ms": sum(answer_s) * 1e3 if answer_s else None,
        "unprofiled": unprofiled,
    }), flush=True)


if __name__ == "__main__":
    main()
