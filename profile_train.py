#!/usr/bin/env python3
"""Where the time of the online training loop goes on the card.

Trains pyprob_tpu_torch's LSTM inference network for GaussianUnknownMean
with bench.py's lstm512 recipe (lstm_dim 512, batch 512, lr 0.005, 10
mixture components, 16-d observe embeddings, POLY1, EMA 0.9): one call of
12,800 traces to warm up, then one call of 10,240 traces (20 optimizer
steps) under ``torch.profiler``, then 20 more steps of the loop's body
with the host clock read between its stages (no added synchronisation:
the device is idle most of the step, so each stage's host time is what it
costs).  Prints one JSON line: wall time per step, device time summed by
kernel group and the top kernels, the device's idle share of the wall
time, the host's top operators by self CPU time, host ms per stage, and
the peak device memory.  Needs one CUDA card; run from the repository
root:

    python3 profile_train.py [marsaglia]

With the argument ``marsaglia`` it trains GaussianUnknownMeanMarsagliaRejection
with bench.py's Marsaglia recipe instead (lstm_dim 128, batch 256, lr
0.004, 32-d observe embeddings, EMA 0.9).
"""

import json
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile

import pyprob_tpu_torch as pp
from chip_smoke import ARMS, MARSAGLIA, marsaglia_train_kwargs, train_kwargs
from profile_guided_is import device_us
from pyprob_tpu_torch.models import GaussianUnknownMean, GaussianUnknownMeanMarsagliaRejection

WARM_TRACES, PROFILED_TRACES, STAGED_STEPS = 12_800, 10_240, 20


def group(name):
    n = name.lower()
    for kernel in (
        "mixture_normal_log_prob_backward",
        "mixture_normal_log_prob",
        "mixture_truncated_normal_log_prob_backward",
        "mixture_truncated_normal_log_prob",
    ):
        if kernel + "_kernel" in n:
            return kernel + " (CUDA kernel)"
    if "gemm" in n or "cutlass" in n or "cublas" in n:
        return "matmul (cuBLAS)"
    if "foreach" in n or "multi_tensor" in n:
        return "optimizer and EMA (foreach)"
    if "memcpy" in n or "memset" in n:
        return "copies"
    if "normal" in n or "philox" in n or "random" in n:
        return "random numbers (batch draws)"
    if "elementwise" in n or "vectorized" in n or "reduce" in n:
        return "elementwise and reductions (PyTorch)"
    return "other"


def stage_ms(model, steps, B):
    """Host ms per stage of the online loop's step (``_online_optimize``)
    at batch size ``B``, averaged over ``steps`` steps."""
    from pyprob_tpu_torch.nn import OnlineDataset

    net = model._inference_network
    dataset = OnlineDataset(model)
    names = ("draw batch", "pack", "loss forward", "backward", "optimizer step", "ema",
             "loss to host (sync)")
    totals = dict.fromkeys(names, 0.0)
    for _ in range(steps):
        stamps = [time.perf_counter()]
        outputs, sites = dataset.next_device_batch(B)
        stamps.append(time.perf_counter())
        batch = net._packed_batch_from_outputs(outputs, sites, B)
        stamps.append(time.perf_counter())
        _, loss_fn = net._make_loss_for(batch.addrs, batch.dist_names)
        loss = loss_fn(net._loss_params_subset(batch.addrs, batch.dist_names), batch.packed) / B
        stamps.append(time.perf_counter())
        net._optimizer.zero_grad(set_to_none=True)
        loss.backward()
        stamps.append(time.perf_counter())
        net._optimizer_step(net._current_learning_rate())
        stamps.append(time.perf_counter())
        net._ema_update_host()
        stamps.append(time.perf_counter())
        float(loss.detach())
        stamps.append(time.perf_counter())
        for name, a, b in zip(names, stamps, stamps[1:]):
            totals[name] += (b - a) * 1e3
    return {name: t / steps for name, t in totals.items()}


def is_kernel(e):
    # record_function ranges (Optimizer.step#Adam.step) carry device time
    # of the kernels inside them; count kernels only
    return (
        e.device_type.name == "CUDA" and device_us(e) > 0
        and not getattr(e, "is_user_annotation", False) and "#" not in e.key
    )


def main():
    if not torch.cuda.is_available():
        raise SystemExit("profile_train: no CUDA device is available")
    pp.set_device("cuda")
    pp.seed(0)
    pp.set_verbosity(0)
    if sys.argv[1:] == ["marsaglia"]:
        arm = MARSAGLIA
        model = GaussianUnknownMeanMarsagliaRejection()
        kw = marsaglia_train_kwargs()
    else:
        arm = ARMS[1]
        model = GaussianUnknownMean()
        kw = train_kwargs(arm, segments=4)
    model.learn_inference_network(num_traces=WARM_TRACES, **kw)
    net = model._inference_network
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    steps_before = net._total_train_iterations
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        model.learn_inference_network(num_traces=PROFILED_TRACES, **kw)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    steps = net._total_train_iterations - steps_before
    events = prof.key_averages()
    kernels = [e for e in events if is_kernel(e)]
    busy_us = sum(device_us(e) for e in kernels)
    groups = {}
    for e in kernels:
        g = group(e.key)
        groups[g] = groups.get(g, 0.0) + device_us(e)
    top = sorted(kernels, key=device_us, reverse=True)[:12]
    host = sorted(
        (e for e in events if e.device_type.name == "CPU"),
        key=lambda e: e.self_cpu_time_total, reverse=True,
    )[:12]
    stages = stage_ms(model, STAGED_STEPS, arm["batch_size"])
    print(json.dumps({
        "card": torch.cuda.get_device_name(0),
        "model": type(model).__name__,
        "lstm_dim": arm["lstm_dim"], "batch_size": arm["batch_size"],
        "traces": PROFILED_TRACES, "optimizer_steps": steps,
        "wall_ms": wall_us / 1e3, "wall_ms_per_step": wall_us / 1e3 / steps,
        "traces_per_s": PROFILED_TRACES / (wall_us / 1e6),
        "device_busy_ms": busy_us / 1e3, "device_busy_ms_per_step": busy_us / 1e3 / steps,
        "idle_share": 1.0 - busy_us / wall_us,
        "kernel_launches_per_step": sum(e.count for e in kernels) / steps,
        "groups_ms": {k: v / 1e3 for k, v in sorted(groups.items(), key=lambda kv: -kv[1])},
        "top_kernels": [
            {"name": e.key[:100], "ms": device_us(e) / 1e3, "calls": e.count} for e in top
        ],
        "top_host_ops": [
            {"name": e.key[:80], "self_cpu_ms": e.self_cpu_time_total / 1e3, "calls": e.count}
            for e in host
        ],
        "host_ms_per_stage": stages, "host_ms_per_step_staged": sum(stages.values()),
        "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30,
        "final_loss": net._history_train_loss[-1],
    }), flush=True)


if __name__ == "__main__":
    main()
