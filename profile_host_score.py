"""The interpreter tier's host scoring of 0-d Normals and Uniforms against
the distributions' own ``log_prob``.

``state._score`` scores a Normal or a Uniform of 0-d parameters at a 0-d
value in float64 on the Python side; every other case, and the
alternative timed here, is ``float(distribution.log_prob(value,
sum=True))``: a few torch calls a site.  The script times, in turns
(host, torch, torch, host), 100,000 traces of prior IS of the while-loop
``GaussianUnknownMeanMarsaglia`` on the interpreter tier and 12,000 traces
of lockstep IC (after 1,000 to warm up) from its network trained with
bench.py's recipe (seed 123, 25,600 traces, as chip_smoke.py trains it),
each from the same seed, and prints one JSON line per run and one with
the card's name and power limit.  Run from the repository root:

    python3 profile_host_score.py [--device cuda | cpu]
"""

import argparse
import json
import subprocess
import time

from chip_smoke import INTERPRETER, MARSAGLIA, OBSERVE, marsaglia_train_kwargs


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    opts = parser.parse_args()
    import torch

    import pyprob_tpu_torch as pp
    from pyprob_tpu_torch import state
    from pyprob_tpu_torch.models import GaussianUnknownMeanMarsaglia

    pp.set_device(opts.device)
    pp.set_verbosity(0)
    host = state._score

    def torch_score(distribution, value):
        return float(distribution.log_prob(value, sum=True))

    def sync():
        if opts.device == "cuda":
            torch.cuda.synchronize()

    model = GaussianUnknownMeanMarsaglia()
    pp.seed(INTERPRETER["seed"])
    model.learn_inference_network(num_traces=MARSAGLIA["train_traces"], **marsaglia_train_kwargs())
    engine = pp.InferenceEngine.IMPORTANCE_SAMPLING_WITH_INFERENCE_NETWORK
    runs = (
        ("prior_is", INTERPRETER["prior_traces"], {}),
        ("lockstep_ic", INTERPRETER["traces"], {"inference_engine": engine}),
    )
    model.posterior_results(INTERPRETER["warm_up"], observe=OBSERVE, vectorized=False, inference_engine=engine)
    for label, n, kw in runs:
        for name, fn in (("host", host), ("torch", torch_score), ("torch", torch_score), ("host", host)):
            state._score = fn
            pp.seed(1)
            sync()
            t0 = time.perf_counter()
            post = model.posterior_results(n, observe=OBSERVE, vectorized=False, **kw)
            sync()
            seconds = time.perf_counter() - t0
            print(json.dumps({
                "run": label, "score": name, "traces": n, "seconds": seconds, "traces_per_s": n / seconds,
                "mean": float(post.mean), "ess": post.effective_sample_size,
            }), flush=True)
    state._score = host
    if opts.device == "cuda":
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True,
        ).stdout.strip()
        print(json.dumps({"device": torch.cuda.get_device_name(0), "nvidia_smi": smi}), flush=True)


if __name__ == "__main__":
    main()
