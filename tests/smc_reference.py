"""The SMC recipes of the JAX tests in the JAX package and in the port, side
by side on the CPU, over seeds.

* ``guided_lstm``, ``guided_ff``: tests/test_smc.py:226-274's recipe (GUM,
  4,000 training traces, batch 256, lr 0.01, 8-d observe embeddings, LSTM
  dim 32), then guided SMC at 20,000 particles with resample_threshold
  1.0, judged by the test's criteria: mean within 0.2 of 7.25, stddev
  within 0.1 of sqrt(1/1.2), log Z within 0.3 of the analytic value, ESS
  above 0.2 N.
* ``interpreter``: the while-loop Marsaglia GUM on the interpreter filter
  at 2,000 particles, resample_threshold 1.0 (tests/test_smc.py:192-203:
  mean 0.35, stddev 0.25, log Z 0.5).

One seed's network, or one 2,000-particle filter, is a draw: this shows
how often each criterion is met in either package, and the spread over
seeds of the mean.  Prints one JSON line a path, package and seed, then
one a path and package with the shares and the spread.

    python tests/smc_reference.py [--paths guided_lstm ...] [--seeds 8]
"""

import argparse
import json
import math
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import pyprob_tpu  # noqa: E402
import pyprob_tpu_torch  # noqa: E402
import _torch_parity as P  # noqa: E402

GUM_LOGZ = -8.239513
PATHS = {
    "guided_lstm": {"network": "LSTM", "particles": 20_000, "tol": (0.2, 0.1, 0.3)},
    "guided_ff": {"network": "FEEDFORWARD", "particles": 20_000, "tol": (0.2, 0.1, 0.3)},
    "interpreter": {"network": None, "particles": 2000, "tol": (0.35, 0.25, 0.5)},
}


def run(pp, path, seed):
    spec = PATHS[path]
    torch_side = pp is pyprob_tpu_torch
    pp.seed(seed)
    if spec["network"] is None:
        model = (P.TorchMarsagliaWhile if torch_side else P.JaxMarsagliaWhile)()
        engine = pp.InferenceEngine.SEQUENTIAL_MONTE_CARLO
    else:
        model = (P.TorchGUM if torch_side else P.JaxGUM)()
        kwargs = {"lstm_dim": 32} if spec["network"] == "LSTM" else {}
        model.learn_inference_network(
            num_traces=4000, observe_embeddings={"obs0": {"dim": 8}, "obs1": {"dim": 8}},
            inference_network=getattr(pp.InferenceNetwork, spec["network"]), batch_size=256,
            learning_rate_init=0.01, **kwargs,
        )
        engine = pp.InferenceEngine.SEQUENTIAL_MONTE_CARLO_WITH_INFERENCE_NETWORK
    n = spec["particles"]
    post = model.posterior_results(n, observe=P.OBSERVE, inference_engine=engine, resample_threshold=1.0)
    mean, std, log_z = float(post.mean), float(post.stddev), float(post.log_evidence)
    tol = spec["tol"]
    met = {
        "mean": abs(mean - P.POSTERIOR_MEAN) < tol[0],
        "stddev": abs(std - P.POSTERIOR_STDDEV) < tol[1],
        "log_evidence": abs(log_z - GUM_LOGZ) < tol[2],
    }
    if spec["network"] is not None:
        met["ess"] = post.effective_sample_size > 0.2 * n
    return {"mean": mean, "stddev": std, "log_evidence": log_z,
            "ess_fraction": post.effective_sample_size / n, "met": met}


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--paths", nargs="+", default=sorted(PATHS), choices=sorted(PATHS))
    parser.add_argument("--seeds", type=int, default=8)
    args = parser.parse_args()
    pyprob_tpu_torch.set_device("cpu")
    for pp in (pyprob_tpu, pyprob_tpu_torch):
        pp.set_verbosity(0)
    for path in args.paths:
        for pp in (pyprob_tpu, pyprob_tpu_torch):
            lines = []
            for seed in range(args.seeds):
                line = {"path": path, "package": pp.__name__, "seed": seed, **run(pp, path, seed)}
                print(json.dumps(line), flush=True)
                lines.append(line)
            means = np.array([line["mean"] for line in lines])
            print(json.dumps({
                "path": path, "package": pp.__name__, "seeds": args.seeds,
                "met": {k: sum(line["met"][k] for line in lines) for k in lines[0]["met"]},
                "mean_of_means": float(means.mean()),
                "spread_of_means": float(means.std(ddof=1)) if len(means) > 1 else math.nan,
            }), flush=True)


if __name__ == "__main__":
    main()
