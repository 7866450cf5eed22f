"""Three criteria of the JAX package's VI and SVGD tests in the JAX package
and in the port, side by side on the CPU, over seeds.

* ``banana``: tests/test_vi.py's Banana criterion (8,000 draws, the
  fullrank guide and the flow at 3,000 steps, the flow at lr 0.01): the
  flow's ESS above fullrank's + 0.3 N, its final ELBO above fullrank's,
  its reweighted mean and stddev within 0.08 of 400,000-draw prior IS.
* ``gum_elbo``: tests/test_vi.py's GUM meanfield run (4,000 draws, 1,500
  steps): the last step's ELBO estimate (32 particles) at most log Z + 0.1,
  and the mean of the last 100 steps' estimates against the same bound.
* ``svgd_cache``: tests/test_svgd.py's second run after a new observation
  (256 particles, 100 steps): the ensemble's mean below -2.0.

Each is a draw over seeds in either package: this shows how often it is
met.  Prints one JSON line a path, package and seed, then one a path and
package with the count met.

    python tests/vi_reference.py [--paths banana gum_elbo svgd_cache] [--seeds 0 8] [--packages jax port]
"""

import argparse
import json
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import pyprob_tpu  # noqa: E402
import pyprob_tpu_torch  # noqa: E402
import _torch_parity as P  # noqa: E402


def package(name):
    if name == "port":
        pyprob_tpu_torch.set_device("cpu")
        return pyprob_tpu_torch
    return pyprob_tpu


_REFERENCE = {}


def banana(pk, models, seed):
    m = models[0] if pk is pyprob_tpu else models[1]
    vi = pk.InferenceEngine.VARIATIONAL_INFERENCE
    if pk not in _REFERENCE:
        pk.seed(10_000)
        _REFERENCE[pk] = m.posterior_results(400_000, observe={"w": 0.0})
    ref = _REFERENCE[pk]
    pk.seed(seed)
    fr = m.posterior_results(8000, observe={"w": 0.0}, inference_engine=vi, guide="fullrank", vi_steps=3000)
    fl = m.posterior_results(8000, observe={"w": 0.0}, inference_engine=vi, guide="flow", vi_steps=3000,
                             learning_rate=0.01)
    mean_err = float(np.abs(np.asarray(fl.mean, np.float64) - np.asarray(ref.mean, np.float64)).max())
    std_err = float(np.abs(np.asarray(fl.stddev, np.float64) - np.asarray(ref.stddev, np.float64)).max())
    out = {"flow_ess": float(fl.effective_sample_size), "fullrank_ess": float(fr.effective_sample_size),
           "ess_met": float(fl.effective_sample_size) > float(fr.effective_sample_size) + 0.3 * 8000,
           "elbo_met": fl.metadata[-1]["final_elbo"] > fr.metadata[-1]["final_elbo"],
           "moments_met": mean_err < 0.08 and std_err < 0.08, "moment_errors": [mean_err, std_err]}
    out["met"] = out["ess_met"] and out["elbo_met"] and out["moments_met"]
    return out


def gum_elbo(pk, models, seed):
    m = P.JaxGUM() if pk is pyprob_tpu else P.TorchGUM()
    pk.seed(seed)
    post = m.posterior_results(4000, observe=P.OBSERVE, inference_engine=pk.InferenceEngine.VARIATIONAL_INFERENCE)
    final = post.metadata[-1]["final_elbo"]
    out = {"final_elbo": final, "log_evidence": post.log_evidence, "met": final <= post.log_evidence + 0.1}
    if "elbo_history" in post.metadata[-1]:  # the port keeps the history
        late = float(np.mean(post.metadata[-1]["elbo_history"][-100:]))
        out.update(late_elbo=late, late_met=late <= post.log_evidence + 0.1)
    return out


def svgd_cache(pk, models, seed):
    m = P.JaxGUM() if pk is pyprob_tpu else P.TorchGUM()
    svgd = pk.InferenceEngine.STEIN_VARIATIONAL_GRADIENT_DESCENT
    pk.seed(seed)
    m.posterior_results(256, observe=P.OBSERVE, inference_engine=svgd, svgd_particles=256, svgd_steps=100)
    post = m.posterior_results(256, observe={"obs0": -3.0, "obs1": -4.0}, inference_engine=svgd,
                               svgd_particles=256, svgd_steps=100)
    return {"mean": float(post.mean), "met": float(post.mean) < -2.0}


PATHS = {"banana": banana, "gum_elbo": gum_elbo, "svgd_cache": svgd_cache}


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--paths", nargs="+", default=list(PATHS))
    parser.add_argument("--seeds", nargs=2, type=int, default=[0, 8], help="first and last (exclusive) seed")
    parser.add_argument("--packages", nargs="+", default=["jax", "port"])
    args = parser.parse_args()
    torch.set_num_threads(2)
    models = P.body_pair(P.banana_body, jnp.stack, torch_args=(lambda xs: torch.stack(xs, -1),))
    for path in args.paths:
        for name in args.packages:
            pk = package(name)
            met = 0
            for seed in range(*args.seeds):
                out = PATHS[path](pk, models, seed)
                met += bool(out["met"])
                print(json.dumps({"path": path, "package": name, "seed": seed, **out}), flush=True)
            print(json.dumps({"path": path, "package": name, "seeds": args.seeds, "met": met}), flush=True)


if __name__ == "__main__":
    main()
