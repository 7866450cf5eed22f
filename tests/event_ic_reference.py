"""The event-shaped latents' IC recipes (tests/test_proposals_extended.py:
303-361, 388-410) and the LinearGaussianStateSpace IC recipe of
``chip_smoke.py`` in the JAX package and in the port, side by side on the
CPU, over training seeds.  For each path, seed and package: the reference
prior IS, the network trained with the recipe (batch 256, lr 0.003, a 16-d
observe embedding an observe; the state-space model lr 0.005), then IC at
the path's counts on the batched tier and on the interpreter tier
(``vectorized=False``), and with ``--traces`` also on the batched tier at
that count; each run's mean and ESS fraction against the limits.  The
state-space model's mean path must lie within max(0.06, 5 sd_t / sqrt(ESS))
of the RTS smoother at every step, and its ESS fraction above prior IS's at
the same count (10^6 traces).  Then, per path and package, the share of
seeds that met each criterion.  One seed's network is a draw, and this
shows how often the recipe meets each criterion in either package.

    python tests/event_ic_reference.py [--paths mvn_ff ...] [--seeds 8]
        [--traces N]

The MiniCaptcha paths (``mini_captcha_ff``, ``mini_captcha_lstm``) train
the JAX tests' CNN recipe (tests/test_inference.py:591-655) and judge the
MAP accuracy by ``post.mode`` over the six letters at 512 traces, above
0.8, from seeds 0-7.  The other seeds are the JAX test's and the ones
after it.  Prints one JSON line
a path, package and seed, then one a path and package with the shares.
Keep ``--traces`` to the feedforward paths: an LSTM at 10^6 particles
takes several GiB of host memory.
"""

import argparse
import json
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import functools  # noqa: E402

import numpy as np  # noqa: E402
import pyprob_tpu  # noqa: E402
import pyprob_tpu_torch  # noqa: E402
import pyprob_tpu.models  # noqa: E402
import pyprob_tpu_torch.models  # noqa: E402
import _torch_parity as P  # noqa: E402

# chip_smoke.py's state-space IC cell: T = 8, a = 0.9, y from synthesize(rng=0)
LGSS = {"num_steps": 8, "a": 0.9}
_lgss = pyprob_tpu.models.LinearGaussianStateSpace(**LGSS)
LGSS_OBSERVE = _lgss.observes(_lgss.synthesize(rng=0)[1])
LGSS_SMOOTHER = _lgss.kalman_smoother(list(LGSS_OBSERVE.values()))

# path: (model classes (JAX, port), observe, network, seed, training traces,
# batched count, interpreter count, reference prior IS count, limits)
PATHS = {
    "mvn_ff": ((P.JaxMVNLatent, P.TorchMVNLatent), P.MVN_LATENT_OBSERVE, "FEEDFORWARD", 7, 8192, 4096, 1024, 4096,
               {"mean": [4.0 / 2.04] * 2, "tol": 0.3, "ess_over_prior": 3.0}),
    "mvn_lstm": ((P.JaxMVNLatent, P.TorchMVNLatent), P.MVN_LATENT_OBSERVE, "LSTM", 7, 8192, 4096, 1024, 4096,
                 {"mean": [4.0 / 2.04] * 2, "tol": 0.3, "ess_over_prior": 3.0}),
    "dirichlet_ff": ((P.JaxDirichletLatent, P.TorchDirichletLatent), P.DIRICHLET_LATENT_OBSERVE, "FEEDFORWARD", 7,
                     3072, 1024, 1024, None, {"mean": [2 / 7, 2 / 7, 3 / 7], "tol": 0.08, "ess_floor": 0.3}),
    "dirichlet_lstm": ((P.JaxDirichletLatent, P.TorchDirichletLatent), P.DIRICHLET_LATENT_OBSERVE, "LSTM", 7,
                       3072, 1024, 1024, None, {"mean": [2 / 7, 2 / 7, 3 / 7], "tol": 0.08, "ess_floor": 0.3}),
    "lkj_ff": ((P.JaxLKJLatent, P.TorchLKJLatent), P.LKJ_LATENT_OBSERVE, "FEEDFORWARD", 0, 4096, 1024, 1024, 2048,
               {"tol": 0.15, "ess_floor": 0.05}),
    "lgss_ff": ((functools.partial(pyprob_tpu.models.LinearGaussianStateSpace, **LGSS),
                 functools.partial(pyprob_tpu_torch.models.LinearGaussianStateSpace, **LGSS)),
                LGSS_OBSERVE, "FEEDFORWARD", 0, 25_600, 1_000_000, None, 1_000_000,
                {"smoother": LGSS_SMOOTHER, "tol": 0.06, "ess_over_prior": 1.0, "learning_rate": 0.005}),
}


# the MiniCaptcha IC tests' recipe (tests/test_inference.py:591-655): a
# CNN2D5C embedding of the 28 x 28 glyph, batch 128, lr 0.002, LSTM dim 128;
# MAP accuracy by post.mode over the six letters at 512 traces each
CAPTCHA = {"traces": 8192, "batch_size": 128, "learning_rate": 0.002, "dim": 32, "lstm_dim": 128,
           "serve": 512, "accuracy": 0.8}
CAPTCHA_PATHS = {"mini_captcha_ff": "FEEDFORWARD", "mini_captcha_lstm": "LSTM"}


def run_captcha(pp, path, seed):
    """One seed of a MiniCaptcha path: {"batched_accuracy": [accuracy,
    limit, met]}."""
    pp.seed(seed)
    model = pp.models.MiniCaptcha()
    model.learn_inference_network(
        num_traces=CAPTCHA["traces"],
        observe_embeddings={"query_image": {"dim": CAPTCHA["dim"], "reshape": [1, 28, 28],
                                            "embedding": pp.ObserveEmbedding.CNN2D5C}},
        inference_network=getattr(pp.InferenceNetwork, CAPTCHA_PATHS[path]), batch_size=CAPTCHA["batch_size"],
        learning_rate_init=CAPTCHA["learning_rate"], lstm_dim=CAPTCHA["lstm_dim"])
    ic = pp.InferenceEngine.IMPORTANCE_SAMPLING_WITH_INFERENCE_NETWORK
    correct = [
        int(np.asarray(model.posterior_results(CAPTCHA["serve"], observe={"query_image": model.render(a)},
                                               vectorized=True, inference_engine=ic).mode)) == i
        for i, a in enumerate(model.alphabet)
    ]
    accuracy = sum(correct) / len(correct)
    return {"batched_accuracy": [accuracy, CAPTCHA["accuracy"], accuracy > CAPTCHA["accuracy"]]}


def criteria(post, n, base, limits):
    """{criterion: [value, limit, met]}: the mean within ``tol`` of the
    truth (or of the reference prior IS's), the ESS fraction above the
    floor (or above ``ess_over_prior`` times the reference's)."""
    mean = np.asarray(post.mean, np.float64).reshape(-1)
    ess = post.effective_sample_size / n
    floor = limits.get("ess_floor") or limits["ess_over_prior"] * base.effective_sample_size / base.length
    if "smoother" in limits:  # the state-space path: per step, within max(tol, 5 sd_t / sqrt(ESS))
        truth, variance = limits["smoother"]
        tol = np.maximum(limits["tol"], 5 * np.sqrt(variance / post.effective_sample_size))
        return {"mean": [mean.tolist(), truth.tolist(), bool((np.abs(mean - truth) <= tol).all())],
                "ess": [ess, floor, bool(ess > floor)]}
    truth = np.asarray(limits["mean"] if "mean" in limits else base.mean, np.float64).reshape(-1)
    return {"mean": [mean.tolist(), truth.tolist(), bool(np.abs(mean - truth).max() <= limits["tol"])],
            "ess": [ess, floor, bool(ess > floor)]}


def run(pp, model_class, path, seed, traces):
    _, observe, network, _, train_traces, n, n_interpreter, n_base, limits = PATHS[path]
    ic = pp.InferenceEngine.IMPORTANCE_SAMPLING_WITH_INFERENCE_NETWORK
    pp.seed(seed)
    model = model_class()
    base = model.posterior_results(n_base, observe=observe, vectorized=True) if n_base else None
    model.learn_inference_network(num_traces=train_traces, observe_embeddings={k: {"dim": 16} for k in observe},
                                  inference_network=getattr(pp.InferenceNetwork, network), batch_size=256,
                                  learning_rate_init=limits.get("learning_rate", 0.003))
    out = {}
    for tier, count, vectorized in (("batched", n, True), ("interpreter", n_interpreter, False),
                                    (f"batched_{traces}", traces, True)):
        if count:
            post = model.posterior_results(count, observe=observe, vectorized=vectorized, inference_engine=ic)
            out.update({f"{tier}_{k}": v for k, v in criteria(post, count, base, limits).items()})
    return out


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--paths", nargs="+", default=sorted(PATHS), choices=sorted(PATHS) + sorted(CAPTCHA_PATHS))
    parser.add_argument("--seeds", type=int, default=8)
    parser.add_argument("--traces", type=int, default=0)
    args = parser.parse_args()
    pyprob_tpu_torch.set_device("cpu")
    for pp in (pyprob_tpu, pyprob_tpu_torch):
        pp.set_verbosity(0)
    for path in args.paths:
        seeds = [(PATHS[path][3] if path in PATHS else 0) + i for i in range(args.seeds)]
        for package, pp in (("pyprob_tpu", pyprob_tpu), ("pyprob_tpu_torch", pyprob_tpu_torch)):
            met = {}
            for seed in seeds:
                if path in CAPTCHA_PATHS:
                    line = run_captcha(pp, path, seed)
                else:
                    line = run(pp, PATHS[path][0][package == "pyprob_tpu_torch"], path, seed, args.traces)
                for k, v in line.items():
                    met[k] = met.get(k, 0) + v[2]
                print(json.dumps({"path": path, "package": package, "seed": seed, **line}), flush=True)
            print(json.dumps({"path": path, "package": package, "seeds": seeds,
                              "share_met": {k: m / len(seeds) for k, m in met.items()}}), flush=True)


if __name__ == "__main__":
    main()
