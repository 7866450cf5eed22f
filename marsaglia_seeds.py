"""The trained Marsaglia arm's ESS over training seeds.

Trains ``GaussianUnknownMeanMarsagliaRejection`` with bench.py's Marsaglia
recipe as ``chip_smoke.py`` runs it (lstm 128, batch 256, lr 0.004, 32-d
observe embeddings, K = 10, EMA 0.9; two calls of 12,800 traces) once per
seed, serves it ``--servings`` times with guided IS over ``--traces``
traces, and prints one JSON line per seed with each serving's ESS
fraction.  It runs pyprob_tpu_torch on ``--device``.  Run from the
repository root, e.g.

    python3 marsaglia_seeds.py --device cuda --seeds 0,1,2,3,4,5,6,7
    python3 marsaglia_seeds.py --device cpu --traces 100000 --servings 3
"""

import argparse
import json

OBSERVE = {"obs0": 8.0, "obs1": 9.0}


def recipe(pp):
    return dict(
        observe_embeddings={"obs0": {"dim": 32}, "obs1": {"dim": 32}},
        inference_network=pp.InferenceNetwork.LSTM,
        batch_size=256,
        learning_rate_init=0.004,
        lstm_dim=128,
        proposal_mixture_components=10,
        ema_decay=0.9,
    )


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--seeds", default="0,1,2,3,4,5,6,7")
    parser.add_argument("--traces", type=int, default=1_000_000)
    parser.add_argument("--servings", type=int, default=1)
    opts = parser.parse_args()
    import torch

    torch.set_num_threads(4)
    import pyprob_tpu_torch as pp
    from pyprob_tpu_torch.models import GaussianUnknownMeanMarsagliaRejection

    pp.set_device(opts.device)
    pp.set_verbosity(0)
    engine = pp.InferenceEngine.IMPORTANCE_SAMPLING_WITH_INFERENCE_NETWORK
    for seed in (int(s) for s in opts.seeds.split(",")):
        pp.seed(seed)
        model = GaussianUnknownMeanMarsagliaRejection()
        for _ in range(2):
            model.learn_inference_network(num_traces=12_800, **recipe(pp))
        ess = [
            model.posterior_results(
                opts.traces, observe=OBSERVE, vectorized=True, inference_engine=engine
            ).effective_sample_size / opts.traces
            for _ in range(opts.servings)
        ]
        print(json.dumps({
            "device": opts.device, "seed": seed, "traces": opts.traces, "ess_fraction": ess,
            "final_loss": float(model._inference_network._history_train_loss[-1]),
        }), flush=True)


if __name__ == "__main__":
    main()
