"""The trained Marsaglia arm's ESS over training seeds and serving draws.

Trains ``GaussianUnknownMeanMarsagliaRejection`` with bench.py's Marsaglia
recipe as ``chip_smoke.py`` runs it (lstm 128, batch 256, lr 0.004, 32-d
observe embeddings, K = 10, EMA 0.9; two calls of 12,800 traces) once per
seed, serves it ``--servings`` times with guided IS over ``--traces``
traces, and prints one JSON line per seed with each serving's ESS
fraction.  With ``--interpreter`` it runs bench.py's own while-loop arm
instead, as chip_smoke.py's interpreter phases do: ``GaussianUnknownMeanMarsaglia``
trained in one call of 25,600 traces on the interpreter tier, then each
serving 1,000 lockstep traces to warm up and ``--traces`` (default 12,000)
served with ``vectorized=False``.  It runs pyprob_tpu_torch on
``--device``.  Run from the repository root, e.g.

    python3 marsaglia_seeds.py --device cuda --seeds 0,1,2,3,4,5,6,7
    python3 marsaglia_seeds.py --device cpu --traces 100000 --servings 3
    python3 marsaglia_seeds.py --device cuda --interpreter --seeds 123 --servings 8
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
    parser.add_argument("--traces", type=int, default=None)
    parser.add_argument("--servings", type=int, default=1)
    parser.add_argument("--interpreter", action="store_true")
    opts = parser.parse_args()
    import torch

    torch.set_num_threads(4)
    import pyprob_tpu_torch as pp
    from pyprob_tpu_torch.models import GaussianUnknownMeanMarsaglia, GaussianUnknownMeanMarsagliaRejection

    pp.set_device(opts.device)
    pp.set_verbosity(0)
    engine = pp.InferenceEngine.IMPORTANCE_SAMPLING_WITH_INFERENCE_NETWORK
    traces = opts.traces or (12_000 if opts.interpreter else 1_000_000)

    def serve(model):
        if opts.interpreter:
            model.posterior_results(1000, observe=OBSERVE, vectorized=False, inference_engine=engine)
        return model.posterior_results(
            traces, observe=OBSERVE, vectorized=not opts.interpreter, inference_engine=engine
        ).effective_sample_size / traces

    for seed in (int(s) for s in opts.seeds.split(",")):
        pp.seed(seed)
        if opts.interpreter:
            model = GaussianUnknownMeanMarsaglia()
            model.learn_inference_network(num_traces=25_600, **recipe(pp))
        else:
            model = GaussianUnknownMeanMarsagliaRejection()
            for _ in range(2):
                model.learn_inference_network(num_traces=12_800, **recipe(pp))
        ess = [serve(model) for _ in range(opts.servings)]
        print(json.dumps({
            "device": opts.device, "seed": seed, "interpreter": opts.interpreter, "traces": traces,
            "ess_fraction": ess, "final_loss": float(model._inference_network._history_train_loss[-1]),
        }), flush=True)


if __name__ == "__main__":
    main()
