"""The number of optimizer steps a ``learn_inference_network`` call takes,
and the last file ``save_file_name_prefix`` writes, in both packages: a
model that runs only on the interpreter tier does not count the first
batch toward ``num_traces`` (25,600 traces at batch 256 train 101 steps,
25,856 traces), one that runs batched does (100 steps, 25,600).  The test
trains 768 traces at batch 256 (4 steps and 3), to stay at a few
seconds; the rule is the same."""

import re

import pytest
import torch

import pyprob_tpu
import pyprob_tpu_torch as pp

torch.set_num_threads(2)


def _body(lib, branch):
    x = lib.sample(lib.distributions.Normal(0.0, 1.0))
    if branch and float(x) > 100.0:  # never taken; it keeps the model off the batched tier
        x = x + 1.0
    lib.observe(lib.distributions.Normal(x, 1.0), name="obs0")
    return x


@pytest.mark.parametrize("tier,steps", [("interpreter", 4), ("batched", 3)])
def test_steps_and_last_file_name_match_the_jax_package(tier, steps, tmp_path):
    branch = tier == "interpreter"
    names = {}
    for lib in (pyprob_tpu, pp):
        class M(lib.Model):
            def forward(self):
                return _body(lib, branch)

        if lib is pp:
            pp.set_device("cpu")
        lib.seed(0)
        model = M()
        d = tmp_path / lib.__name__
        d.mkdir()
        model.learn_inference_network(
            num_traces=768, observe_embeddings={"obs0": {"dim": 4}}, batch_size=256,
            proposal_mixture_components=2, save_file_name_prefix=str(d / "m"), save_every_sec=1e9,
        )
        net = model._inference_network
        assert net._total_train_iterations == steps, lib.__name__
        assert net._total_train_traces == 256 * steps, lib.__name__
        files = [re.sub(r"_\d{8}_\d{6}_", "_TS_", f.name) for f in d.iterdir()]
        names[lib.__name__] = max(files, key=lambda f: int(re.search(r"traces_(\d+)", f).group(1)))
    assert names["pyprob_tpu"] == names["pyprob_tpu_torch"] == f"m_TS_traces_{256 * steps}.network"


def _never_vectorize_model(lib, calls):
    class M(lib.Model):
        _never_vectorize = True

        def forward(self):
            calls.append(1)
            return _body(lib, False)

    return M()


@pytest.mark.parametrize("vectorized", [None, True])
def test_never_vectorize_runs_on_the_interpreter_tier(vectorized):
    """A model marked ``_never_vectorize`` (a GUM-like body that would run
    batched) never enters the batched tier, with vectorized=None and with
    vectorized=True, in both packages: its forward runs once a trace."""
    for lib in (pyprob_tpu, pp):
        if lib is pp:
            pp.set_device("cpu")
        lib.seed(0)
        calls = []
        model = _never_vectorize_model(lib, calls)
        post = model.posterior_results(20, observe={"obs0": 0.5}, vectorized=vectorized)
        assert len(calls) == 20, (lib.__name__, len(calls))
        assert post.length == 20
        calls.clear()
        prior = model.prior_results(12, vectorized=vectorized)
        assert len(calls) == 12 and prior.length == 12, lib.__name__


def test_never_vectorize_trains_as_the_interpreter_tier(tmp_path):
    """Training a ``_never_vectorize`` model at 768 traces and batch 256 takes
    the interpreter tier's step count (4) and last file name in both
    packages, and never runs forward batched."""
    names = {}
    for lib in (pyprob_tpu, pp):
        if lib is pp:
            pp.set_device("cpu")
        lib.seed(0)
        calls = []
        model = _never_vectorize_model(lib, calls)
        d = tmp_path / lib.__name__
        d.mkdir()
        model.learn_inference_network(
            num_traces=768, observe_embeddings={"obs0": {"dim": 4}}, batch_size=256,
            proposal_mixture_components=2, save_file_name_prefix=str(d / "m"), save_every_sec=1e9,
        )
        net = model._inference_network
        assert net._total_train_iterations == 4, lib.__name__
        assert net._total_train_traces == 1024, lib.__name__
        # every trace drawn one forward call at a time (the layer
        # pre-generation and first batch included)
        assert len(calls) >= 1024, (lib.__name__, len(calls))
        files = [re.sub(r"_\d{8}_\d{6}_", "_TS_", f.name) for f in d.iterdir()]
        names[lib.__name__] = max(files, key=lambda f: int(re.search(r"traces_(\d+)", f).group(1)))
    assert names["pyprob_tpu"] == names["pyprob_tpu_torch"] == "m_TS_traces_1024.network"
