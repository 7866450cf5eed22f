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
