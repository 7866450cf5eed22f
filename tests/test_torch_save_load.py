"""Saving and loading the port's inference networks
(``InferenceNetwork._save`` / ``_load``, ``Model.save_inference_network``
/ ``load_inference_network``), on the CPU.

A round trip of each network class (feedforward and LSTM, trained a few
steps on GUM with an EMA average) keeps the parameters, the EMA, the
optimizer's state, the counters and the head metadata equal; the loaded
network serves the same seeded posterior, to the bit, and training
continued from it lands on the original's continued parameters bit for
bit.  ``save_file_name_prefix`` writes the files the JAX package writes
under the same names (time stamps masked); a file cut short raises
RuntimeError, and so does a JAX package file; the pickle names no
``torch`` or port class, so it loads where the card is missing.
"""

import io
import pickle
import re
import tarfile

import numpy as np
import pytest
import torch

import pyprob_tpu
import pyprob_tpu_torch as pp
from pyprob_tpu_torch.models import GaussianUnknownMean
from pyprob_tpu_torch.nn import InferenceNetwork, InferenceNetworkFeedForward, InferenceNetworkLSTM
from pyprob_tpu_torch.nn.inference_network import _CHECKPOINT_MEMBER
from pyprob_tpu_torch.nn.layers import tensor_leaves
from pyprob_tpu_torch.util import InferenceEngine as TEngine, InferenceNetwork as TNet

from _torch_parity import OBSERVE, JaxGUM, TorchGUM

torch.set_num_threads(2)
IC = TEngine.IMPORTANCE_SAMPLING_WITH_INFERENCE_NETWORK


@pytest.fixture(autouse=True)
def _port_on_cpu():
    pp.set_device("cpu")
    pp.set_verbosity(1)
    yield


def _train_kwargs(network):
    return dict(
        observe_embeddings={"obs0": {"dim": 8}, "obs1": {"dim": 8}},
        inference_network=network,
        batch_size=64,
        learning_rate_init=0.01,
        learning_rate_scheduler_type=pp.LearningRateScheduler.POLY1,
        num_traces_end=2048,
        lstm_dim=16,
        ema_decay=0.9,
    )


@pytest.fixture(scope="module", params=[TNet.FEEDFORWARD, TNet.LSTM], ids=["feedforward", "lstm"])
def saved(request, tmp_path_factory):
    """A GUM network trained 512 traces, and the file it was saved to."""
    pp.set_device("cpu")
    pp.seed(1)
    model = GaussianUnknownMean()
    model.learn_inference_network(num_traces=512, **_train_kwargs(request.param))
    path = tmp_path_factory.mktemp("net") / "gum.network"
    model.save_inference_network(str(path))
    return model, str(path), request.param


def _state_equal(a, b):
    sa, sb = a.state_dict(), b.state_dict()
    assert sa["param_groups"] == sb["param_groups"]
    assert sa["state"].keys() == sb["state"].keys()
    for k in sa["state"]:
        for key, v in sa["state"][k].items():
            assert torch.equal(v, sb["state"][k][key]), (k, key)


def test_round_trip_keeps_everything(saved):
    model, path, kind = saved
    loaded = GaussianUnknownMean()
    loaded.load_inference_network(path)
    a, b = model._inference_network, loaded._inference_network
    assert type(b) is {TNet.FEEDFORWARD: InferenceNetworkFeedForward, TNet.LSTM: InferenceNetworkLSTM}[kind]
    assert b._model is loaded and b.device == torch.device("cpu")
    for x, y in zip(tensor_leaves(a._params), tensor_leaves(b._params)):
        assert torch.equal(x, y) and y.requires_grad
    for x, y in zip(tensor_leaves(a._ema_params), tensor_leaves(b._ema_params)):
        assert torch.equal(x, y)
    assert len(tensor_leaves(a._params)) == len(tensor_leaves(b._params)) > 4
    _state_equal(a._optimizer, b._optimizer)
    for key in (
        "_ema_decay", "_ema_steps", "_total_train_traces", "_total_train_iterations",
        "_total_train_traces_end", "_head_train_iterations", "_head_meta", "_observe_meta",
        "_observe_embedding_dim", "_optimizer_type", "_learning_rate_scheduler_type",
        "_learning_rate_init", "_history_train_loss", "_loss_min", "_proposal_mixture_components",
    ):
        assert getattr(a, key) == getattr(b, key), key
    assert b._total_train_iterations == 8 and b._updates == 1


def test_loaded_network_serves_the_same_seeded_posterior(saved):
    model, path, _ = saved
    loaded = GaussianUnknownMean()
    loaded.load_inference_network(path)
    posts = []
    for m in (model, loaded):
        pp.seed(5)
        posts.append(m.posterior_results(2000, observe=OBSERVE, vectorized=True, inference_engine=IC))
    a, b = posts
    assert float(a.mean) == float(b.mean) and a.effective_sample_size == b.effective_sample_size


def test_continued_training_is_bit_equal(saved):
    model, path, kind = saved
    copies = []
    for _ in range(2):
        m = GaussianUnknownMean()
        m.load_inference_network(path)
        copies.append(m)
    for m in copies:
        pp.seed(9)
        m.learn_inference_network(num_traces=256, **_train_kwargs(kind))
    a, b = (m._inference_network for m in copies)
    assert a._total_train_iterations == 12
    for x, y in zip(tensor_leaves(a._params) + tensor_leaves(a._ema_params),
                    tensor_leaves(b._params) + tensor_leaves(b._ema_params)):
        assert torch.equal(x, y)
    # and they moved away from the saved parameters
    saved_net = model._inference_network
    assert any(not torch.equal(x, y) for x, y in zip(tensor_leaves(a._params), tensor_leaves(saved_net._params)))


def test_a_file_cut_short_raises(saved, tmp_path):
    _, path, _ = saved
    data = open(path, "rb").read()
    for cut in (len(data) // 2, 40):
        short = tmp_path / f"short{cut}.network"
        short.write_bytes(data[:cut])
        with pytest.raises(RuntimeError, match="Cannot load inference network"):
            InferenceNetwork._load(str(short))


class _Recorder(pickle.Unpickler):
    modules = set()

    def find_class(self, module, name):
        _Recorder.modules.add(module)
        return super().find_class(module, name)


def test_the_pickle_holds_no_torch_object(saved):
    _, path, _ = saved
    with tarfile.open(path, "r:gz") as tar:
        assert tar.getnames() == [_CHECKPOINT_MEMBER]
        raw = tar.extractfile(_CHECKPOINT_MEMBER).read()
    _Recorder.modules = set()
    data = _Recorder(io.BytesIO(raw)).load()
    assert not any(m.split(".")[0] in ("torch", "pyprob_tpu_torch", "pyprob_tpu") for m in _Recorder.modules)
    assert {m.split(".")[0] for m in _Recorder.modules} <= {"numpy", "builtins", "collections"}
    assert data["class_name"] in ("InferenceNetworkFeedForward", "InferenceNetworkLSTM")
    assert isinstance(data["optimizer_type"], str)


def _names(directory):
    """The file names in ``directory``, their time stamps masked."""
    return sorted({re.sub(r"_\d{8}_\d{6}_", "_TS_", p.name) for p in directory.iterdir()})


def test_save_file_name_prefix_writes_the_jax_packages_files(tmp_path):
    kw = dict(
        num_traces=96, observe_embeddings={"obs0": {"dim": 4}, "obs1": {"dim": 4}},
        batch_size=32, save_every_sec=0,
    )
    dirs = {"jax": tmp_path / "jax", "port": tmp_path / "port"}
    for d in dirs.values():
        d.mkdir()
    pyprob_tpu.seed(0)
    jm = JaxGUM()
    jm.learn_inference_network(save_file_name_prefix=str(dirs["jax"] / "gum"), **kw)
    pp.seed(0)
    tm = TorchGUM()
    tm.learn_inference_network(save_file_name_prefix=str(dirs["port"] / "gum"), **kw)
    assert _names(dirs["port"]) == _names(dirs["jax"]) == ["gum_TS_traces_64.network", "gum_TS_traces_96.network"]
    loaded = InferenceNetwork._load(str(sorted(dirs["port"].iterdir())[-1]))
    assert loaded._total_train_traces == 96
    # layer pre-generation saves after each batch that grew the layers
    for net, d in (
        (pyprob_tpu.nn.InferenceNetworkFeedForward(model=jm, observe_embeddings={"obs0": {}, "obs1": {}}), "jax_pre"),
        (InferenceNetworkFeedForward(model=tm, observe_embeddings={"obs0": {}, "obs1": {}}), "port_pre"),
    ):
        dirs[d] = tmp_path / d
        dirs[d].mkdir()
        model = jm if d == "jax_pre" else tm
        net._pre_generate_layers(model.prior(num_traces=4).get_values(), save_file_name_prefix=str(dirs[d] / "gum"))
    assert _names(dirs["port_pre"]) == _names(dirs["jax_pre"]) == ["gum_00000000_pre_generated.network"]
    # a JAX package file is refused by name
    with pytest.raises(RuntimeError, match="JAX package"):
        InferenceNetwork._load(str(next(dirs["jax"].iterdir())))
    assert np.isfinite(loaded._history_train_loss).all()
