"""Offline datasets, offline training, validation and keep_best in the port,
on the CPU.

Mirrors of the JAX package's tests with the same models, sizes and limits:
tests/test_dataset.py (the online dataset, a saved dataset read back, the
hash-sorted indices, the batch samplers, four ranks' disjoint equal
partitions, two nodes' halves of ``save_sorted``, sub-batches),
tests/test_migration_surface.py:268-296 (the file-handle LRU: bounded,
every file readable; as in pyprob, ``close`` closes the handle that every
instance of the file shares, and the next read reopens it; no lock),
tests/test_train.py:90-128 (ADAM_LARC with POLY2 ends at 0.0025 within
1e-4; training from a saved dataset serves GUM's posterior mean within
0.8 at an ESS above 5 %) and tests/test_ema_keep_best.py:133-206 (the best
probe restored bit for bit, the final state competing, the model-level
ESS probe, ValueError without a metric).

Against the JAX package on the same traces (the JAX dataset's files
carried across as numpy by ``_carry_dataset``), with a carried network
trained at learning rate 0 (the parameters stay the initial ones): the
first step's training loss on a one-batch dataset and the validation loss
of ``dataset_valid`` against the JAX package's losses of the same batches
in its sampler's order, within 1e-5 relative, for the LSTM and feedforward
networks on GUM and the LSTM on the while-loop Marsaglia model (several
trace types: the gather-table loss).
"""

import math
import os

import numpy as np
import pytest
import torch

import pyprob_tpu
import pyprob_tpu_torch as pp
from pyprob_tpu.nn.dataset import OfflineDataset as JaxOfflineDataset
from pyprob_tpu_torch.distributions import Normal, Uniform
from pyprob_tpu_torch.nn import (
    Batch,
    DistributedTraceBatchSampler,
    OfflineDataset,
    OfflineDatasetFile,
    OnlineDataset,
    TraceBatchSampler,
    TraceSampler,
    prune_trace,
)
from pyprob_tpu_torch.nn.dataset import _write_traces
from pyprob_tpu_torch.nn.layers import tensor_leaves
from pyprob_tpu_torch.models import GaussianUnknownMean

from _torch_parity import (
    OBSERVE, JaxGUM, JaxMarsagliaWhile, TorchGUM, TorchMarsagliaWhile, carry, carry_ff, jax_ff_network,
    jax_network, port_trace,
)

torch.set_num_threads(2)
OBS_EMB = {"obs0": {"dim": 8}, "obs1": {"dim": 8}}
IC = pp.InferenceEngine.IMPORTANCE_SAMPLING_WITH_INFERENCE_NETWORK


@pytest.fixture(autouse=True)
def _port_on_cpu():
    pp.set_device("cpu")
    pp.seed(0)
    yield


class VariableLengthModel(pp.Model):
    def forward(self):
        n = 0
        while True:
            x = pp.sample(Uniform(0.0, 1.0))
            n += 1
            if float(x) < 0.5 or n >= 4:
                break
        pp.observe(Normal(float(n), 1.0), name="obs0")
        return n


def _make_dataset(tmp_path, model, num_traces=200, per_file=50):
    d = str(tmp_path / "dataset")
    model.save_dataset(d, num_traces=num_traces, num_traces_per_file=per_file)
    return d


def test_online_dataset():
    ds = OnlineDataset(GaussianUnknownMean())
    t = ds[0]
    assert t.length_controlled == 1 and t.named_variables["obs0"].value is not None
    assert len(ds.next_batch(32)) == 32


def test_offline_dataset_roundtrip(tmp_path):
    ds = OfflineDataset(_make_dataset(tmp_path, GaussianUnknownMean()))
    assert len(ds) == 200 and len(os.listdir(ds._dataset_dir)) == 5  # four files and the hashes
    t = ds[0]
    assert t.length_controlled == 1 and t.variables_controlled[0].distribution is not None
    assert t.variables_controlled[0].distribution.loc.device.type == "cpu"
    with pytest.raises(IndexError):
        ds[200]


def test_offline_sorted_indices_and_samplers(tmp_path):
    ds = OfflineDataset(_make_dataset(tmp_path, VariableLengthModel()))
    hashes = [ds[int(i)].trace_hash() for i in ds.sorted_indices]
    assert hashes == sorted(hashes) and list(TraceSampler(ds)) == ds.sorted_indices
    assert OfflineDataset(ds._dataset_dir).sorted_indices == ds.sorted_indices  # read from pyprob_hashes
    sampler = TraceBatchSampler(ds, batch_size=16)
    assert sorted(i for batch in sampler for i in batch) == list(range(len(ds)))
    type_counts = [len({ds[int(i)].trace_hash() for i in batch}) for batch in sampler]
    assert np.mean(type_counts) < 3
    world, all_batches = 4, {}
    for rank in range(world):
        all_batches[rank] = list(DistributedTraceBatchSampler(ds, batch_size=8, rank=rank, world_size=world))
    for r1 in range(world):
        for r2 in range(r1 + 1, world):
            assert {i for b in all_batches[r1] for i in b}.isdisjoint({i for b in all_batches[r2] for i in b})
    assert len({len(v) for v in all_batches.values()}) == 1
    with pytest.raises(ValueError):
        DistributedTraceBatchSampler(ds, batch_size=8, rank=4, world_size=4)


def test_multinode_save_sorted(tmp_path):
    ds = OfflineDataset(_make_dataset(tmp_path, VariableLengthModel()))
    sorted_dir = str(tmp_path / "sorted")
    num_files = ds.save_sorted(sorted_dir, num_traces_per_file=50, begin_file_index=0, end_file_index=2)
    ds.save_sorted(sorted_dir, num_traces_per_file=50, begin_file_index=2, end_file_index=num_files)
    ds2 = OfflineDataset(sorted_dir)
    assert len(ds2) == len(ds)
    hashes = [ds2[i].trace_hash() for i in range(len(ds2))]
    assert hashes == sorted(hashes)


def test_batch_sub_batches():
    m = VariableLengthModel()
    batch = Batch([prune_trace(m.sample()) for _ in range(40)])
    assert batch.size == 40 and sum(len(s) for s in batch.sub_batches) == 40
    for sub in batch.sub_batches:
        assert len({t.trace_hash() for t in sub}) == 1


def test_offline_dataset_file_lru_cache(tmp_path):
    from pyprob_tpu_torch.concurrency import Shelf

    old_cap = OfflineDatasetFile.cache_capacity
    OfflineDatasetFile.cache.clear()
    OfflineDatasetFile.cache_capacity = 2
    try:
        files = []
        for i in range(4):
            fn = str(tmp_path / f"f{i}")
            s = Shelf(fn)
            s["num_traces"] = 1
            s["trace_0"] = float(i)
            s.close()
            files.append(OfflineDatasetFile(fn))
        assert len(OfflineDatasetFile.cache) <= 2
        for i, f in enumerate(files):
            assert f[0] == float(i) and len(f) == 1
        assert len(OfflineDatasetFile.cache) <= 2
        # pyprob's behaviour: close() closes the handle every instance of
        # the file shares; another instance's next read reopens it
        twin = OfflineDatasetFile(files[3]._file_name)
        files[3].close()
        assert files[3]._file_name not in OfflineDatasetFile.cache and twin[0] == 3.0
        for f in files + [twin]:
            f.close()
        assert len(OfflineDatasetFile.cache) == 0
    finally:
        OfflineDatasetFile.cache_capacity = old_cap
        OfflineDatasetFile.cache.clear()


def test_adam_larc_poly2_schedule():
    m = GaussianUnknownMean()
    m.learn_inference_network(
        num_traces=2048, num_traces_end=2048, observe_embeddings=OBS_EMB, batch_size=256,
        optimizer_type=pp.Optimizer.ADAM_LARC, learning_rate_init=0.1, learning_rate_end=0.0025,
        learning_rate_scheduler_type=pp.LearningRateScheduler.POLY2,
    )
    net = m._inference_network
    assert net._total_train_traces >= 2048
    assert np.isclose(net.learning_rate, 0.0025, atol=1e-4)


def test_offline_dataset_training(tmp_path):
    dataset_dir, valid_dir = str(tmp_path / "dataset"), str(tmp_path / "valid")
    m = GaussianUnknownMean()
    m.save_dataset(dataset_dir, num_traces=2000, num_traces_per_file=500)
    m.save_dataset(valid_dir, num_traces=256, num_traces_per_file=256)
    m2 = GaussianUnknownMean()
    m2.learn_inference_network(num_traces=4000, observe_embeddings=OBS_EMB, dataset_dir=dataset_dir,
                               dataset_valid_dir=valid_dir, valid_every=1000, batch_size=256,
                               learning_rate_init=0.005, pre_generate_layers=True)
    net = m2._inference_network
    assert net._total_train_traces >= 4000 and net._layers_pre_generated
    assert 2 <= len(net._history_valid_loss) == len(net._history_valid_loss_trace)
    post = m2.posterior_results(num_traces=2000, observe=OBSERVE, inference_engine=IC)
    assert abs(float(post.mean) - 7.25) < 0.8
    assert post.effective_sample_size > 0.05 * 2000
    path = str(tmp_path / "net.network")
    m2.save_inference_network(path)
    m3 = GaussianUnknownMean()
    m3.load_inference_network(path)
    assert m3._inference_network._history_valid_loss == net._history_valid_loss


def _carry_dataset(jax_dir, port_dir):
    """The port's dataset files holding a JAX package dataset's traces (the
    values as numpy, the distributions rebuilt on the CPU), file for file."""
    from pyprob_tpu.nn.dataset import OfflineDatasetFile as JaxFile

    os.makedirs(port_dir)
    for name in sorted(os.listdir(jax_dir)):
        if not name.endswith("_hashes"):
            f = JaxFile(os.path.join(jax_dir, name))
            _write_traces(os.path.join(port_dir, name), [port_trace(f[i]) for i in range(len(f))])
            f.close()
    return OfflineDataset(port_dir)


@pytest.mark.parametrize("model,network", [("gum", "lstm"), ("gum", "ff"), ("marsaglia", "lstm")])
def test_offline_and_validation_losses_match(model, network, tmp_path):
    jm, tm = {"gum": (JaxGUM, TorchGUM), "marsaglia": (JaxMarsagliaWhile, TorchMarsagliaWhile)}[model]
    pyprob_tpu.seed(3)
    jm().save_dataset(str(tmp_path / "jtrain"), num_traces=32, num_traces_per_file=32)
    jm().save_dataset(str(tmp_path / "jvalid"), num_traces=48, num_traces_per_file=24)
    jtrain, jvalid = JaxOfflineDataset(str(tmp_path / "jtrain")), JaxOfflineDataset(str(tmp_path / "jvalid"))
    ttrain = _carry_dataset(str(tmp_path / "jtrain"), str(tmp_path / "ttrain"))
    tvalid = _carry_dataset(str(tmp_path / "jvalid"), str(tmp_path / "tvalid"))
    assert ttrain.sorted_indices == [int(i) for i in jtrain.sorted_indices]
    vectorized = None if model == "gum" else False
    make = jax_network if network == "lstm" else jax_ff_network
    jnet = make(jm(), vectorized=vectorized)
    # the layers every stored trace needs, grown before the weights are carried
    jnet._pre_generate_layers(jvalid)
    jnet._pre_generate_layers(jtrain)
    tnet = (carry if network == "lstm" else carry_ff)(jnet, tm())
    tnet._layers_pre_generated = True
    tnet.optimize(dataset=ttrain, dataset_valid=tvalid, num_traces=32, batch_size=32, learning_rate_init=0.0,
                  learning_rate_end=0.0, valid_every=1)
    # the JAX package's losses of the same batches (its optimize takes the
    # first step's loss and then the mean over the validation batches)
    from pyprob_tpu.nn.dataset import Batch as JaxBatch, TraceBatchSampler as JaxSampler

    train_ref = jnet._loss(JaxBatch([jtrain[int(i)] for i in jtrain.sorted_indices]))[1]
    valid = [jnet._loss(JaxBatch([jvalid[int(i)] for i in idx]))[1]
             for idx in JaxSampler(jvalid, batch_size=32, shuffle_batches=False)]
    for got, ref in ((tnet._history_train_loss, train_ref), (tnet._history_valid_loss, sum(valid) / len(valid))):
        assert len(got) == 1 and math.isfinite(got[0])
        np.testing.assert_allclose(got[0], ref, rtol=1e-5)


def _train(m, num_traces=1024, **kw):
    kw.setdefault("learning_rate_init", 0.005)
    m.learn_inference_network(num_traces=num_traces, observe_embeddings=OBS_EMB,
                              inference_network=pp.InferenceNetwork.LSTM, batch_size=64, lstm_dim=16, **kw)


def _equal(a, b):
    return all(np.array_equal(x, y) for x, y in zip(tensor_leaves(a), tensor_leaves(b)))


def test_keep_best_restores_best_probed_checkpoint():
    pp.seed(15)
    m = GaussianUnknownMean()
    script = [0.1, 0.9, 0.3, 0.2, 0.05, 0.0, 0.0, 0.0, 0.0, 0.0]
    seen = []

    def metric(net):
        seen.append(net.snapshot_params())
        return script[len(seen) - 1]

    _train(m, num_traces=1024, keep_best=True, keep_best_every=256, keep_best_metric=metric, ema_decay=0.9)
    net = m._inference_network
    assert len(seen) >= 3
    best = seen[int(np.argmax(script[: len(seen)]))]
    params = [t.detach().numpy() for t in tensor_leaves(net._params)]
    assert all(np.array_equal(x, y) for x, y in zip(params, tensor_leaves(best["params"])))
    ema = [t.detach().numpy() for t in tensor_leaves(net._ema_params)]
    assert all(np.array_equal(x, y) for x, y in zip(ema, tensor_leaves(best["ema_params"])))
    assert [mv for _, mv in net._keep_best_history] == script[: len(seen)]
    # a snapshot is a copy: later training leaves it as it was
    before = [a.copy() for a in tensor_leaves(best["params"])]
    _train(m, num_traces=128)
    assert all(np.array_equal(x, y) for x, y in zip(before, tensor_leaves(best["params"])))


def test_keep_best_final_state_competes():
    pp.seed(16)
    m = GaussianUnknownMean()
    calls = []

    def metric(net):
        calls.append(net.snapshot_params())
        return float(len(calls))

    _train(m, num_traces=512, keep_best=True, keep_best_every=256, keep_best_metric=metric)
    params = [t.detach().numpy() for t in tensor_leaves(m._inference_network._params)]
    assert all(np.array_equal(x, y) for x, y in zip(params, tensor_leaves(calls[-1]["params"])))


def test_keep_best_model_level_ess_probe():
    pp.seed(17)
    m = GaussianUnknownMean()
    _train(m, num_traces=768, keep_best=True, keep_best_every=256, keep_best_observe=OBSERVE,
           keep_best_num_traces=400)
    hist = m._inference_network._keep_best_history
    assert len(hist) >= 2 and all(0.0 <= v <= 1.0 for _, v in hist)
    assert m._inference_network._keep_best_metric == max(v for _, v in hist)


def test_keep_best_requires_metric_or_valid():
    pp.seed(18)
    with pytest.raises(ValueError, match="keep_best_metric"):
        _train(GaussianUnknownMean(), num_traces=256, keep_best=True)


def test_keep_best_by_validation_loss(tmp_path):
    """With dataset_valid and no metric, keep_best probes the negative
    validation loss of the serving parameters (the EMA average here) and
    restores the best probe's snapshot, EMA included, bit for bit."""
    pp.seed(19)
    m = GaussianUnknownMean()
    m.save_dataset(str(tmp_path / "train"), num_traces=1024, num_traces_per_file=512)
    m.save_dataset(str(tmp_path / "valid"), num_traces=128, num_traces_per_file=128)
    m.learn_inference_network(num_traces=1024, observe_embeddings=OBS_EMB, batch_size=128,
                              dataset_dir=str(tmp_path / "train"), dataset_valid_dir=str(tmp_path / "valid"),
                              learning_rate_init=0.01, ema_decay=0.9, keep_best=True, keep_best_every=256)
    net = m._inference_network
    hist = net._keep_best_history
    assert len(hist) == 5 and all(v < 0 for _, v in hist)
    assert net._keep_best_metric == max(v for _, v in hist)
    for tree, ref in ((net._params, net._keep_best_snapshot["params"]),
                      (net._ema_params, net._keep_best_snapshot["ema_params"])):
        assert all(np.array_equal(t.detach().numpy(), a) for t, a in zip(tensor_leaves(tree), tensor_leaves(ref)))
