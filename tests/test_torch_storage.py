"""The port's storage: the shelf, its codec, AddressDictionary, the
Empirical file and concatenation modes and file-backed results, on the CPU.

Mirrors of the JAX package's tests (tests/test_distributions.py:308-362,
tests/test_distributions_batched.py:137-160, tests/test_model.py:57-68)
with the same values and limits, and beyond them: a shelf transaction
commits as one and rolls back on an exception; the codec round-trips
traces (their distributions, wrappers included, as CPU tensors) and
refuses anything but numpy arrays and plain data; array values of more
than one block reopen equal to the bit, with the stored ESS; and the
results of the batched tier, the interpreter and lockstep written to a
file equal the same seed's results in memory, values and log weights to
the bit, mean and ESS equal.
"""

import math
import pickle

import numpy as np
import pytest
import torch

import pyprob_tpu_torch as pp
from pyprob_tpu_torch import concurrency
from pyprob_tpu_torch.concurrency import ConcurrentShelf, Shelf
from pyprob_tpu_torch.distributions import Censored, Empirical, EmpiricalType, Mixture, Normal
from pyprob_tpu_torch.models import GaussianUnknownMean, GaussianUnknownMeanMarsaglia

from _torch_parity import OBSERVE

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _port_on_cpu():
    pp.set_device("cpu")
    pp.seed(0)
    yield


def test_shelf_transaction_commits_and_rolls_back(tmp_path):
    fn = str(tmp_path / "shelf")
    s = Shelf(fn)
    with s.transaction():
        for i in range(10):
            s[f"k{i}"] = np.arange(i)
        with s.transaction():  # nested blocks join the outer one
            s["nested"] = {"a": [1, 2.5, "x"]}
    with pytest.raises(RuntimeError):
        with s.transaction():
            s["lost"] = 1
            raise RuntimeError("abort")
    s.close()
    r = ConcurrentShelf(fn)
    assert len(r) == 11 and "lost" not in r and r["nested"] == {"a": [1, 2.5, "x"]}
    np.testing.assert_array_equal(r["k9"], np.arange(9))
    r.lock()
    r["after"] = 2
    r.unlock()
    r.close()
    assert Shelf(fn)["after"] == 2


def test_codec_round_trips_traces_and_refuses_other_objects():
    m = GaussianUnknownMean()
    trace = m.prior(num_traces=3, vectorized=False).get_values()[0]
    back = concurrency.decode(concurrency.encode(trace))
    assert [v.address for v in back.variables] == [v.address for v in trace.variables]
    assert back.log_importance_weight == trace.log_importance_weight
    assert [v.address for v in back.variables_controlled] == [v.address for v in trace.variables_controlled]
    assert back.named_variables["obs0"] is back.variables_dict_address[trace.named_variables["obs0"].address]
    d = back.variables_controlled[0].distribution
    assert isinstance(d, Normal) and d.loc.device.type == "cpu"
    x = torch.tensor([0.3, -1.2])
    for dist in (Censored(Normal(0.0, 1.0), lower=-1.0, upper=1.0),
                 Mixture([Normal(0.0, 1.0), Normal(2.0, 0.5)], probs=[0.3, 0.7])):
        copy = concurrency.decode(concurrency.encode(dist))
        assert type(copy) is type(dist)
        assert torch.equal(copy.log_prob(x), dist.log_prob(x))
    with pytest.raises(TypeError):
        concurrency.encode(object())
    with pytest.raises(pickle.UnpicklingError):
        concurrency.decode(__import__("zlib").compress(pickle.dumps(Normal(0.0, 1.0))))
    concurrency.set_compression(9)
    try:
        assert concurrency.decode(concurrency.encode((1, "a"))) == (1, "a")
    finally:
        concurrency.set_compression(-1)


def test_address_dictionary(tmp_path):
    fn = str(tmp_path / "addresses")
    a = pp.AddressDictionary(fn)
    ids = [a.address_to_id(f"addr{i}") for i in range(3)]
    assert ids == ["__A1", "__A2", "__A3"] and a.address_to_id("addr1") == "__A2"
    b = pp.AddressDictionary(fn)  # a second process's view of the same file
    assert b.address_to_id("addr2") == "__A3" and b.id_to_address("__A1") == "addr0"
    assert b.address_to_id("new") == "__A4"
    a.close()
    b.close()


def test_empirical_file_roundtrip(tmp_path):
    fn = str(tmp_path / "emp_file")
    e = Empirical(values=[1.0, 2.0, 3.0], log_weights=[0.0, 0.0, 1.0], file_name=fn)
    mean1 = float(e.mean)
    e.close()
    e2 = Empirical(file_name=fn)
    assert e2.length == 3 and e2.empirical_type == EmpiricalType.FILE
    assert float(e2.mean) == mean1
    e2.add(4.0, log_weight=0.0)
    e2.finalize()
    assert e2.length == 4
    e2.close()
    e3 = Empirical(file_name=fn, file_read_only=True)
    assert e3.length == 4 and e3.get_values() == [1.0, 2.0, 3.0, 4.0]
    with pytest.raises(RuntimeError, match="read-only"):
        e3.add(5.0)
    e3.close()


def test_empirical_concat_memory_and_file(tmp_path):
    c = Empirical(concat_empiricals=[Empirical(values=[1.0, 2.0], log_weights=[0.0, 0.0]),
                                     Empirical(values=[3.0, 4.0], log_weights=[0.0, 0.0])])
    assert c.length == 4 and np.isclose(float(c.mean), 2.5)
    assert c.empirical_type == EmpiricalType.CONCAT_MEMORY
    with pytest.raises(RuntimeError, match="concatenated"):
        c.add(1.0)
    fns = []
    for i in range(3):
        fn = str(tmp_path / f"chunk_{i}")
        Empirical(values=[float(i * 2), float(i * 2 + 1)], log_weights=[0.0, 0.0], file_name=fn).close()
        fns.append(fn)
    cf = Empirical(concat_empirical_file_names=fns, file_name=str(tmp_path / "joined"))
    assert cf.length == 6 and np.isclose(float(cf.mean), 2.5)
    copied = cf.copy()
    cf.close()
    assert copied.length == 6 and np.isclose(float(copied.mean), 2.5)
    reopened = Empirical(file_name=str(tmp_path / "joined"))  # the descriptor reopens the join
    assert reopened.empirical_type == EmpiricalType.CONCAT_FILE and reopened.get_values() == copied.get_values()
    reopened.close()


def test_empirical_copy_storage_combos(tmp_path):
    mem = Empirical(values=[1.0, 2.0, 3.0], log_weights=[0.0, 0.5, 1.0])
    f1 = mem.copy(file_name=str(tmp_path / "f1"))
    assert f1.empirical_type == EmpiricalType.FILE
    f2 = f1.copy(file_name=str(tmp_path / "f2"))
    mem2 = f2.copy()
    assert mem2.empirical_type == EmpiricalType.MEMORY
    assert np.isclose(float(mem2.mean), float(mem.mean))
    cat_mem = Empirical(concat_empiricals=[mem, mem2]).copy()
    assert cat_mem.length == 6
    catf = Empirical(concat_empirical_file_names=[str(tmp_path / "f1"), str(tmp_path / "f2")])
    f3 = catf.copy(file_name=str(tmp_path / "f3"))
    assert f3.length == 6 and np.isclose(float(f3.mean), float(cat_mem.mean))
    for e in (f1, f2, f3, catf):
        e.close()


def test_array_values_in_blocks_reopen_to_the_bit(tmp_path):
    rng = np.random.default_rng(0)
    values = rng.normal(size=(300_000, 2)).astype(np.float32)  # two blocks of 2^18 rows at most
    lw = rng.normal(size=300_000)
    fn = str(tmp_path / "arrays")
    e = Empirical.from_arrays(values, lw, effective_sample_size=1234.5, file_name=fn)
    e.close()
    back = Empirical(file_name=fn, file_read_only=True)
    assert back._values.dtype == np.float32 and np.array_equal(back._values, values)
    assert np.array_equal(back.log_weights, lw) and back.effective_sample_size == 1234.5
    assert np.array_equal(back.mean, e.mean)
    back.close()
    # appending recomputes the ESS of the whole
    more = Empirical.from_arrays(values[:10], lw[:10], effective_sample_size=1.0, file_name=fn)
    assert more.length == 300_010 and np.array_equal(more._values[-10:], values[:10])
    assert more.effective_sample_size == pytest.approx(pp.util.effective_sample_size(np.concatenate([lw, lw[:10]])))
    more.close()


def test_prior_on_disk_append(tmp_path):
    fn = str(tmp_path / "prior_file")
    m = GaussianUnknownMean()
    p1 = m.prior_results(num_traces=100, file_name=fn)
    assert p1.length == 100
    p1.close()
    p2 = m.prior_results(num_traces=100, file_name=fn)
    assert p2.length == 200
    p2.close()
    p3 = Empirical(file_name=fn)
    assert p3.length == 200 and p3.metadata[-1]["op"] == "prior"
    p3.close()


@pytest.mark.parametrize("tier", ["batched", "interpreter", "lockstep"])
def test_file_results_equal_memory_results(tier, tmp_path):
    ic = pp.InferenceEngine.IMPORTANCE_SAMPLING_WITH_INFERENCE_NETWORK
    if tier == "batched":
        model, n = GaussianUnknownMean(), 20_000
        kw = dict(vectorized=True)
    else:
        model, n = GaussianUnknownMeanMarsaglia(), 100
        kw = dict(vectorized=False, inference_engine=ic, lockstep=8 if tier == "lockstep" else False)
        pp.seed(1)
        model.learn_inference_network(num_traces=32, observe_embeddings={"obs0": {"dim": 4}, "obs1": {"dim": 4}},
                                      inference_network=pp.InferenceNetwork.LSTM, batch_size=32, lstm_dim=8)
    fn = str(tmp_path / "results")
    pp.seed(5)
    memory = model.posterior_results(n, observe=OBSERVE, **kw)
    pp.seed(5)
    on_file = model.posterior_results(n, observe=OBSERVE, file_name=fn, **kw)
    on_file.close()
    back = Empirical(file_name=fn, file_read_only=True)
    assert back.empirical_type == EmpiricalType.FILE
    assert np.array_equal(np.asarray(back.get_values()), np.asarray(memory.get_values()))
    assert np.array_equal(back.log_weights, memory.log_weights)
    assert back.effective_sample_size == memory.effective_sample_size
    assert np.array_equal(back.mean, memory.mean) and math.isfinite(float(back.mean))
    back.close()
