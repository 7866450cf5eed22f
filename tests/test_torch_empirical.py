"""The port's Empirical (memory mode) against the JAX package's, on the CPU.

Inputs from numpy seeds: float32 values, vector values ``[n, 3]`` and
integer values with duplicates, under uniform weights, random log-weights,
log-weights with −inf entries and all-equal log-weights.  Each goes into
the JAX package's Empirical and into the port's twice, as one array (its
vectorised statistics) and as a list (the JAX package's loops).  Values
and their order equal; weights, moments, quantiles and HPD bounds within
1e-12 relative (both float64 numpy; atol 1e-14 for values near 0); mode,
median, arg_max and arg_min equal, ties included.  Draws (``sample``,
``resample``) are held to their weights by frequencies within 5 standard
errors, the two packages' generators being different.  ``density_estimate``
on well-separated one- and two-component data: component means and
stddevs within 0.05 of the JAX package's scikit-learn fit, weights within
0.02.  ``reobserve`` rescoring GUM traces from both tiers (the JAX test's
check, tests/test_models_builtin.py:103-112), and 200 traces carried from
the JAX package, each rescored log-weight within 1e-5 of its rescoring.
"""

import math
import warnings

import numpy as np
import pytest
import torch

import pyprob_tpu
import pyprob_tpu_torch as pp
from pyprob_tpu import distributions as JD
from pyprob_tpu import util as jutil
from pyprob_tpu_torch import distributions as TD
from pyprob_tpu_torch import util as tutil

import _torch_parity as P

torch.set_num_threads(2)
RTOL, ATOL = 1e-12, 1e-14


@pytest.fixture(autouse=True)
def _port_on_cpu():
    pp.set_device("cpu")
    pp.seed(0)
    pp.set_verbosity(0)
    pyprob_tpu.set_verbosity(0)
    yield


def _values(kind, n=400, seed=0):
    rng = np.random.default_rng(seed)
    if kind == "float":
        return rng.normal(1.0, 2.0, n).astype(np.float32)
    if kind == "vector":
        return rng.normal(size=(n, 3)).astype(np.float32)
    return rng.integers(0, 6, n)  # integers with duplicates


def _log_weights(kind, n, seed=1):
    rng = np.random.default_rng(seed)
    if kind == "uniform":
        return None
    lw = rng.normal(0.0, 1.5, n)
    if kind == "neg_inf":
        lw[::7] = -np.inf
    if kind == "equal":
        lw = np.full(n, 3.0)
    return lw


VALUES = ("float", "vector", "int")
WEIGHTS = ("uniform", "random", "neg_inf", "equal")


def _pairs(values_kind, weights_kind):
    """(port, JAX) Empiricals of one input, built by ``from_arrays`` (the
    port's array mode) and from a list (its list mode).  Both packages'
    ``from_arrays`` store a −inf log-weight as −1.8e308 (``np.nan_to_num``'s
    default), the constructors keep it."""
    vals = _values(values_kind)
    lw = _log_weights(weights_kind, len(vals))
    a, lst = TD.Empirical.from_arrays(vals, lw), TD.Empirical(values=list(vals), log_weights=lw)
    assert a._is_array() and not lst._is_array()
    return [(a, JD.Empirical.from_arrays(vals, lw)), (lst, JD.Empirical(values=list(vals), log_weights=lw))]


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64), rtol=RTOL, atol=ATOL)


def _same_values(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


def test_every_public_name_has_a_counterpart():
    # the names the JAX class defines (its Distribution base's own, such as
    # kl_divergence, belong to the distributions' surface)
    ours = set(dir(TD.Empirical))
    theirs = {n for n in vars(JD.Empirical) if not n.startswith("_")}
    assert theirs <= ours, sorted(theirs - ours)
    assert [m.name for m in TD.EmpiricalType] == [m.name for m in JD.EmpiricalType]
    assert pp.distributions.EmpiricalType is TD.EmpiricalType


@pytest.mark.parametrize("values_kind", VALUES)
@pytest.mark.parametrize("weights_kind", WEIGHTS)
def test_weights_and_moments_match(values_kind, weights_kind):
    for e, j in _pairs(values_kind, weights_kind):
        assert e.length == len(e) == j.length and e.finalized
        _close(e.log_weights, j.log_weights)
        _close(e.weights, j.weights)
        _close(e.weights_numpy(), j.weights_numpy())
        _close(e._log_weights_normalized(), j._log_weights_normalized())
        _close(e.effective_sample_size, j.effective_sample_size)
        for name in ("mean", "variance", "stddev", "skewness", "kurtosis"):
            _close(getattr(e, name), getattr(j, name))
        square = lambda v: np.asarray(v, np.float64) ** 2  # noqa: E731
        _close(e.expectation(square), j.expectation(square))
        assert e.weighted == j.weighted
        _same_values(e.get_values(), j.get_values())
        _same_values(e.values_numpy(np.float32), j.values_numpy(np.float32))


@pytest.mark.parametrize("values_kind", VALUES)
@pytest.mark.parametrize("weights_kind", WEIGHTS)
def test_order_statistics_and_mode_match(values_kind, weights_kind):
    key = (lambda v: float(np.sum(v))) if values_kind == "vector" else (lambda v: abs(int(v) - 2)
                                                                       if values_kind == "int" else float(v))
    for e, j in _pairs(values_kind, weights_kind):
        np.testing.assert_array_equal(np.asarray(e.median), np.asarray(j.median))
        np.testing.assert_array_equal(np.asarray(e.mode), np.asarray(j.mode))
        np.testing.assert_array_equal(np.asarray(e.arg_max(key)), np.asarray(j.arg_max(key)))
        np.testing.assert_array_equal(np.asarray(e.arg_min(key)), np.asarray(j.arg_min(key)))
        _close(e.quantile([0.05, 0.5, 0.9]), j.quantile([0.05, 0.5, 0.9]))
        assert e.quantile(0.3) == j.quantile(0.3)
        _close(e.hpd_interval(0.8), j.hpd_interval(0.8))
        _close(e.min, j.min)
        _close(e.max, j.max)
        c, jc = e.combine_duplicates(), j.combine_duplicates()
        _same_values(c.get_values(), jc.get_values())
        _close(c.log_weights, jc.log_weights)
        assert c.metadata == jc.metadata == [{"op": "combine_duplicates"}]
    with pytest.raises(ValueError):
        e.quantile(1.5)
    with pytest.raises(ValueError):
        e.hpd_interval(1.0)


def test_ties_follow_the_jax_rules():
    # the first bucket of greatest combined weight is the mode; the last of
    # equal keys wins arg_max and arg_min; a stable argsort breaks median ties
    vals = np.array([3, 1, 1, 3, 2, 2, 5])
    j = JD.Empirical(values=list(vals))
    for e in (TD.Empirical(values=vals), TD.Empirical(values=list(vals))):
        assert e.mode == j.mode == 3
        assert e.arg_max(lambda v: v % 2) == j.arg_max(lambda v: v % 2) == 5
        assert e.arg_min(lambda v: v % 2) == j.arg_min(lambda v: v % 2) == 2
        assert e.median == j.median
        assert e.combine_duplicates().get_values() == [3, 1, 2, 5]


@pytest.mark.parametrize("values_kind", VALUES)
def test_transforms_match(values_kind):
    for e, j in _pairs(values_kind, "neg_inf"):
        j.add_metadata(op="posterior", inference_engine="IMPORTANCE_SAMPLING")
        e.add_metadata(op="posterior", inference_engine="IMPORTANCE_SAMPLING")
        pairs = [
            (e.map(lambda v: np.asarray(v) * 2), j.map(lambda v: np.asarray(v) * 2)),
            (e.filter(lambda v: np.sum(v) > 0.5), j.filter(lambda v: np.sum(v) > 0.5)),
            (e.condition(lambda v: np.sum(v) < 2), j.condition(lambda v: np.sum(v) < 2)),
            (e.thin(37), j.thin(37)),
            (e.thin(37, map_func=lambda v: np.sum(v)), j.thin(37, map_func=lambda v: np.sum(v))),
            (e[10:200:3], j[10:200:3]),
            (e.unweighted(), j.unweighted()),
            (e.copy(), j.copy()),
            (e.reweight(lambda v: -float(np.sum(v))), j.reweight(lambda v: -float(np.sum(v)))),
        ]
        for mine, ref in pairs:
            _same_values(mine.get_values(), ref.get_values())
            _close(mine.log_weights, ref.log_weights)
            _close(mine.weights, ref.weights)
            assert mine.metadata == ref.metadata
        np.testing.assert_array_equal(np.asarray(e[5]), np.asarray(j[5]))
        np.testing.assert_array_equal(np.asarray(e[-1]), np.asarray(j[-1]))
        assert e.map(lambda v: np.asarray(v) * 2)._is_array()  # numbers of one shape are one array


@pytest.mark.parametrize("values_kind", VALUES)
def test_vectorised_and_list_paths_agree(values_kind):
    vals = np.concatenate([_values(values_kind, 300, seed=2)] * 2)  # every value twice
    lw = _log_weights("random", len(vals), seed=3)
    a, lst = TD.Empirical(values=vals, log_weights=lw), TD.Empirical(values=list(vals), log_weights=lw)
    for name in ("mode", "median", "min", "max"):
        np.testing.assert_array_equal(np.asarray(getattr(a, name)), np.asarray(getattr(lst, name)))
    ca, cl = a.combine_duplicates(), lst.combine_duplicates()
    assert ca.length == cl.length == (6 if values_kind == "int" else 300)
    _same_values(ca.get_values(), cl.get_values())
    _close(ca.log_weights, cl.log_weights)
    _close(a.hpd_interval(0.5), lst.hpd_interval(0.5))
    _close(a.quantile([0.2, 0.7]), lst.quantile([0.2, 0.7]))
    _close(a.skewness, lst.skewness)


def test_sample_and_resample_frequencies():
    # a four-value Empirical: 20,000 draws each way, every value's share
    # within 5 standard errors of its weight
    probs = np.array([0.1, 0.2, 0.3, 0.4])
    n = 20_000
    for e in (TD.Empirical(values=np.arange(4.0), weights=probs),
              TD.Empirical(values=[0.0, 1.0, 2.0, 3.0], weights=probs)):
        draws = [
            np.asarray(e.sample(sample_shape=(n,))),
            np.asarray(e.sample(rng=np.random.default_rng(5), sample_shape=(100, n // 100))).reshape(-1),
            e.resample(n).values_numpy(),
            e.resample(n, map_func=lambda v: v + 10).values_numpy() - 10,
        ]
        for d in draws:
            assert d.shape == (n,)
            share = np.bincount(d.astype(int), minlength=4) / n
            assert np.all(np.abs(share - probs) < 5 * np.sqrt(probs * (1 - probs) / n)), share
        assert float(e.sample()) in (0.0, 1.0, 2.0, 3.0)
        r = e.resample(50)
        assert r.length == 50 and np.allclose(r.weights, 1 / 50) and not r.weighted
        assert r.metadata == [{"op": "resample", "num_samples": 50}]
    with pytest.raises(RuntimeError, match="empty"):
        TD.Empirical(values=[]).sample()


def test_construction_lifecycle_and_metadata(tmp_path):
    j = JD.Empirical(values=[0.0, 1.0], weights=[0.2, 0.8])
    t = TD.Empirical(values=[0.0, 1.0], weights=[0.2, 0.8])
    _close(t.mean, j.mean)
    _close(t.log_weights, j.log_weights)
    # add / add_sequence / finalize, onto list and array values
    for start in ([], np.array([4.0, 5.0])):
        ours, ref = TD.Empirical(), JD.Empirical()
        if len(start):
            ours, ref = TD.Empirical(values=start), JD.Empirical(values=list(start))
        for e in (ours, ref):
            e.add(1.0, log_weight=-0.5)
            e.add(2.0, weight=0.25)
            e.add(3.0, weight=0.0)
            e.add_sequence([6.0, 7.0], log_weights=[0.1, 0.2])
        assert not ours.finalized
        _close(ours.mean, ref.mean)  # finalizes on first use
        assert ours.finalized and ours.length == ref.length
        _close(ours.log_weights_numpy(), ref.log_weights_numpy())
    assert TD.Empirical().length == 0 and TD.Empirical(values=[]).effective_sample_size == 0.0
    e = TD.Empirical(values=[1.0, 2.0], name="a").rename("b")
    assert e.name == "b" and e.empirical_type is TD.EmpiricalType.MEMORY and e.file_name is None
    e.add_metadata(op="x", n=2)
    je = JD.Empirical(values=[1.0])
    je.add_metadata(op="x", n=2)
    assert e.metadata_yaml() == je.metadata_yaml()
    e.save_metadata(str(tmp_path / "m.yaml"))
    assert (tmp_path / "m.yaml").read_text() == "- n: 2\n  op: x\n"
    e.close()
    with pytest.raises(NotImplementedError):
        e.log_prob(1.0)
    with pytest.raises(ValueError, match="equal length"):
        TD.Empirical(values=[1.0, 2.0], log_weights=[0.0])
    f = TD.Empirical.from_distribution(TD.Normal(2.0, 0.5), 4000)
    assert f.length == 4000 and f._is_array() and abs(float(f.mean) - 2.0) < 5 * 0.5 / math.sqrt(4000)
    assert repr(TD.Empirical(values=[1.0])) == "Empirical(name='Empirical', length=1, type=MEMORY, ESS=1.00)"


@pytest.mark.parametrize("kwargs", [
    {"file_name": "x.db"},
    {"concat_empiricals": []},
    {"concat_empirical_file_names": ["x.db"]},
])
def test_file_modes_raise_naming_the_storage_slice(kwargs, tmp_path):
    """The storage modes, which raised naming the storage slice until it
    was ported, now open: a new file is an empty FILE Empirical, an empty
    concatenation has no values, and a concatenation of a file that does
    not exist raises FileNotFoundError (read-only; the JAX package would
    create it empty).  A copy to a file holds the values and weights."""
    kwargs = {k: str(tmp_path / v) if k == "file_name" else v for k, v in kwargs.items()}
    if "concat_empirical_file_names" in kwargs:
        with pytest.raises(FileNotFoundError):
            TD.Empirical(concat_empirical_file_names=[str(tmp_path / "x.db")])
    else:
        e = TD.Empirical(**kwargs)
        assert len(e) == 0 and e.empirical_type in (TD.EmpiricalType.FILE, TD.EmpiricalType.CONCAT_MEMORY)
        e.close()
    c = TD.Empirical(values=[1.0], log_weights=[0.5]).copy(file_name=str(tmp_path / "copy.db"))
    assert c.get_values() == [1.0] and c.log_weights.tolist() == [0.5]
    c.close()


def test_empirical_to_categorical_matches():
    e = [X.Empirical(values=[0, 1, 1, 2, 5, 1], log_weights=[0.0, 0.5, 0.0, -1.0, 2.0, 0.0]) for X in (JD, TD)]
    for max_items in (None, 2):
        (jc, jv), (tc, tv) = jutil.empirical_to_categorical(e[0], max_items), tutil.empirical_to_categorical(e[1], max_items)
        assert isinstance(tc, TD.Categorical) and list(tv) == list(jv)
        np.testing.assert_allclose(tc.probs.numpy(), np.asarray(jc.probs), rtol=1e-6)
    _close(tutil.log_weights_to_probs([0.0, np.nan, -1.0]), jutil.log_weights_to_probs([0.0, np.nan, -1.0]))
    _close(tutil.log_weights_to_probs([-np.inf, -np.inf]), [0.5, 0.5])
    for v in (0.0, 2.5, -1.0, [0.0, 2.0]):
        np.testing.assert_array_equal(tutil.safe_log(v), jutil.safe_log(v))


@pytest.mark.parametrize("components,data", [
    (1, [(3.0, 1.0, 1.0)]),
    (2, [(-4.0, 0.5, 0.3), (3.0, 1.0, 0.7)]),
])
def test_density_estimate_matches_the_jax_fit(components, data):
    rng = np.random.default_rng(7)
    vals = np.concatenate([rng.normal(m, s, int(w * 6000)) for m, s, w in data])
    pyprob_tpu.seed(1)
    fits = []
    for e in (JD.Empirical(values=list(vals)), TD.Empirical(values=vals)):
        d = e.density_estimate(num_components=components)
        means = np.array([float(np.asarray(c.mean)) for c in d.distributions])
        sds = np.array([float(np.asarray(c.stddev)) for c in d.distributions])
        w = np.asarray(d.probs, np.float64).reshape(-1)
        order = np.argsort(means)
        fits.append((means[order], sds[order], w[order]))
    (jm, js, jw), (tm, ts, tw) = fits
    np.testing.assert_allclose(tm, jm, atol=0.05)
    np.testing.assert_allclose(ts, js, atol=0.05)
    np.testing.assert_allclose(tw, jw, atol=0.02)
    np.testing.assert_allclose(tm, [m for m, _, _ in data], atol=0.1)


def test_plot_histogram_writes_a_png(tmp_path):
    e = TD.Empirical(values=np.random.default_rng(0).normal(size=200))
    e.plot_histogram(file_name=str(tmp_path / "hist.png"))
    e.plot(file_name=str(tmp_path / "plot.png"))
    assert (tmp_path / "hist.png").stat().st_size > 0 and (tmp_path / "plot.png").exists()


@pytest.mark.parametrize("vectorized", [True, False])
def test_reobserve_rescoring_both_tiers(vectorized):
    # tests/test_models_builtin.py:103-112: GUM traces rescored at new
    # observes, against a direct posterior at them (both 2,000 traces)
    new = {"obs0": 2.0, "obs1": 2.0}
    post = P.TorchGUM().posterior(2000, observe=P.OBSERVE, vectorized=vectorized)
    re = post.reobserve(observe=new)
    assert re.metadata[-1] == {"op": "reobserve", "length": 2000} and re.length == 2000
    direct = P.TorchGUM().posterior(2000, observe=new, vectorized=vectorized)
    mean_re = float(re.map(lambda t: float(t.result)).mean)
    mean_direct = float(direct.map(lambda t: float(t.result)).mean)
    assert abs(mean_re - mean_direct) < 1.0
    assert abs(mean_re - 11 / 6) < 0.3  # the analytic posterior mean at (2, 2)
    # the traces through map, filter and thin
    kept = post.filter(lambda t: float(t.result) > 7.0)
    assert all(float(t.result) > 7.0 for t in kept.get_values()) and 0 < kept.length < 2000
    assert post.thin(100).length == 100
    assert post.map(lambda t: float(t.result))._is_array()
    # a likelihood replaced by name, the trace's value rescored under it
    wide = post.reobserve(likelihood_funcs={"obs0": lambda v, tr: TD.Normal(0.0, 100.0)})
    assert wide.length == 2000 and np.isfinite(wide.log_weights).all()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        post.thin(10).reobserve(observe=new)
    assert any("importance-sampling" in str(w.message) for w in caught)
    with pytest.raises(RuntimeError, match="execution traces"):
        TD.Empirical(values=[1.0]).reobserve(observe=new)


def test_reobserve_matches_the_jax_rescoring_trace_by_trace():
    # 200 JAX posterior traces, carried into the port's records: each
    # rescored log-weight within 1e-5 of the JAX package's
    new = {"obs0": 6.5, "obs1": 7.5}
    jpost = P.JaxGUM().posterior(200, observe=P.OBSERVE, vectorized=True)
    jre = jpost.reobserve(observe=new)
    ours = TD.Empirical(values=[P.port_trace(t) for t in jpost.get_values()], log_weights=jpost.log_weights)
    ours.add_metadata(op="posterior", inference_engine="InferenceEngine.IMPORTANCE_SAMPLING")
    re = ours.reobserve(observe=new, likelihood_importance=0.5)
    jre_half = jpost.reobserve(observe=new, likelihood_importance=0.5)
    np.testing.assert_allclose(re.log_weights, jre_half.log_weights, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ours.reobserve(observe=new).log_weights, jre.log_weights, rtol=1e-5, atol=1e-5)
    part = ours.reobserve(observe=new, min_index=10, max_index=30)
    assert part.length == 20
    np.testing.assert_allclose(part.log_weights, jre.log_weights[10:30], rtol=1e-5, atol=1e-5)
