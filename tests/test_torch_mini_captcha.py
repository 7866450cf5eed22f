"""MiniCaptcha in the port against the JAX package, on the CPU.

The glyph table (``pyprob_tpu_torch/models/glyphs_dejavusans_bold_18.bin``)
equals the JAX package's PIL rendering to the bit for every printable
ASCII character at ``render``'s defaults; other text goes through PIL, and
without PIL it raises ImportError (the JAX package always needs PIL).  The
model's addresses (without their source line) and log-probabilities on
both tiers against a JAX trace's of the same letter, within 1e-5
(1 + |ref|);
and the JAX package's builtin test (tests/test_models_builtin.py:76-87):
prior IS at 500 traces on the batched tier recovers the letter by its mode,
and the model runs on the batched tier.
"""

import re
import sys

import numpy as np
import pytest
import torch

import pyprob_tpu
import pyprob_tpu_torch as pp
from pyprob_tpu.models import MiniCaptcha as JaxMiniCaptcha
from pyprob_tpu_torch.models import MiniCaptcha

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _port_on_cpu():
    pp.set_device("cpu")
    pp.seed(0)
    yield


def test_glyph_table_equals_the_jax_rendering():
    pytest.importorskip("PIL")
    jm, tm = JaxMiniCaptcha(alphabet=("A",)), MiniCaptcha(alphabet=("A",))
    for code in range(32, 127):
        ref, got = jm.render(chr(code)), tm.render(chr(code))
        assert got.dtype == np.float32 and got.shape == (784,)
        assert np.array_equal(got.view(np.uint32), ref.view(np.uint32)), chr(code)
    # other text and offsets through PIL, as the JAX package
    for args in (("AB",), ("A", 16), ("B", 18, 28, 28, 4, 5)):
        assert np.array_equal(tm.render(*args), jm.render(*args)), args


def test_render_without_pil_raises(monkeypatch):
    tm = MiniCaptcha()
    monkeypatch.setitem(sys.modules, "PIL", None)
    assert tm.render("Q").shape == (784,)  # the table needs no PIL
    with pytest.raises(ImportError, match="needs PIL"):
        tm.render("AB")


@pytest.mark.parametrize("vectorized", [True, False])
def test_addresses_and_log_probs_match(vectorized):
    jm, tm = JaxMiniCaptcha(alphabet=("A", "B", "C")), MiniCaptcha(alphabet=("A", "B", "C"))
    pyprob_tpu.seed(4)
    jtrace = jm.prior(num_traces=1, vectorized=False).get_values()[0]
    letter = int(np.asarray(jtrace.variables_controlled[0].value))
    pp.seed(4)
    ttrace = None
    for _ in range(64):  # draw until the port draws the JAX trace's letter
        t = tm.prior(num_traces=1, vectorized=vectorized).get_values()[0]
        if int(np.asarray(t.variables_controlled[0].value)) == letter:
            ttrace = t
            break
    assert ttrace is not None
    # addresses without their leading source line (the two files differ there)
    base = lambda a: re.sub(r"^\d+__", "", a)  # noqa: E731
    assert [base(v.address) for v in ttrace.variables] == [base(v.address) for v in jtrace.variables]
    obs = np.asarray(jm.render("A")) + 0.05
    for jv, tv in zip(jtrace.variables, ttrace.variables):
        value = np.asarray(jv.value) if jv.control else obs
        ref = float(np.sum(np.asarray(jv.distribution.log_prob(value))))
        got = float(tv.distribution.log_prob(torch.as_tensor(value, dtype=torch.float32)).sum())
        assert abs(got - ref) <= 1e-5 * (1 + abs(ref)), tv.address


def test_mini_captcha_builtin():
    from pyprob_tpu_torch.vectorized import _TraceabilityCache

    m = MiniCaptcha(alphabet=("A", "B"))
    img = m.render("A")
    post = m.posterior_results(num_traces=500, observe={"query_image": img}, vectorized=True)
    assert int(np.asarray(post.mode)) == 0
    assert _TraceabilityCache._cache.get(type(m)) is True  # it ran on the batched tier
    interp = m.posterior_results(num_traces=50, observe={"query_image": m.render("B")}, vectorized=False)
    assert int(np.asarray(interp.mode)) == 1
