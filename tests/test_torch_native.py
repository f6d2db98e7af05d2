"""The port's native C++ graph builder (``ppr_tpu_torch/native``) against
the JAX package's ``build_graph`` and native binding.

Held exactly: the CSR arrays against the JAX package's, the edge-list
parse, the out-of-range error, and the alias tables against the JAX
package's (native against native, and the Python loop against its Python
loop). The native tables read the coefficients as float32 and the loop as
float64, so the two are held to the distribution each slot's alias table
gives, within 1e-6. Skips without a C++ compiler, as
``tests/test_native.py`` does."""

import dataclasses

import numpy as np
import pytest

from ppr_tpu import native as jnative
from ppr_tpu.graph import csr as jcsr
from ppr_tpu_torch import native
from ppr_tpu_torch.graph import csr as tcsr

needs_native = pytest.mark.skipif(native.get_lib() is None,
                                  reason="no C++ toolchain")


def edges(seed, n, m):
    rng = np.random.default_rng(seed)
    return rng.integers(0, n, m), rng.integers(0, n, m)


@needs_native
def test_native_csr_matches_jax_build_graph():
    src, dst = edges(5, 100, 700)
    indptr, indices, sorted_src, out_deg, in_deg = native.build_csr_native(
        src, dst, 100, 128)
    jg = jcsr.build_graph(src, dst, n=100)
    np.testing.assert_array_equal(indptr, np.asarray(jg.indptr))
    np.testing.assert_array_equal(indices, np.asarray(jg.indices)[:700])
    np.testing.assert_array_equal(sorted_src, np.asarray(jg.edge_src)[:700])
    np.testing.assert_array_equal(out_deg, np.asarray(jg.out_deg))
    np.testing.assert_array_equal(in_deg, np.asarray(jg.in_deg))
    order = np.argsort(src, kind="stable")
    np.testing.assert_array_equal(indices, dst[order])


@needs_native
def test_native_build_graph_equals_numpy_path(monkeypatch):
    """``build_graph`` gives the same graph through the native CSR and
    through the argsort path."""
    src, dst = edges(6, 300, 2000)
    fast = tcsr.build_graph(src, dst, 300, device="cpu")
    monkeypatch.setattr(native, "build_csr_native", lambda *a: None)
    slow = tcsr.build_graph(src, dst, 300, device="cpu")
    for f in dataclasses.fields(fast):
        a, b = getattr(fast, f.name), getattr(slow, f.name)
        if a is None or isinstance(a, int):
            assert a == b, f.name
        else:
            assert a.dtype == b.dtype and bool((a == b).all()), f.name


@needs_native
def test_native_out_of_range_raises():
    with pytest.raises(ValueError, match="out of range"):
        native.build_csr_native(np.array([5]), np.array([0]), n=3, n_pad=8)


@needs_native
def test_native_edge_list_parse(tmp_path):
    p = tmp_path / "edges.txt"
    p.write_text("# comment\n0 1\n1\t2\n\n  2,0\n7 x\n")
    src, dst = native.parse_edge_list_native(str(p), 16)
    jsrc, jdst = jnative.parse_edge_list_native(str(p), 16)
    assert list(src) == list(jsrc) == [0, 1, 2]
    assert list(dst) == list(jdst) == [1, 2, 0]
    assert native.parse_edge_list_native(str(p), 2) is None   # over cap


def weighted_case(seed=31, n=80, m=900):
    rng = np.random.default_rng(seed)
    src, dst = rng.integers(0, n, m), rng.integers(0, n, m)
    w = rng.random(m) + 0.05
    jg = jcsr.build_graph(src, dst, n=n, weights=w)
    order = np.argsort(src, kind="stable")
    w_s = w[order]
    w_sum = np.zeros(jg.n_pad)
    np.add.at(w_sum, src[order], w_s)
    return jg, w_s / w_sum[src[order]]


def slot_probabilities(indptr, prob, other, m):
    """The probability of each slot under the alias draw: a uniform slot of
    its node, kept with ``prob``, else sent to ``other``."""
    p = np.zeros(m)
    deg = np.diff(indptr)
    node = np.repeat(np.arange(len(deg)), deg)
    share = 1.0 / deg[node]
    np.add.at(p, np.arange(m), share * prob[:m])
    np.add.at(p, other[:m], share * (1.0 - prob[:m].astype(np.float64)))
    return p


@needs_native
def test_native_alias_tables_match_jax():
    jg, coef = weighted_case()
    indptr = np.asarray(jg.indptr)
    prob, other = native.build_alias_native(indptr, coef, jg.m_pad)
    jprob, jother = jnative.build_alias_native(indptr, coef, jg.m_pad)
    np.testing.assert_array_equal(prob, jprob)
    np.testing.assert_array_equal(other, jother)
    # the graph JAX built took the same native path
    np.testing.assert_array_equal(prob, np.asarray(jg.alias_prob))
    np.testing.assert_array_equal(other, np.asarray(jg.alias_other))


def test_python_alias_tables_match_jax(monkeypatch):
    jg, coef = weighted_case()
    indptr = np.asarray(jg.indptr)
    monkeypatch.setattr(native, "build_alias_native", lambda *a: None)
    prob, other = tcsr.build_alias_tables(indptr, coef, jg.m_pad)
    monkeypatch.setattr(jnative, "build_alias_native", lambda *a: None)
    jprob, jother = jcsr._build_alias_tables(indptr, coef, jg.m, jg.m_pad)
    assert prob.dtype == np.float32 and other.dtype == np.int32
    np.testing.assert_array_equal(prob, jprob)
    np.testing.assert_array_equal(other, jother)


@needs_native
def test_native_and_python_alias_tables_agree(monkeypatch):
    jg, coef = weighted_case()
    indptr = np.asarray(jg.indptr)
    fast = tcsr.build_alias_tables(indptr, coef, jg.m_pad)
    monkeypatch.setattr(native, "build_alias_native", lambda *a: None)
    slow = tcsr.build_alias_tables(indptr, coef, jg.m_pad)
    for prob, other in (fast, slow):
        # padding slots keep their own target
        assert (prob[jg.m:] == 1).all()
        assert (other[jg.m:] == np.arange(jg.m, jg.m_pad)).all()
        np.testing.assert_allclose(
            slot_probabilities(indptr, prob, other, jg.m), coef, atol=1e-6)


def test_available_says_which_path(monkeypatch):
    assert native.available() == (native.get_lib() is not None)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_lib_tried", True)
    assert not native.available()
    assert native.build_csr_native(np.array([0]), np.array([1]), 2,
                                   128) is None
    assert native.build_alias_native(np.array([0, 1]), np.ones(1),
                                     128) is None


def test_builds_into_the_repository_build_dir():
    assert native.BUILD_DIR.parts[-2:] == ("build", "ppr_tpu_torch")
    assert "-march=native" not in native.CXX_FLAGS
