"""The port's reverse push operator, its push sweeps and K3's and the
row-gather probes' plain versions against the JAX package and numpy.

Graphs: the ``tiny`` fixture (a dangling node, a self loop, a node with no
in-edges), the 107-node GOT-scale graph with its dense operator, and the
same graph with ``dense_threshold=0`` (the sorted segmented sums). Inputs
are made with numpy and handed to both packages; JAX runs its XLA path on
the CPU.

Tolerances: operators 1e-6 (f32 sums in another order, operands in
[0, 1)); sweeps: reserves and residues within 1e-6, and the same sweep
count (a different count is different semantics); mass conservation
``sum(p) + sum(r) = 1`` within 1e-5 (f32 rounding over the sweeps). The
plain gathers equal numpy's exactly, the segment sums within 1e-6."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ppr_tpu.graph.io import load_default
from ppr_tpu.models import backward_search as jbws
from ppr_tpu.ops import push as jpush
from ppr_tpu.ops import spmv as jspmv
from ppr_tpu_torch.graph.csr import build_graph, graph_from_numpy
from ppr_tpu_torch.models import backward_search as tbws
from ppr_tpu_torch.ops import probe, row_gather
from ppr_tpu_torch.ops import push as tpush
from ppr_tpu_torch.ops import spmv as tspmv

ALPHA = 0.15


def port(jg):
    return graph_from_numpy(
        {f.name: getattr(jg, f.name) for f in dataclasses.fields(jg)},
        device="cpu")


@pytest.fixture(scope="module")
def graphs(tiny):
    out = {"tiny": (tiny, port(tiny))}
    for kind, dt in (("got", 4096), ("got_sparse", 0)):
        jg = load_default(dense_threshold=dt).graph
        out[kind] = (jg, port(jg))
    assert out["got"][1].has_dense and not out["got_sparse"][1].has_dense
    return out


def sources_for(jg, b, seed):
    """``b`` node ids with a dangling node and a node without in-edges
    among them (where the graph has them)."""
    s = np.random.default_rng(seed).integers(0, jg.n, b)
    out_deg = np.asarray(jg.out_deg)[: jg.n]
    in_deg = np.asarray(jg.in_deg)[: jg.n]
    for i, special in enumerate((out_deg == 0, in_deg == 0)):
        if special.any():
            s[i] = np.nonzero(special)[0][0]
    return s


# --- the reverse push operator ---------------------------------------------

@pytest.mark.parametrize("shape", [(None,), (3, None)], ids=["1d", "2d"])
@pytest.mark.parametrize("kind", ["got", "got_sparse"])
def test_pull_out_norm_matches_jax(graphs, kind, shape):
    jg, tg = graphs[kind]
    lead = shape[:-1]
    a = np.zeros(lead + (jg.n_pad,), np.float32)
    a[..., : jg.n] = np.random.default_rng(4).random(lead + (jg.n,),
                                                     dtype=np.float32)
    ref = np.asarray(jspmv.pull_out_norm(jg, jnp.asarray(a)))
    out = tspmv.pull_out_norm(tg, torch.from_numpy(a))
    assert out.shape == a.shape and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-6)
    # both backends give the same operator
    other = "coo_sorted" if kind == "got" else None
    if other:
        sparse = tspmv.pull_out_norm(tg, torch.from_numpy(a), backend=other)
        np.testing.assert_allclose(sparse.numpy(), ref, atol=1e-6)
    # the coo backend, which raised until it was ported (ROADMAP.md, queue
    # 1, item 22), is the JAX package's scatter-add
    coo = tspmv.pull_out_norm(tg, torch.from_numpy(a), backend="coo")
    ref_coo = np.asarray(jspmv.pull_out_norm(jg, jnp.asarray(a),
                                             backend="coo"))
    np.testing.assert_allclose(coo.numpy(), ref_coo, atol=1e-6)
    np.testing.assert_allclose(coo.numpy(), ref, atol=1e-6)


def test_bysrc_ptr_delimits_sources(graphs):
    for jg, tg in graphs.values():
        ptr = tg.bysrc_ptr.numpy()
        assert tg.bysrc_ptr.dtype == torch.int64 and ptr[0] == 0
        assert ptr[-1] == tg.m_pad
        np.testing.assert_array_equal(
            np.diff(ptr), np.bincount(tg.edge_src.numpy(), minlength=tg.n_pad))
        # real edges: the CSR indptr of the JAX graph
        np.testing.assert_array_equal(ptr[: tg.n + 1],
                                      np.asarray(jg.indptr)[: tg.n + 1])


# --- K3's and the probes' plain versions ------------------------------------

def p1_pattern():
    """P1-P3: f32 [4096, 256] table, idx = 7919 i mod 4096 (512 rows)."""
    table = np.arange(4096 * 256, dtype=np.float32).reshape(4096, 256)
    idx = (np.arange(512) * 7919 % 4096).astype(np.int32)
    return table, idx


def p4_pattern(n, b, w=8192, tile=512):
    """P4: src = 7919 i mod N, dst = 104729 i mod 512 (unsorted)."""
    table = np.random.default_rng(n + b).random((n, b), dtype=np.float32)
    i = np.arange(w, dtype=np.int64)
    return table, (i * 7919 % n).astype(np.int32), \
        (i * 104729 % tile).astype(np.int32)


def sort_by_dst(src, dst, n_out):
    """P4's unsorted ``dst`` as K3 takes it: a stable argsort (each
    destination keeps P4's edge order) and the row pointer."""
    order = np.argsort(dst, kind="stable")
    ptr = np.searchsorted(dst[order], np.arange(n_out + 1)).astype(np.int64)
    return src[order], ptr


def test_row_gather_ref_p1_p4():
    table, idx = p1_pattern()
    out = row_gather.row_gather(torch.from_numpy(table), torch.from_numpy(idx))
    np.testing.assert_array_equal(out.numpy(), table[idx])
    table, src, _ = p4_pattern(4096, 128)
    out = row_gather.row_gather_ref(torch.from_numpy(table),
                                    torch.from_numpy(src))
    np.testing.assert_array_equal(out.numpy(), table[src])


@pytest.mark.parametrize("n,b", [(4096, 128), (4096, 512), (64, 3)])
def test_gather_segment_sum_ref_p4_accum(n, b):
    table, src, dst = p4_pattern(n, b)
    want = np.zeros((512, b), np.float64)
    np.add.at(want, dst, table[src].astype(np.float64))
    src_s, ptr = sort_by_dst(src, dst, 512)
    args = (torch.from_numpy(table), torch.from_numpy(src_s),
            torch.from_numpy(ptr))
    out = row_gather.gather_segment_sum(*args)
    assert out.shape == (512, b) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), want, rtol=1e-6)
    assert torch.equal(out, row_gather.gather_segment_sum_ref(*args))


def test_gather_segment_sum_ref_empty_segments():
    table = np.random.default_rng(1).random((10, 5), dtype=np.float32)
    # destinations 0, 2, 5 and 6 of 7 receive nothing
    dst = np.array([4, 1, 3, 1, 4, 4], np.int32)
    src = np.array([9, 0, 2, 7, 5, 0], np.int32)
    src_s, ptr = sort_by_dst(src, dst, 7)
    out = row_gather.gather_segment_sum(
        torch.from_numpy(table), torch.from_numpy(src_s),
        torch.from_numpy(ptr)).numpy()
    want = np.zeros((7, 5), np.float32)
    np.add.at(want, dst, table[src])
    np.testing.assert_allclose(out, want, atol=1e-6)
    assert not out[[0, 2, 5, 6]].any()


def test_cpu_never_launches(graphs, monkeypatch):
    """Every sparse operator on a CPU graph takes the plain path."""
    monkeypatch.setattr(row_gather, "segment_sum_launches", 0)
    monkeypatch.setattr(row_gather, "gather_launches", 0)
    monkeypatch.setattr(probe, "launches", 0)
    _, tg = graphs["got_sparse"]
    a = torch.rand((4, tg.n_pad))
    tspmv.push_out(tg, a)
    tspmv.pull_out_norm(tg, a)
    tspmv.push_out_chunked_t(tg, a.T.contiguous(), num_chunks=3)
    row_gather.row_gather(a.T.contiguous(), torch.arange(5, dtype=torch.int32))
    assert row_gather.segment_sum_launches == row_gather.gather_launches \
        == probe.launches == 0


def test_other_devices_raise():
    table = torch.zeros((4, 2), device="meta")
    idx = torch.zeros(3, dtype=torch.int32, device="meta")
    ptr = torch.zeros(5, dtype=torch.int64, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        row_gather.gather_segment_sum(table, idx, ptr)
    with pytest.raises(ValueError, match="unsupported device"):
        row_gather.row_gather(table, idx)
    # the spmv dispatch never sends a non-CPU operand down the plain path
    with pytest.raises(ValueError, match="unsupported device"):
        tspmv.gather_segment_sum(table, idx, ptr, num_chunks=4)


# --- the sweeps ------------------------------------------------------------

def jax_forward(jg, sources, rmax):
    s = jnp.asarray(sources, jnp.int32)
    p, r, oh = jpush.forward_push_init(jg, s)
    p, r, sweeps = jpush.forward_push_sweeps(jg, p, r, oh, jnp.float32(rmax),
                                             ALPHA)
    p, r = jpush.apply_dangling_source_shortcircuit(jg, s, p, r, oh)
    return np.asarray(p), np.asarray(r), int(sweeps)


def port_forward(tg, sources, rmax):
    s = torch.as_tensor(sources, dtype=torch.int32)
    p, r, oh = tpush.forward_push_init(tg, s)
    p, r, sweeps = tpush.forward_push_sweeps(tg, p, r, oh, rmax, ALPHA)
    p, r = tpush.apply_dangling_source_shortcircuit(tg, s, p, r, oh)
    return p.numpy(), r.numpy(), sweeps


@pytest.mark.parametrize("rmax", [1e-4, 1e-8])
@pytest.mark.parametrize("kind", ["tiny", "got", "got_sparse"])
def test_forward_push_sweeps_match_jax(graphs, kind, rmax):
    jg, tg = graphs[kind]
    sources = (np.array([0, 4, 1, 2, 3, 5]) if kind == "tiny"
               else sources_for(jg, 12, 3))
    jp, jr, jsweeps = jax_forward(jg, sources, rmax)
    tp, tr, tsweeps = port_forward(tg, sources, rmax)
    assert tsweeps == jsweeps > 0
    np.testing.assert_allclose(tp, jp, atol=1e-6)
    np.testing.assert_allclose(tr, jr, atol=1e-6)
    np.testing.assert_allclose((tp + tr).sum(-1), 1.0, atol=1e-5)
    # the dangling source (tiny: node 4) short-circuits to e_s
    dangling = np.asarray(jg.out_deg)[sources] == 0
    assert dangling.any()
    for row in np.nonzero(dangling)[0]:
        assert tp[row, sources[row]] == 1.0 and tp[row].sum() == 1.0
        assert not tr[row].any()


def test_forward_push_restarts_with_smaller_rmax(graphs):
    """A second call with a smaller rmax refines, as the JAX loop does."""
    jg, tg = graphs["got_sparse"]
    sources = sources_for(jg, 4, 5)
    s = torch.as_tensor(sources, dtype=torch.int32)
    p, r, oh = tpush.forward_push_init(tg, s)
    p, r, first = tpush.forward_push_sweeps(tg, p, r, oh, 1e-3, ALPHA)
    p, r, second = tpush.forward_push_sweeps(tg, p, r, oh, 1e-6, ALPHA)
    js = jnp.asarray(sources, jnp.int32)
    jp, jr, joh = jpush.forward_push_init(jg, js)
    jp, jr, jfirst = jpush.forward_push_sweeps(jg, jp, jr, joh,
                                               jnp.float32(1e-3), ALPHA)
    jp, jr, jsecond = jpush.forward_push_sweeps(jg, jp, jr, joh,
                                                jnp.float32(1e-6), ALPHA)
    assert (first, second) == (int(jfirst), int(jsecond))
    np.testing.assert_allclose(p.numpy(), np.asarray(jp), atol=1e-6)


def test_max_sweeps_caps_the_count(graphs):
    jg, tg = graphs["got"]
    sources = sources_for(jg, 5, 6)
    s = torch.as_tensor(sources, dtype=torch.int32)
    p, r, oh = tpush.forward_push_init(tg, s)
    _, _, sweeps = tpush.forward_push_sweeps(tg, p, r, oh, 1e-8, ALPHA,
                                             max_sweeps=11)
    js = jnp.asarray(sources, jnp.int32)
    jp, jr, joh = jpush.forward_push_init(jg, js)
    _, _, jsweeps = jpush.forward_push_sweeps(jg, jp, jr, joh,
                                              jnp.float32(1e-8), ALPHA,
                                              max_sweeps=11)
    assert sweeps == int(jsweeps) == 11


@pytest.mark.parametrize("rmax", [1e-4, 1e-8])
@pytest.mark.parametrize("kind", ["tiny", "got", "got_sparse"])
def test_backward_push_sweeps_match_jax(graphs, kind, rmax):
    jg, tg = graphs[kind]
    targets = (np.array([0, 3, 2, 5, 4]) if kind == "tiny"
               else sources_for(jg, 12, 7))
    oh = np.eye(jg.n_pad, dtype=np.float32)[targets]
    jp, jr, jsweeps = jpush.backward_push_sweeps(
        jg, jnp.zeros_like(oh), jnp.asarray(oh), jnp.float32(rmax), ALPHA)
    tp, tr, tsweeps = tpush.backward_push_sweeps(
        tg, torch.zeros_like(torch.from_numpy(oh)), torch.from_numpy(oh),
        rmax, ALPHA)
    assert tsweeps == int(jsweeps) > 0
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=1e-6)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), atol=1e-6)
    # the strict gate: nothing above rmax is left
    assert (tr.numpy() <= np.float32(rmax)).all()


@pytest.mark.parametrize("kind", ["tiny", "got", "got_sparse"])
def test_backward_search_batch_matches_jax(graphs, kind):
    jg, tg = graphs[kind]
    targets = (np.arange(6) if kind == "tiny" else sources_for(jg, 9, 8))
    jp, jr = jbws.backward_search_batch(jg, jnp.asarray(targets, jnp.int32),
                                        jnp.float32(1e-6), ALPHA)
    tp, tr = tbws.backward_search_batch(
        tg, torch.as_tensor(targets, dtype=torch.int32), 1e-6, ALPHA)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=1e-6)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), atol=1e-6)
    # a target without in-edges short-circuits to e_t
    no_in = np.asarray(jg.in_deg)[targets] == 0
    assert no_in.any()
    for row in np.nonzero(no_in)[0]:
        assert tp[row, targets[row]] == 1.0 and tp[row].sum() == 1.0
        assert not tr[row].any()


def test_backward_search_duration_and_host_rows(graphs):
    jg, tg = graphs["got_sparse"]
    bws = tbws.BackwardSearch(tg, ALPHA, rmax=1e-6)
    rows = bws.whole_graph(np.array([2, 9, 33]))
    ref = jbws.BackwardSearch(jg, ALPHA, rmax=1e-6).whole_graph(
        np.array([2, 9, 33]))
    assert isinstance(rows, np.ndarray)
    np.testing.assert_allclose(rows, ref, atol=1e-6)
    assert bws.get_duration() > 0


def test_zero_indeg_shortcircuit_small_graph():
    # node 3 has no in-edges (tests/test_push.py's case, on the port)
    g = build_graph(np.array([3, 0, 1]), np.array([0, 1, 0]), n=4,
                    device="cpu")
    reserve = tbws.BackwardSearch(g, ALPHA, rmax=1e-6).whole_graph(
        np.array([3]))
    assert reserve[0, 3] == 1.0 and reserve[0].sum() == 1.0
