"""The plain reference against hand-solved graphs, the judge's numbers on
hand-made answers, the control (the reference in bfloat16) failing the
check, and a whole run failing it with the timed path broken."""

import math

import numpy as np
import pytest
import torch

from benchmark import graphgen, reference, run

ALPHA = 0.15


def test_two_node_cycle_by_hand():
    # 0 <-> 1: pi(0, 0) = alpha / (1 - (1-alpha)^2), pi(0, 1) = (1-alpha)
    # pi(0, 0)
    op = reference.Operator(np.array([0, 1]), np.array([1, 0]), 2, "cpu")
    col = reference.ppr(op, [0], ALPHA)[:, 0].numpy()
    p00 = ALPHA / (1 - (1 - ALPHA) ** 2)
    assert col == pytest.approx([p00, (1 - ALPHA) * p00], abs=1e-12)


def test_dangling_mass_returns_to_the_source_by_hand():
    # 0 -> 1, 1 dangling: pi(0, 1) = (1-alpha) pi(0, 0) and every visit to
    # 1 returns (1-alpha) of it to 0: pi(0, 0) = alpha + (1-alpha)^2 pi(0,0)
    # + (1-alpha) pi(0, 0)(1 - ...): solve x = alpha + (1-alpha) * y,
    # y = (1-alpha) x  ->  x = alpha / (1 - (1-alpha)^2)
    op = reference.Operator(np.array([0]), np.array([1]), 2, "cpu")
    col = reference.ppr(op, [0], ALPHA)[:, 0].numpy()
    x = ALPHA / (1 - (1 - ALPHA) ** 2)
    assert col == pytest.approx([x, (1 - ALPHA) * x], abs=1e-12)
    assert col.sum() == pytest.approx(1.0, abs=1e-12)


def test_six_nodes_against_the_linear_system():
    # 0->1, 0->2, 1->2, 2->0, 3->0, 4 dangling, 5->3: pi solves
    # pi = alpha e_s + (1-alpha) (P^T pi + (pi . dangling) e_s)
    src = np.array([0, 0, 1, 2, 3, 5])
    dst = np.array([1, 2, 2, 0, 0, 3])
    n = 6
    P = np.zeros((n, n))
    deg = np.bincount(src, minlength=n)
    for s, d in zip(src, dst):
        P[s, d] += 1.0 / deg[s]
    op = reference.Operator(src, dst, n, "cpu")
    cols = reference.ppr(op, list(range(n)), ALPHA).numpy()
    for s in range(n):
        e = np.eye(n)[s]
        A = np.eye(n) - (1 - ALPHA) * (P.T + np.outer(e, deg == 0))
        assert cols[:, s] == pytest.approx(np.linalg.solve(A, ALPHA * e),
                                           abs=1e-12)


def test_hits_with_ties():
    col = np.array([0.5, 0.2, 0.2, 0.1, 0.0])
    assert reference.hits_with_ties(col, 2) == [(0, 0.5), (1, 0.2), (2, 0.2)]
    assert reference.hits_with_ties(col, 9) == [(0, 0.5), (1, 0.2), (2, 0.2),
                                                (3, 0.1)]


EXACT = np.array([0.4, 0.2, 0.15, 0.1, 0.05, 0.01] + [0.0] * 94)


def test_judge_row_on_hand_made_answers():
    k, eps = 3, 0.5
    good = [(0, 0.4), (1, 0.2), (2, 0.15)]
    assert reference.judge_row(good, EXACT, k, eps) == \
        {"over": 0.0, "miss": 0.0, "malformed": 0}
    # a lower bound within FORA's reach: node 3 left out by 0.1 - 0.08
    low = [(0, 0.39), (1, 0.19), (3, 0.08)]
    r = reference.judge_row(low, EXACT, k, eps)
    den = 0.25 * 0.08 / 0.75 + 0.25 / 100
    assert r["miss"] == pytest.approx((0.15 - 0.08) / den)
    assert r["over"] == 0.0
    # a score above the exact value
    high = [(0, 0.5), (1, 0.2), (2, 0.15)]
    assert reference.judge_row(high, EXACT, k, eps)["over"] == \
        pytest.approx(0.1 / (0.25 * 0.4))
    # too short: the floor is 0, every left-out node counts
    short = [(0, 0.4)]
    assert reference.judge_row(short, EXACT, k, eps)["miss"] == \
        pytest.approx(0.2 / (0.25 / 100))
    for bad in ([(0, 0.4), (0, 0.4), (1, 0.2)], [(100, 0.1)],
                [(0, math.nan)]):
        assert reference.judge_row(bad, EXACT, k, eps)["malformed"] == 1


def test_the_control_in_float64_is_the_reference():
    """The control's path, run in the reference's own precision, reads
    nothing."""
    n, m = 2000, 30000
    src, dst = graphgen.generate(n, m, 11, max_degree=300)
    sources = np.random.default_rng(11).integers(0, n, 16)
    op = reference.Operator(src, dst, n, "cpu")
    ctl = reference.control_answers(src, dst, n, sources, ALPHA, 10, "cpu",
                                    dtype=torch.float64)
    worst = reference.judge(ctl, op, ALPHA, 10, 0.5)
    assert worst["over"] < 1e-9 and worst["miss"] < 1e-9


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["flickr.batch"])
def test_the_control_fails_the_check_at_the_cells_size(workload):
    """The reference in bfloat16 in the program's place, at the cell's own
    graph, on the card: its answers read above a limit."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    from benchmark.manifest import Manifest

    man = Manifest()
    cfg = man.config(man.cell(workload))
    n = cfg["nodes"]
    src, dst = graphgen.draw(cfg, 21)
    sources = np.random.default_rng(21).integers(0, n, 64)
    op = reference.Operator(src, dst, n, "cuda")
    ctl = reference.control_answers(src, dst, n, sources, ALPHA,
                                    cfg["engine"]["k"], "cuda")
    worst = reference.judge(ctl, op, ALPHA, cfg["engine"]["k"],
                            cfg["engine"]["eps"])
    assert any(worst[k] > reference.LIMITS[k] for k in ("over", "miss")), \
        worst


def _cell(man, monkeypatch=None, workload="tiny.batch"):
    return run.run_cell(man, workload, 77, 0.5, False, torch.device("cpu"))


def test_a_sound_tiny_run_is_correct(tiny_manifest):
    out = _cell(tiny_manifest)
    assert out["correct"], out["checks"]
    assert list(out)[-1] == "checks"


def _unchanged(pushed, r, src, dang, state):
    return r, r.sum(dim=0)


def _half_batch(real):
    def top_k(self, sources, *a, **kw):
        sources = list(sources)
        half = real(self, sources[: (len(sources) + 1) // 2], *a, **kw)
        return (half * 2)[: len(sources)]
    return top_k


def _altered(real):
    def epilogue(*a, **kw):
        vals, ids = real(*a, **kw)
        return vals, (ids + 1) % a[0].n
    return epilogue


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch",
                                   "answer_altered"])
def test_a_broken_timed_path_is_not_correct(tiny_manifest, monkeypatch,
                                            fault):
    """The rest of a run, the harness's look for a card skipped, with the
    timed path broken underneath: a sweep that returns its state unchanged
    (the annealed loop's post pass handing back the old residue), half of
    each batch computed and its answers handed to the rest, a node id
    altered where the answer is produced. (One card: no exchange between
    chips exists to leave out.)"""
    from ppr_tpu_torch.models import fora
    from ppr_tpu_torch.ops import sweep_pass
    from ppr_tpu_torch.service import PPRService

    if fault == "state_unchanged":
        monkeypatch.setattr(sweep_pass, "sweep_post", _unchanged)
    elif fault == "half_batch":
        monkeypatch.setattr(PPRService, "top_k",
                            _half_batch(PPRService.top_k))
    else:
        monkeypatch.setattr(fora, "_device_topk_epilogue",
                            _altered(fora._device_topk_epilogue))
    out = _cell(tiny_manifest)
    assert not out["correct"], out["checks"]


def test_an_altered_served_answer_is_not_correct(tiny_manifest, monkeypatch):
    from ppr_tpu_torch.models import fora

    monkeypatch.setattr(fora, "_device_topk_epilogue",
                        _altered(fora._device_topk_epilogue))
    out = _cell(tiny_manifest, workload="tiny.serve")
    assert not out["correct"], out["checks"]
