"""The annealed loop's fused passes (``ops/sweep_pass.py``,
``csrc/sweep_pass.cu``) against the loop's operators before the fusion.

On the CPU the wrappers run their plain versions: each is held bit for bit
to the operator sequence it replaces, and the whole loop to the loop as it
was (:func:`old_loop`, kept here as the reference), on sparse, dense and
weighted graphs, with an f32 or a bf16 hub split or none. The ``cuda``
cases hold each kernel to its plain version on the card: ``p``, the scaled
operand, its bf16 copy and the new residue bit for bit, the counts exactly,
the column sums within f32 reassociation (the kernel adds in another,
fixed order: two launches give the same bits), and the whole loop to
:func:`old_loop` on the card: the same stopping sweep, the same bits in
``p`` and ``r`` and the same top-k id sets. This file imports no JAX:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_sweep_pass.py
"""

import numpy as np
import pytest
import torch

from ppr_tpu_torch.graph.io import (load_default, synthetic_powerlaw,
                                    synthetic_weighted)
from ppr_tpu_torch.models import fora
from ppr_tpu_torch.ops import sweep_pass
from ppr_tpu_torch.ops.hub_split import build_hub_split
from ppr_tpu_torch.ops.push import forward_push_init
from ppr_tpu_torch.ops.spmv import _safe_inv_deg
from ppr_tpu_torch.utils import timer

ALPHA, EPS, K = 0.15, 0.25, 10


def old_loop(g, p, r, src_onehot, eps, delta0, min_delta, k, alpha, hs=None,
             num_chunks=1, early_exit=False):
    """``annealed_topk_propagate`` as it was before the fusion: the
    reference the fused loop is held to, bit for bit."""
    dev = p.device
    f32 = torch.float32
    alpha_f, keep, eps_f, thresh_scale = fora._loop_constants(alpha, eps)
    p_t = p.T.contiguous()
    r_t = r.T.contiguous()
    src_t = src_onehot.T.contiguous()
    delta = torch.tensor(delta0, dtype=f32, device=dev)
    finished = torch.zeros((), dtype=torch.bool, device=dev)
    it = torch.zeros((), dtype=torch.int32, device=dev)
    for sweep in range(fora.MAX_TOPK_SWEEPS):
        live = ~finished
        p_t = torch.addcmul(p_t, r_t, live * alpha_f)
        r_new = fora._push_residue(g, r_t, src_t, keep, hs, num_chunks)
        r_t = torch.where(live, r_new, r_t)
        settled = live & (r_t.sum(dim=0).max() <= eps_f * delta)
        thresh = thresh_scale * delta
        done = settled & ((p_t >= thresh).sum(dim=0) >= k).all()
        if early_exit and (sweep + 1) % fora.EARLY_CHECK_EVERY == 0:
            done = done | fora._set_stable(p_t, r_t, k).all()
        finished = finished | done | (settled & (delta <= min_delta))
        delta = torch.where(settled & ~finished,
                            torch.clamp_min(delta / 4.0, min_delta), delta)
        it = it + live.to(torch.int32)
        if (sweep + 1) % fora.CHECK_EVERY == 0 and bool(finished):
            break
    return p_t.T, r_t.T, it, sweep + 1


def graph(kind, dev):
    if kind == "dense":
        return load_default(device=dev).graph
    if kind == "weighted":
        return synthetic_weighted(1024, 8, seed=1, dense_threshold=0,
                                  device=dev).graph
    if kind == "nodang":
        return synthetic_powerlaw(2048, 8, seed=5, dense_threshold=0,
                                  dangling_frac=0.0, device=dev).graph
    return synthetic_powerlaw(2048, 8, seed=3, dense_threshold=0,
                              device=dev).graph


def hubs(g, split):
    if split is None:
        return None
    return build_hub_split(g, 128, dtype=getattr(torch, split))


def start(g, b, seed=1):
    """``(p, r, src_onehot)`` of ``b`` sources, a dangling one among them
    where the graph has one."""
    rng = np.random.default_rng(seed)
    s = rng.integers(0, g.n, b)
    if g.dang_ids.numel():
        s[min(1, b - 1)] = int(g.dang_ids[0])
    sources = torch.as_tensor(s, dtype=torch.int32, device=g.device)
    p, r, oh = forward_push_init(g, sources)
    return torch.zeros_like(p), r, oh


def run(loop, g, b, split, *, eps=EPS, early_exit=False, num_chunks=1):
    p, r, oh = start(g, b)
    return loop(g, p, r, oh, eps, 0.1, 1.0 / g.n, K, ALPHA,
                hs=hubs(g, split), num_chunks=num_chunks,
                early_exit=early_exit)


def state_at(dev, delta, finished, it=3):
    return sweep_pass.LoopState(
        delta=torch.tensor(delta, dtype=torch.float32, device=dev),
        finished=torch.tensor(finished, device=dev),
        it=torch.tensor(it, dtype=torch.int32, device=dev),
        scratch=(torch.zeros(3, dtype=torch.int32, device=dev)
                 if torch.device(dev).type == "cuda" else None))


def pass_inputs(dev, n_rows, b, seed=0):
    """A state of the loop's magnitudes: reserves and residues in [0,
    2/n], a tenth of each zero; out-degrees with zeros (dangling rows)."""
    rng = np.random.default_rng(seed)

    def draw():
        x = rng.random((n_rows, b)).astype(np.float32) * (2.0 / n_rows)
        x[rng.random((n_rows, b)) < 0.1] = 0.0
        return torch.as_tensor(x, device=dev)

    deg = torch.as_tensor(rng.integers(0, 40, n_rows).astype(np.int32),
                          device=dev)
    src = torch.as_tensor(rng.integers(0, n_rows, b).astype(np.int32),
                          device=dev)
    return draw(), draw(), draw(), _safe_inv_deg(deg), src


# --- CPU: the plain versions are the old operators ---------------------------

@pytest.mark.parametrize("finished", [False, True])
@pytest.mark.parametrize("scale,bf16", [(True, False), (True, True),
                                        (False, False)])
def test_plain_pre_is_the_old_operators(finished, scale, bf16):
    p, r, _, inv, _ = pass_inputs("cpu", 300, 24)
    alpha_f, keep, _, ts = fora._loop_constants(ALPHA, EPS)
    state = state_at("cpu", 2.0 / 300, finished)
    got_p, scaled, rhs, counts = sweep_pass.sweep_pre(
        p, r, state, inv if scale else None, alpha=alpha_f, keep=keep,
        thresh_scale=ts, bf16=bf16)
    live = ~state.finished
    want_p = torch.addcmul(p, r, live * alpha_f)
    rem = r * keep
    want_s = rem * inv[:, None] if scale else rem
    assert torch.equal(got_p, want_p)
    assert torch.equal(scaled, want_s)
    if bf16:
        assert torch.equal(rhs, want_s.to(torch.bfloat16))
    else:
        assert rhs is None
    assert torch.equal(counts, (want_p >= ts * state.delta).sum(dim=0))


@pytest.mark.parametrize("finished", [False, True])
@pytest.mark.parametrize("dangling", [True, False])
def test_plain_post_is_the_old_operators(finished, dangling):
    _, r, pushed, _, src = pass_inputs("cpu", 300, 24, seed=2)
    state = state_at("cpu", 0.01, finished)
    dang = (r[:7] * 0.85).sum(dim=0) if dangling else None
    onehot_t = torch.nn.functional.one_hot(src.long(), 300).float().T
    want = pushed.clone()
    if dangling:
        want = want.addcmul_(dang[None, :], onehot_t)
    want = torch.where(~state.finished, want, r)
    got, sums = sweep_pass.sweep_post(pushed.clone(), r, src, dang, state)
    assert torch.equal(got, want)
    assert torch.equal(sums, want.sum(dim=0))


@pytest.mark.parametrize("delta,finished,largest,short,stable", [
    (0.1, False, 0.01, False, None),      # settled, done
    (0.1, False, 0.01, True, None),       # settled, anneals
    (0.1, False, 0.5, False, None),       # not settled
    (1e-4, False, 1e-6, True, None),      # settled at min_delta: stops
    (0.1, True, 0.01, False, None),       # frozen
    (0.1, False, 0.5, True, True),        # the certificate stops it
    (0.1, False, 0.5, True, False),
])
def test_plain_finalize_is_the_old_operators(delta, finished, largest, short,
                                             stable):
    b = 16
    sums = torch.full((b,), largest / 2, dtype=torch.float32)
    sums[5] = largest
    counts = torch.full((b,), K + 2)
    if short:
        counts[3] = K - 1
    stable_t = None if stable is None else torch.tensor(stable)
    _, _, eps_f, _ = fora._loop_constants(ALPHA, EPS)
    min_delta = 1e-4
    state = state_at("cpu", delta, finished)
    d0, f0, it0 = state.delta, state.finished, state.it
    sweep_pass.sweep_finalize(state, counts, sums, k=K, eps=eps_f,
                              min_delta=min_delta, stable=stable_t)
    live = ~f0
    settled = live & (sums.max() <= eps_f * d0)
    done = settled & (counts >= K).all()
    if stable_t is not None:
        done = done | stable_t
    fin = f0 | done | (settled & (d0 <= min_delta))
    assert torch.equal(state.finished, fin)
    assert torch.equal(state.delta, torch.where(
        settled & ~fin, torch.clamp_min(d0 / 4.0, min_delta), d0))
    assert torch.equal(state.it, it0 + live.to(torch.int32))


LOOP_CASES = [("sparse", None, 16, 1), ("sparse", "float32", 16, 1),
              ("sparse", "bfloat16", 16, 1), ("sparse", "bfloat16", 3, 4),
              ("sparse", None, 16, 4), ("nodang", "bfloat16", 16, 1),
              ("dense", None, 16, 1), ("weighted", None, 16, 1),
              ("weighted", None, 16, 3)]


#: eps' at which the sparse graph's B 256 call stops on live sweep 62,
#: inside the block of 8 that ends at 64: two frozen sweeps run
FROZEN_EPS = 0.1


@pytest.mark.parametrize("early_exit", [False, True])
@pytest.mark.parametrize("kind,split,b,chunks", LOOP_CASES)
def test_loop_on_cpu_is_the_old_loop(kind, split, b, chunks, early_exit):
    g = graph(kind, "cpu")
    want_p, want_r, want_it, _ = run(old_loop, g, b, split,
                                     early_exit=early_exit,
                                     num_chunks=chunks)
    got_p, got_r, got_it = run(fora.annealed_topk_propagate, g, b, split,
                               early_exit=early_exit, num_chunks=chunks)
    assert int(got_it) == int(want_it)
    assert torch.equal(got_p, want_p)
    assert torch.equal(got_r, want_r)


def test_loop_on_cpu_with_frozen_sweeps_is_the_old_loop():
    g = graph("sparse", "cpu")
    want_p, want_r, want_it, sweeps = run(old_loop, g, 256, "bfloat16",
                                          eps=FROZEN_EPS)
    assert sweeps > int(want_it), "no frozen sweep ran"
    got_p, got_r, got_it = run(fora.annealed_topk_propagate, g, 256,
                               "bfloat16", eps=FROZEN_EPS)
    assert int(got_it) == int(want_it)
    assert torch.equal(got_p, want_p)
    assert torch.equal(got_r, want_r)


def counted(fn):
    """``fn()``'s result and the recorder's counters it added."""
    from torch.profiler import ProfilerActivity, profile

    before = timer.RECORDER.counters()
    with profile(activities=[ProfilerActivity.CPU]):
        out = fn()
    after = timer.RECORDER.counters()
    return out, {key: (v[0] - before.get(key, (0, 0))[0],
                       v[1] - before.get(key, (0, 0))[1])
                 for key, v in after.items()}


def test_no_fused_sweeps_on_cpu():
    g = graph("sparse", "cpu")
    before = (sweep_pass.pre_launches, sweep_pass.post_launches,
              sweep_pass.finalize_launches)
    (_, _, it), c = counted(lambda: run(fora.annealed_topk_propagate, g, 16,
                                        "bfloat16"))
    assert c["loop.fused_sweeps"] == (0, 1)
    assert c["loop.sweeps"][0] >= int(it) > 0
    assert (sweep_pass.pre_launches, sweep_pass.post_launches,
            sweep_pass.finalize_launches) == before


@pytest.mark.parametrize("n_rows,cols,aligned,sms", [
    (80640, 2048, True, 132), (80640, 256, True, 132), (80640, 8, True, 132),
    (2176, 13, True, 132), (2176, 16, False, 132), (128, 2048, True, 132),
    (5, 3, True, 4), (1, 1, False, 1)])
def test_plan_covers_the_state(n_rows, cols, aligned, sms):
    plan = sweep_pass.make_plan(n_rows, cols, aligned, sms)
    assert plan.vec == (4 if aligned and cols % 4 == 0 else 1)
    assert sweep_pass.THREADS % plan.tx == 0
    assert plan.gx * plan.tx * plan.vec >= cols
    assert (plan.gx - 1) * plan.tx * plan.vec < cols      # no empty tile
    ty = sweep_pass.THREADS // plan.tx
    assert 1 <= plan.gy <= 65535 and (plan.gy - 1) * ty < n_rows
    assert plan.gy <= -(-sms * sweep_pass.BLOCKS_PER_SM // plan.gx)


# --- the card: each kernel against its plain version --------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("finished", [False, True])
@pytest.mark.parametrize("scale,bf16", [(True, True), (True, False),
                                        (False, False)])
@pytest.mark.parametrize("n_rows,b", [(80640, 8), (80640, 256),
                                      (20000, 2048), (2176, 13)])
def test_pre_kernel_is_its_plain_version(cuda, n_rows, b, scale, bf16,
                                         finished):
    p, r, _, inv, _ = pass_inputs(cuda, n_rows, b)
    alpha_f, keep, _, ts = fora._loop_constants(ALPHA, EPS)
    kw = dict(alpha=alpha_f, keep=keep, thresh_scale=ts, bf16=bf16)
    state = state_at(cuda, 1.0 / n_rows, finished)
    want = sweep_pass.sweep_pre_ref(p, r, state, inv if scale else None,
                                    **kw)
    before = sweep_pass.pre_launches
    got = sweep_pass.sweep_pre(p.clone(), r, state, inv if scale else None,
                               **kw)
    torch.cuda.synchronize()
    assert sweep_pass.pre_launches == before + 1
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[1], want[1])
    if bf16:
        assert torch.equal(got[2], want[2])
    assert torch.equal(got[3].sum(dim=0), want[3].to(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("finished", [False, True])
@pytest.mark.parametrize("dangling", [True, False])
@pytest.mark.parametrize("n_rows,b", [(80640, 8), (80640, 256),
                                      (20000, 2048), (2176, 13)])
def test_post_kernel_is_its_plain_version(cuda, n_rows, b, dangling,
                                          finished):
    _, r, pushed, _, src = pass_inputs(cuda, n_rows, b, seed=4)
    dang = (r[:7] * 0.85).sum(dim=0) if dangling else None
    state = state_at(cuda, 0.01, finished)
    want_r, want_sums = sweep_pass.sweep_post_ref(pushed.clone(), r, src,
                                                  dang, state)
    got = []
    for _ in range(2):
        got.append(sweep_pass.sweep_post(pushed.clone(), r, src, dang,
                                         state))
    torch.cuda.synchronize()
    assert torch.equal(got[0][0], want_r)
    if not finished:
        assert torch.equal(got[0][1], got[1][1])     # the same bits twice
        torch.testing.assert_close(got[0][1].sum(dim=0), want_sums,
                                   rtol=1e-5, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("delta,finished,largest,short,stable", [
    (0.1, False, 0.01, False, None), (0.1, False, 0.01, True, None),
    (0.1, False, 0.5, False, None), (1e-4, False, 1e-6, True, None),
    (0.1, True, 0.01, False, None), (0.1, False, 0.5, True, True)])
@pytest.mark.parametrize("b", [8, 256, 2048])
def test_finalize_kernel_is_its_plain_version(cuda, b, delta, finished,
                                              largest, short, stable):
    rows = 37
    sums = torch.full((rows, b), largest / 2 / rows, device=cuda)
    sums[:, b // 2] = largest / rows
    counts = torch.zeros((rows, b), dtype=torch.int32, device=cuda)
    counts[rows // 2] = K + 2
    if short:
        counts[rows // 2, b - 1] = K - 1
    stable_t = (None if stable is None
                else torch.tensor(stable, device=cuda))
    _, _, eps_f, _ = fora._loop_constants(ALPHA, EPS)
    kw = dict(k=K, eps=eps_f, min_delta=1e-4, stable=stable_t)
    want = state_at(cuda, delta, finished)
    sweep_pass.sweep_finalize_ref(want, counts.sum(dim=0),
                                  sums.sum(dim=0), **kw)
    scratch = None
    for _ in range(2):      # the second launch reuses the first's scratch
        got = state_at(cuda, delta, finished)
        if scratch is not None:
            got.scratch = scratch
        scratch = got.scratch
        sweep_pass.sweep_finalize(got, counts, sums, **kw)
        torch.cuda.synchronize()
        assert torch.equal(got.finished, want.finished)
        assert torch.equal(got.delta, want.delta)
        assert torch.equal(got.it, want.it)
        assert int(scratch.abs().sum()) == 0


# --- the card: the whole loop against the loop before the fusion --------------

def top_sets(p, k=K):
    vals, ids = torch.topk(p, k, dim=1)
    return [set(row) for row in ids.cpu().tolist()]


@pytest.mark.cuda
@pytest.mark.parametrize("split", ["bfloat16", "float32", None])
@pytest.mark.parametrize("b", [8, 256, 2048])
def test_loop_on_card_is_the_old_loop(cuda, b, split):
    g = graph("sparse", cuda)
    want_p, want_r, want_it, want_sweeps = run(old_loop, g, b, split)
    (got_p, got_r, got_it), c = counted(
        lambda: run(fora.annealed_topk_propagate, g, b, split))
    assert int(got_it) == int(want_it)
    assert c["loop.sweeps"][0] == want_sweeps
    assert c["loop.fused_sweeps"][0] == c["loop.sweeps"][0]
    assert torch.equal(got_p, want_p)
    assert torch.equal(got_r, want_r)
    assert top_sets(got_p) == top_sets(want_p)


@pytest.mark.cuda
@pytest.mark.parametrize("kind,split", [("nodang", "bfloat16"),
                                        ("dense", None), ("weighted", None)])
def test_loop_on_card_other_graphs(cuda, kind, split):
    g = graph(kind, cuda)
    want_p, want_r, want_it, _ = run(old_loop, g, 16, split)
    got_p, got_r, got_it = run(fora.annealed_topk_propagate, g, 16, split)
    assert int(got_it) == int(want_it)
    assert torch.equal(got_p, want_p)
    assert torch.equal(got_r, want_r)


@pytest.mark.cuda
def test_loop_on_card_stops_inside_a_block(cuda):
    """A call whose last live sweep falls inside a block of
    ``CHECK_EVERY``, so frozen sweeps run before the stopping read; and
    the early-exit certificate."""
    g = graph("sparse", cuda)
    for early_exit in (False, True):
        want_p, want_r, want_it, sweeps = run(old_loop, g, 256, "bfloat16",
                                              eps=FROZEN_EPS,
                                              early_exit=early_exit)
        assert sweeps > int(want_it), "no frozen sweep ran"
        got_p, got_r, got_it = run(fora.annealed_topk_propagate, g, 256,
                                   "bfloat16", eps=FROZEN_EPS,
                                   early_exit=early_exit)
        assert int(got_it) == int(want_it)
        assert torch.equal(got_p, want_p)
        assert torch.equal(got_r, want_r)
