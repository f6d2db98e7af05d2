"""The port's walk engine (``ppr_tpu_torch/ops/walk.py``) against the JAX
package's.

JAX draws from threefry keys and the port from a ``torch.Generator``, so
walks agree in distribution, not one by one. Held exactly: the parts
without randomness (``default_max_steps``, ``expand_walkers``, one
``_uniform_neighbor`` step given the same uniforms). Held to f32 sums
(1e-6 relative): each row's deposits against its walkers' weights. Held
by distribution: the stop distribution within 5e-3 of the port's power
method at 200k walks, the bound of ``tests/test_walk.py``. Compaction off
(``compact_factor=1``, one phase) equals ``random_walks`` plus a scatter
for the same generator state, bit for bit."""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ppr_tpu.graph.csr import build_graph as jax_build
from ppr_tpu.ops import walk as jwalk
from ppr_tpu_torch.graph.csr import build_graph
from ppr_tpu_torch.graph.io import load_default, synthetic_powerlaw
from ppr_tpu_torch.models.power_method import power_method_batch
from ppr_tpu_torch.ops import walk as twalk

ALPHA = 0.15
TINY = (np.array([0, 0, 1, 2, 3, 5]), np.array([1, 2, 2, 0, 0, 5]), 6)


def gen(seed):
    g = torch.Generator(device="cpu")
    g.manual_seed(seed)
    return g


@pytest.fixture(scope="module")
def got():
    return load_default(device="cpu").graph


@pytest.fixture(scope="module")
def tiny():
    """0->1, 0->2, 1->2, 2->0, 3->0, 4 dangling, 5->5 (self loop)."""
    src, dst, n = TINY
    return build_graph(src, dst, n, device="cpu")


@pytest.mark.parametrize("alpha", [0.15, 0.2, 0.5, 0.99])
@pytest.mark.parametrize("tail", [1e-9, 1e-3, 0.5])
def test_default_max_steps_matches_jax(alpha, tail):
    assert twalk.default_max_steps(alpha, tail) == \
        jwalk.default_max_steps(alpha, tail)


@pytest.mark.parametrize("omega,cap", [
    ([2, 0, 3, 1], 8),             # total 6 below cap
    ([2, 0, 3, 1], 4),             # total past cap
    ([0, 0, 5, 0, 0], 5),          # zero rows around one, exactly full
    ([0, 0, 0], 4),                # no walks at all
    (list(range(7)) * 3, 64),
])
def test_expand_walkers_matches_jax(omega, cap):
    om = np.asarray(omega, np.int32)
    js, jv = jwalk.expand_walkers(jnp.asarray(om), cap)
    ts, tv = twalk.expand_walkers(torch.as_tensor(om), cap)
    assert tv.tolist() == np.asarray(jv).tolist()
    assert ts.tolist() == np.asarray(js).tolist()


def _graph_pair(src, dst, n):
    return (jax_build(np.asarray(src), np.asarray(dst), n=n),
            build_graph(src, dst, n, device="cpu"))


@pytest.mark.parametrize("case", ["tiny", "powerlaw", "edge_tail"])
def test_uniform_neighbor_matches_jax(case):
    """One step given the same uniforms: the same next node, a dangling
    node going back to its walker's start; ``edge_tail``'s dangling last
    node has ``indptr == m == m_pad``."""
    if case == "tiny":
        src, dst, n = TINY
    elif case == "powerlaw":
        rng = np.random.default_rng(4)
        n = 300
        src = rng.integers(0, n - 20, 1500)      # nodes >= 280 dangle
        dst = rng.integers(0, n, 1500)
    else:
        n = 3
        src, dst = np.zeros(128, np.int64), np.ones(128, np.int64)
    jg, tg = _graph_pair(src, dst, n)
    rng = np.random.default_rng(1)
    w = 4096
    cur = rng.integers(0, n, w).astype(np.int32)
    starts = rng.integers(0, n, w).astype(np.int32)
    u = rng.random(w, dtype=np.float32)
    u[:4] = [0.0, np.nextafter(np.float32(1), np.float32(0)), 0.5, 1e-8]
    want = jwalk._uniform_neighbor(jg, jnp.asarray(cur), jnp.asarray(u),
                                   jnp.asarray(starts))
    got = twalk._uniform_neighbor(tg, torch.as_tensor(cur),
                                  torch.as_tensor(u), torch.as_tensor(starts))
    assert got.tolist() == np.asarray(want).tolist()
    deg = np.bincount(src, minlength=n)
    dangling = deg[cur] == 0
    assert dangling.any() or case == "tiny"
    assert (got.numpy()[dangling] == starts[dangling]).all()
    # no_zero_hop's first hop is this step from the start itself
    first = twalk._uniform_neighbor(tg, torch.as_tensor(starts),
                                    torch.as_tensor(u),
                                    torch.as_tensor(starts))
    jfirst = jwalk._uniform_neighbor(jg, jnp.asarray(starts), jnp.asarray(u),
                                     jnp.asarray(starts))
    assert first.tolist() == np.asarray(jfirst).tolist()


def test_walk_stop_distribution_matches_oracle(got):
    s, w = 7, 200_000
    starts = torch.full((w,), s, dtype=torch.int32)
    stops = twalk.random_walks(got, starts, gen(0), ALPHA)
    counts = np.bincount(stops.numpy(), minlength=got.n_pad) / w
    oracle = power_method_batch(got, np.array([s], np.int32), ALPHA,
                                100).numpy()[0]
    assert np.abs(counts - oracle).max() < 5e-3
    rows = torch.zeros(w, dtype=torch.int64)
    compacted = twalk.weighted_walk_counts(
        got, starts, rows, torch.full((w,), 1.0 / w), gen(1), ALPHA, 1)
    assert np.abs(compacted.numpy()[0] - oracle).max() < 5e-3


def test_dangling_start_returns_start(tiny):
    starts = torch.full((256,), 4, dtype=torch.int32)
    assert (twalk.random_walks(tiny, starts, gen(1), ALPHA) == 4).all()


def test_no_zero_hop_never_stops_at_step_zero():
    """On a 2-cycle a plain walk from 0 stops there with probability
    alpha / (1 - (1-alpha)^2); a no-zero-hop walk needs two hops first."""
    g = build_graph(np.array([0, 1]), np.array([1, 0]), 2, device="cpu")
    starts = torch.zeros(100_000, dtype=torch.int32)
    plain = twalk.random_walks(g, starts, gen(2), ALPHA).numpy()
    nzh = twalk.random_walks(g, starts, gen(3), ALPHA,
                             no_zero_hop=True).numpy()
    p_plain = ALPHA / (1 - (1 - ALPHA) ** 2)
    assert abs((plain == 0).mean() - p_plain) < 5e-3
    assert (nzh == 0).mean() < (plain == 0).mean() - 0.05


@pytest.mark.parametrize("no_zero_hop", [False, True])
def test_weighted_walk_counts_conserves_row_mass(got, no_zero_hop):
    w = 4096
    rng = np.random.default_rng(0)
    starts = torch.as_tensor(rng.integers(0, got.n, w), dtype=torch.int32)
    rows = torch.as_tensor(rng.integers(0, 4, w))
    weights = torch.as_tensor(rng.random(w, dtype=np.float32))
    counts = twalk.weighted_walk_counts(got, starts, rows, weights, gen(0),
                                        ALPHA, 4, no_zero_hop=no_zero_hop)
    assert counts.shape == (4, got.n_pad) and (counts >= 0).all()
    want = np.bincount(rows.numpy(), weights.numpy().astype(np.float64), 4)
    np.testing.assert_allclose(counts.sum(dim=1).double().numpy(), want,
                               rtol=1e-6)
    assert not counts[:, got.n:].any()


def test_compaction_off_equals_random_walks_plus_scatter(got):
    w = 1024
    starts = torch.as_tensor(np.arange(w) % got.n, dtype=torch.int32)
    counts = twalk.weighted_walk_counts(
        got, starts, torch.zeros(w, dtype=torch.int64), torch.ones(w),
        gen(3), ALPHA, 1, phase_steps=10_000, compact_factor=1)
    stops = twalk.random_walks(got, starts, gen(3), ALPHA)
    want = np.zeros(got.n_pad, np.float32)
    np.add.at(want, stops.numpy(), 1.0)
    assert np.array_equal(counts.numpy()[0], want)


def test_compaction_narrows_to_lanes(monkeypatch):
    """A wide pool is compacted by a factor 4 each phase down to LANES,
    and still deposits every walker's weight."""
    g = synthetic_powerlaw(2048, 8, seed=3, dense_threshold=0,
                           device="cpu").graph
    widths = []
    real = torch.argsort

    def spy(x, *args, **kwargs):
        widths.append(x.shape[0])
        return real(x, *args, **kwargs)

    monkeypatch.setattr(twalk.torch, "argsort", spy)
    w = 1 << 13
    starts = torch.as_tensor(np.arange(w) % g.n, dtype=torch.int32)
    counts = twalk.weighted_walk_counts(
        g, starts, torch.zeros(w, dtype=torch.int64), torch.ones(w), gen(5),
        ALPHA, 1)
    assert widths[:3] == [w, w // 4, w // 16]
    assert all(x >= twalk.LANES for x in widths)
    assert abs(float(counts.sum()) - w) <= 1e-6 * w


def test_accumulate_stops_matches_jax():
    rng = np.random.default_rng(2)
    template = rng.random((3, 256), dtype=np.float32)
    stops = rng.integers(0, 256, 500).astype(np.int32)
    weights = rng.random(500, dtype=np.float32)
    want = jwalk.accumulate_stops(jnp.asarray(template), jnp.asarray(stops),
                                  jnp.asarray(weights))
    got = twalk.accumulate_stops(torch.as_tensor(template),
                                 torch.as_tensor(stops),
                                 torch.as_tensor(weights))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


def test_walk_determinism(got):
    starts = torch.arange(64, dtype=torch.int32) % got.n
    a = twalk.random_walks(got, starts, gen(9), ALPHA)
    b = twalk.random_walks(got, starts, gen(9), ALPHA)
    assert torch.equal(a, b)


def test_weighted_graph_raises():
    """A weighted graph's walks take the alias step (item 20, which raised
    until it was ported): they draw a second uniform a step, so a move
    without one raises; the walks themselves run."""
    from ppr_tpu_torch.graph.io import synthetic_weighted

    g = synthetic_weighted(200, 4, seed=1, device="cpu").graph
    starts = torch.arange(64, dtype=torch.int32) % g.n
    with pytest.raises(ValueError, match="second uniform"):
        twalk._uniform_neighbor(g, starts, torch.rand(64), starts)
    stops = twalk.random_walks(g, starts, gen(0), ALPHA)
    assert stops.shape == starts.shape and int(stops.max()) < g.n
    counts = twalk.weighted_walk_counts(g, starts, torch.zeros_like(starts),
                                        torch.full((64,), 1 / 64), gen(0),
                                        ALPHA, 1)
    assert abs(float(counts.sum()) - 1.0) < 1e-6