"""Dataset loading — port of ``ppr_tpu/graph/io.py``.

Neo4j-import CSV pairs, SNAP edge lists (weighted or not) and seeded
synthetic graphs (uniform or weighted), loaded straight into a
:class:`~ppr_tpu_torch.graph.csr.Graph` on the chosen device
(``device=None``: the card, an error when none is visible; ``device="cpu"``
for the CPU). The generators are numpy, so a seed gives the same edges and
weights as the JAX package. A Neo4j store directory is read by
``graph/neostore.py``.
"""

from __future__ import annotations

import csv
import dataclasses
import os
from pathlib import Path

import numpy as np

from .. import native
from .csr import Graph, build_graph

# Default location of the reference GOT dataset (GOT_Nodes.csv and
# GOT_Rels.csv) in the repository; load_default falls back to a seeded
# synthetic graph while it is absent.
REFERENCE_GOT_DIR = str(Path(__file__).resolve().parents[2] / "dataset"
                        / "got")


@dataclasses.dataclass(frozen=True)
class Dataset:
    """A loaded graph plus host-side metadata."""

    graph: Graph
    names: list[str]            # dense node id -> display name
    name: str                   # dataset name, used for result-file prefixes

    @property
    def n(self) -> int:
        return self.graph.n


def _strip_bom(s: str) -> str:
    return s.lstrip("﻿")


def load_neo4j_csv(
    nodes_csv: str,
    rels_csv: str,
    *,
    name: str | None = None,
    dense_threshold: int = 4096,
    device=None,
) -> Dataset:
    """Load a Neo4j-admin-import CSV pair (``:ID,...`` /
    ``:START_ID,:END_ID,...``); node ids are remapped to 0..n-1 in file
    order."""
    ids: list[str] = []
    names: list[str] = []
    with open(nodes_csv, newline="", encoding="utf-8") as f:
        reader = csv.reader(f)
        header = [_strip_bom(h).strip() for h in next(reader)]
        id_col = header.index(":ID")
        name_col = header.index("name") if "name" in header else id_col
        for row in reader:
            if not row:
                continue
            ids.append(row[id_col])
            names.append(row[name_col])
    id_map = {node_id: i for i, node_id in enumerate(ids)}

    src, dst = [], []
    with open(rels_csv, newline="", encoding="utf-8") as f:
        reader = csv.reader(f)
        header = [_strip_bom(h).strip() for h in next(reader)]
        s_col = header.index(":START_ID")
        e_col = header.index(":END_ID")
        for row in reader:
            if not row:
                continue
            src.append(id_map[row[s_col]])
            dst.append(id_map[row[e_col]])

    graph = build_graph(
        np.asarray(src, np.int64), np.asarray(dst, np.int64), n=len(ids),
        dense_threshold=dense_threshold, device=device,
    )
    if name is None:
        name = os.path.splitext(os.path.basename(nodes_csv))[0]
    return Dataset(graph=graph, names=names, name=name)


def load_edge_list(
    path: str,
    *,
    name: str | None = None,
    comment: str = "#",
    dense_threshold: int = 4096,
    weighted: bool = False,
    device=None,
) -> Dataset:
    """Load a whitespace-separated ``src dst [weight]`` edge list (SNAP
    style); ids are densely remapped in first-appearance order. An
    unweighted file is parsed by the native C++ reader where it is
    available (``ppr_tpu_torch/native``), else in Python; ``weighted=True``
    reads a third column of positive edge weights (1.0 where a line has
    none), in Python, as the JAX package does."""
    weights = None
    cap = max(os.path.getsize(path) // 3 + 16, 1024)
    parsed = None if weighted else native.parse_edge_list_native(path, cap)
    if parsed is not None:
        raw_src, raw_dst = parsed
    else:
        raw_src, raw_dst, weights = parse_edge_list_python(
            path, comment=comment, weighted=weighted)

    # dense remap in first-appearance order over the interleaved endpoints
    stacked = np.empty(raw_src.size * 2, np.int64)
    stacked[0::2] = raw_src
    stacked[1::2] = raw_dst
    uniq, first_pos = np.unique(stacked, return_index=True)
    uniq_in_order = uniq[np.argsort(first_pos, kind="stable")]
    lookup = np.empty(uniq.max() + 1 if uniq.size else 1, np.int64)
    lookup[uniq_in_order] = np.arange(uniq_in_order.size)

    graph = build_graph(lookup[raw_src], lookup[raw_dst],
                        n=uniq_in_order.size, weights=weights,
                        dense_threshold=dense_threshold, device=device)
    if name is None:
        name = os.path.splitext(os.path.basename(path))[0]
    names = [str(int(orig)) for orig in uniq_in_order]
    return Dataset(graph=graph, names=names, name=name)


def parse_edge_list_python(path: str, *, comment: str = "#",
                           weighted: bool = False):
    """``(src, dst, weights)`` of an edge-list file parsed in Python, the
    path without a compiler (``weights`` ``None`` unless ``weighted``)."""
    src_l, dst_l, w_l = [], [], []
    with open(path, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith(comment):
                continue
            parts = line.split()
            src_l.append(int(parts[0]))
            dst_l.append(int(parts[1]))
            if weighted:
                w_l.append(float(parts[2]) if len(parts) > 2 else 1.0)
    weights = np.asarray(w_l, np.float64) if weighted else None
    return np.asarray(src_l, np.int64), np.asarray(dst_l, np.int64), weights


def load_got(got_dir: str = REFERENCE_GOT_DIR, **kwargs) -> Dataset:
    """Load the GOT benchmark dataset (107 nodes / 352 edges)."""
    return load_neo4j_csv(
        os.path.join(got_dir, "GOT_Nodes.csv"),
        os.path.join(got_dir, "GOT_Rels.csv"),
        name=kwargs.pop("name", "got"),
        **kwargs,
    )


def synthetic_powerlaw(
    n: int,
    avg_deg: int = 16,
    *,
    seed: int = 0,
    name: str | None = None,
    dense_threshold: int = 4096,
    dangling_frac: float = 0.01,
    device=None,
) -> Dataset:
    """Seeded scale-free-ish directed graph: uniform sources, Zipf-weighted
    destinations over a random permutation, self-loops dropped, and a
    ``dangling_frac`` share of nodes forced to out-degree 0. The same seed
    gives the same edges as ``ppr_tpu.graph.io.synthetic_powerlaw``."""
    rng = np.random.default_rng(seed)
    m = n * avg_deg
    ranks = rng.permutation(n).astype(np.float64)
    weights = 1.0 / (ranks + 10.0)
    weights /= weights.sum()
    src = rng.integers(0, n, size=m, dtype=np.int64)
    dst = rng.choice(n, size=m, p=weights).astype(np.int64)
    keep = src != dst
    src, dst = src[keep], dst[keep]

    if dangling_frac > 0:
        n_dangle = max(1, int(n * dangling_frac))
        dangling = rng.choice(n, size=n_dangle, replace=False)
        mask = ~np.isin(src, dangling)
        src, dst = src[mask], dst[mask]

    graph = build_graph(src, dst, n=n, dense_threshold=dense_threshold,
                        device=device)
    return Dataset(
        graph=graph,
        names=[str(i) for i in range(n)],
        name=name or f"synth_{n}_{seed}",
    )


def synthetic_weighted(n: int, avg_deg: int = 8, *, seed: int = 0,
                       name: str | None = None,
                       dense_threshold: int = 4096,
                       device=None) -> Dataset:
    """Seeded weighted graph: :func:`synthetic_powerlaw`'s edges with
    log-normal weights. The generator is seeded, then the base graph is
    built, then one weight is drawn for each edge in its source-sorted
    order, as ``ppr_tpu.graph.io.synthetic_weighted`` does, so one seed
    gives both packages the same weighted graph."""
    rng = np.random.default_rng(seed)
    base = synthetic_powerlaw(n, avg_deg, seed=seed, dense_threshold=0,
                              device="cpu")
    g = base.graph
    src = g.edge_src[: g.m].numpy().astype(np.int64)
    dst = g.edge_dst[: g.m].numpy().astype(np.int64)
    w = rng.lognormal(0.0, 1.0, size=g.m)
    graph = build_graph(src, dst, n=n, weights=w,
                        dense_threshold=dense_threshold, device=device)
    return Dataset(graph=graph, names=base.names,
                   name=name or f"wsynth_{n}_{seed}")


def load_default(prefer_got: bool = True, **kwargs) -> Dataset:
    """GOT if its CSVs are in the repository (``dataset/got``), else a
    seeded 107-node synthetic graph, the JAX package's fallback."""
    if prefer_got and os.path.exists(
            os.path.join(REFERENCE_GOT_DIR, "GOT_Nodes.csv")):
        return load_got(**kwargs)
    return synthetic_powerlaw(107, avg_deg=3, seed=7, name="got_fallback",
                              **kwargs)
