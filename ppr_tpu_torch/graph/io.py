"""Dataset loading — port of ``ppr_tpu/graph/io.py``.

Neo4j-import CSV pairs, SNAP edge lists and seeded synthetic graphs, loaded
straight into a :class:`~ppr_tpu_torch.graph.csr.Graph` on the chosen
device (``device=None``: the card, an error when none is visible;
``device="cpu"`` for the CPU). The generators are numpy, so a seed gives
the same edges as the JAX package.
"""

from __future__ import annotations

import csv
import dataclasses
import os
from pathlib import Path

import numpy as np

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
    """Load a whitespace-separated ``src dst`` edge list (SNAP style); ids
    are densely remapped in first-appearance order. The parse is the JAX
    package's pure-Python path (its native C++ reader is not ported);
    ``weighted=True`` raises, as weighted graphs are not ported yet."""
    if weighted:
        raise NotImplementedError(
            "weighted graphs are not ported yet (ROADMAP.md, queue 1, slice B)"
        )
    src_l, dst_l = [], []
    with open(path, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith(comment):
                continue
            parts = line.split()
            src_l.append(int(parts[0]))
            dst_l.append(int(parts[1]))
    raw_src = np.asarray(src_l, np.int64)
    raw_dst = np.asarray(dst_l, np.int64)

    # dense remap in first-appearance order over the interleaved endpoints
    stacked = np.empty(raw_src.size * 2, np.int64)
    stacked[0::2] = raw_src
    stacked[1::2] = raw_dst
    uniq, first_pos = np.unique(stacked, return_index=True)
    uniq_in_order = uniq[np.argsort(first_pos, kind="stable")]
    lookup = np.empty(uniq.max() + 1 if uniq.size else 1, np.int64)
    lookup[uniq_in_order] = np.arange(uniq_in_order.size)

    graph = build_graph(lookup[raw_src], lookup[raw_dst],
                        n=uniq_in_order.size,
                        dense_threshold=dense_threshold, device=device)
    if name is None:
        name = os.path.splitext(os.path.basename(path))[0]
    names = [str(int(orig)) for orig in uniq_in_order]
    return Dataset(graph=graph, names=names, name=name)


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


def load_default(prefer_got: bool = True, **kwargs) -> Dataset:
    """GOT if its CSVs are in the repository (``dataset/got``), else a
    seeded 107-node synthetic graph, the JAX package's fallback."""
    if prefer_got and os.path.exists(
            os.path.join(REFERENCE_GOT_DIR, "GOT_Nodes.csv")):
        return load_got(**kwargs)
    return synthetic_powerlaw(107, avg_deg=3, seed=7, name="got_fallback",
                              **kwargs)
