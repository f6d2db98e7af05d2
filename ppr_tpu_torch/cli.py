"""CLI entry point — port of ``ppr_tpu/cli.py``, with the flags of the
reference's main (PPR.java:154-200; defaults at :168-184).

``--db`` names a Neo4j 3.5 store directory (``--rel`` picks its
relationship type), a directory holding a Neo4j-import CSV pair, a SNAP
edge-list file, or a ``synth:<n>x<deg>[@seed]`` / ``synth:<name>`` spec;
the program
runs the reference's batch benchmark (``algo_perf_batch_test(query, k)``,
PPR.java:192) through :class:`~ppr_tpu_torch.harness.PerfHarness`, on the
card; ``--device cpu`` asks for the CPU, and without it a process that
sees no card exits with an error rather than run there.

Usage::

    python -m ppr_tpu_torch.cli --db synth:107x3@7 --sweep got \\
        --algos MC,FORA_WHOLE_GRAPH,FORA_TOPK --fora-completion walks

All six algorithms run: Monte-Carlo, Forward Push, FORA whole-graph and
top-k, BASE and the Neo4j method, with the power method as the oracle.
``--fora-completion`` picks FORA's residue completion (``auto``: the cost
model). ``--mesh DxG`` runs every algorithm, its preprocessing sweeps
included, on a ``(data=D, graph=G)`` mesh of the visible cards (it
raises when fewer than ``D*G`` are visible), or of ``D*G`` CPU devices
with ``--device cpu``.
"""

from __future__ import annotations

import argparse
import atexit
import os
import sys

from .graph import io
from .graph.neostore import is_neo4j_store, load_neo4j_store
from .harness import PerfHarness
from .parallel.mesh import make_mesh, parse_mesh
from .utils.timer import trace


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="ppr_tpu_torch",
        description="Personalized PageRank benchmark harness (PyTorch port)",
    )
    p.add_argument("--alpha", type=float, default=0.15,
                   help="stop probability per walk step (default 0.15)")
    p.add_argument("--eps", type=float, default=0.5,
                   help="error-bound epsilon (default 0.5)")
    p.add_argument("--query", type=int, default=50,
                   help="number of benchmark queries (default 50)")
    p.add_argument("--k", type=int, default=10,
                   help="k for top-k queries (default 10)")
    p.add_argument("--node", default="name",
                   help="node display-name property (parity flag)")
    p.add_argument("--label", default="Person",
                   help="node label (parity flag)")
    p.add_argument("--rel", default="Relation",
                   help="relationship type kept from a Neo4j store "
                        "(default Relation)")
    p.add_argument("--db", default=io.REFERENCE_GOT_DIR,
                   help="dataset: a Neo4j store dir, a dir with "
                        "*_Nodes.csv/*_Rels.csv, an edge list file, or "
                        "synth:<n>x<deg>[@seed] (default: the "
                        "repository's dataset/got)")
    p.add_argument("--seed", type=int, default=0, help="query/RNG seed")
    p.add_argument("--sequential", action="store_true",
                   help="time queries one at a time (reference protocol) "
                        "instead of as one device batch")
    p.add_argument("--sweep", default=None,
                   help="sweep spec name (got/blogcatalog/flickr/grqc/amazon)")
    p.add_argument("--out-dir", default=".",
                   help="where <dataset>_AlgoPerfResults.txt is written")
    p.add_argument("--fora-completion", default="auto",
                   choices=["auto", "walks", "spmv"],
                   help="FORA residual completion strategy (auto = cost "
                        "model)")
    p.add_argument("--algos", default=None,
                   help="comma subset of algorithm names (AlgoType values, "
                        "e.g. MC,NEO4J_METHOD) to run within each "
                        "selected test; 'MC:2' skips the first 2 "
                        "params of its arrays (already-recorded rows)")
    p.add_argument("--tests", default="1,2,3",
                   help="comma subset of the three protocol tests to run "
                        "(1=whole-graph, 2=top-k, 3=preprocessing)")
    p.add_argument("--budget-s", type=float, default=None,
                   help="per-(algorithm, test) time budget in seconds; "
                        "remaining sweep params are skipped with an "
                        "explicit note row once exceeded")
    p.add_argument("--trace-dir", default=None,
                   help="write a torch.profiler chrome trace of the batch "
                        "test here, with the program's spans and counters")
    p.add_argument("--mesh", default=None, metavar="DxG",
                   help="run every algorithm (incl. preprocessing sweeps) "
                        "on a (data=D, graph=G) device mesh, e.g. --mesh "
                        "1x1 (one card through the mesh engines) or --mesh "
                        "2x2; D*G cards must be visible (D*G CPU devices "
                        "with --device cpu)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the graph and the algorithms run (default "
                        "cuda: exits with an error when no card is "
                        "visible; cpu runs the kernels' plain versions)")
    return p


# Seeded stand-ins at the scale of the four SNAP/social datasets of
# Gen_Util.java:334-449, as in the JAX package; names match SWEEPS keys.
NAMED_SYNTH = {
    "blogcatalog": (10240, 32, 101),   # BlogCatalog: 10,312 n / 334k m
    "flickr": (81920, 16, 102),        # Flickr: 80,513 n (deg reduced 72->16)
    "grqc": (5120, 3, 103),            # ca-GrQc: 5,242 n / 14.5k m
    "amazon": (262144, 4, 104),        # amazon0302: 262,111 n / 1.23M m
}


def load_dataset(db: str, rel: str | None = None, device=None):
    """The dataset ``db`` names, on ``device`` (default: the card; raises
    when no card is visible). ``rel`` keeps only that relationship type of
    a Neo4j store (the reference's ``--rel``, PPR.java:126); the CSV,
    edge-list and synthetic sources are single-type and ignore it."""
    if db.startswith("synth:"):
        spec = db[len("synth:"):]
        if spec in NAMED_SYNTH:
            n, deg, seed = NAMED_SYNTH[spec]
            return io.synthetic_powerlaw(n, deg, seed=seed, name=spec,
                                         dense_threshold=0, device=device)
        seed = 0
        if "@" in spec:
            spec, seed_s = spec.split("@")
            seed = int(seed_s)
        n, deg = (int(x) for x in spec.split("x"))
        return io.synthetic_powerlaw(n, deg, seed=seed, device=device)
    if os.path.isdir(db):
        if is_neo4j_store(db):
            # the reference's own entry path: an embedded-Neo4j store dir
            # (PPR.java:52-60 on target/got.db), read without a JVM
            return load_neo4j_store(db, rel_type=rel, device=device)
        for f in os.listdir(db):
            if f.endswith("_Nodes.csv"):
                prefix = f[: -len("_Nodes.csv")]
                return io.load_neo4j_csv(
                    os.path.join(db, f),
                    os.path.join(db, f"{prefix}_Rels.csv"),
                    name=prefix.lower(), device=device,
                )
        raise SystemExit(f"no *_Nodes.csv or neostore in {db}")
    if os.path.isfile(db):
        return io.load_edge_list(db, device=device)
    raise SystemExit(f"dataset not found: {db}")


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    dataset = load_dataset(args.db, rel=args.rel, device=args.device)
    print(f"Loaded dataset '{dataset.name}': {dataset.graph.n} nodes, "
          f"{dataset.graph.m} edges, on {dataset.graph.device}")
    mesh = None
    if args.mesh:
        d, g_ax = parse_mesh(args.mesh)
        mesh = make_mesh(d * g_ax, data=d, graph=g_ax,
                         devices=(["cpu"] * (d * g_ax)
                                  if args.device == "cpu" else None))
        print(f"Mesh: data={d} x graph={g_ax} ({d * g_ax} device(s), "
              f"sharded engines)")
    harness = PerfHarness(
        dataset, alpha=args.alpha, seed=args.seed,
        out_dir=args.out_dir, batched=not args.sequential,
        fora_completion=args.fora_completion, mesh=mesh,
    )

    # the reference closes its DB in a JVM shutdown hook (PPR.java:35-50):
    # on interruption, say where the append-only results file and any
    # resumable preprocessing stores stand
    def _shutdown_note():
        print(f"Interrupted — partial results in {harness.writer.path}; "
              "preprocessing stores resume from their last completed "
              "shard on the next run.")

    atexit.register(_shutdown_note)
    try:
        with trace(args.trace_dir):
            harness.algo_perf_batch_test(
                args.query, args.k, sweep=args.sweep,
                tests=tuple(int(t) for t in args.tests.split(",")),
                budget_s=args.budget_s,
                algos=(set(args.algos.split(",")) if args.algos else None),
            )
    except Exception as e:  # PPR.java:196-199 prints and exits
        print(f"Algo performance batch test failed! ({e})")
        raise
    atexit.unregister(_shutdown_note)
    print(f"Results appended to {harness.writer.path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
