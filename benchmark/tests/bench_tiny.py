"""A tiny deployment and its cells for the benchmark's CPU tests."""

import json
import shutil

from benchmark.manifest import ROOT, Manifest

#: a deployment small enough for the CPU, on which FORA's cost model takes
#: the annealed loop (CPU constants) as the card does at B 2048
TINY = {"name": "tiny", "nodes": 1000, "edges": 6000,
        "generator": {"undirected": True, "max_degree": 200}}
TINY_MIXES = {
    "tiny_batch": {"kind": "batch", "batch": 64},
    "tiny_open": {"kind": "open", "rate_qps": 30, "max_batch": 16,
                  "lead_in_s": 0.5, "drain_s": 30.0},
}


def make_tiny_manifest(tmp_path) -> Manifest:
    """The repository's manifest and files copied to ``tmp_path``, plus a
    new configuration file and new traffic files with a manifest entry for
    each of their cells: nothing that exists is edited."""
    bench = tmp_path / "benchmark"
    shutil.copytree(ROOT / "benchmark" / "configs", bench / "configs")
    shutil.copytree(ROOT / "benchmark" / "traffic", bench / "traffic")
    cfg = json.loads((bench / "configs" / "flickr.json").read_text())
    cfg.update(TINY)
    (bench / "configs" / "tiny.json").write_text(json.dumps(cfg))
    for name, mix in TINY_MIXES.items():
        (bench / "traffic" / f"{name}.json").write_text(json.dumps(mix))
    man = json.loads((ROOT / "BENCHMARK.json").read_text())
    man["configs"].append({"name": "tiny", "source": "tests",
                           "file": "benchmark/configs/tiny.json",
                           "reduced": [], "why": "tests"})
    man["workloads"] += [
        {"name": "tiny.batch", "config": "tiny", "traffic": "tiny_batch",
         "chips": 1, "why": "tests"},
        {"name": "tiny.serve", "config": "tiny", "traffic": "tiny_open",
         "chips": 1, "why": "tests"}]
    for m in man["end_to_end"] + man["per_layer"]:
        if "workloads" in m:
            batch = any(w.endswith(".batch") for w in m["workloads"])
            m["workloads"].append("tiny.batch" if batch else "tiny.serve")
    path = tmp_path / "BENCHMARK.json"
    path.write_text(json.dumps(man))
    return Manifest(path, bench / "traffic")
