"""``BENCHMARK.json`` against the benchmark's contract: names, units,
keys, the files each entry names, and what each cell reports."""

import importlib.util
import json
import re

from conftest import ROOT

MAN = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
LINE = re.compile(r"[^\t\n\r]{1,200}")


def test_top_level_keys_and_command():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert MAN["command"] == ["python3", "benchmark/run.py"]
    assert MAN["paths"] == ["benchmark"]
    assert isinstance(MAN["run_seconds"], int)
    assert 1 <= MAN["run_seconds"] <= 51
    assert len(json.dumps(MAN)) <= 64 * 1024


def test_names_units_and_lines():
    names = [e["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for e in MAN[k]]
    assert len(names) == len(set(names))
    for name in names:
        assert NAME.fullmatch(name), name
    for m in MAN["end_to_end"] + MAN["per_layer"]:
        assert UNIT.fullmatch(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for w in MAN["workloads"]:
        assert NAME.fullmatch(w["traffic"]) and LINE.fullmatch(w["why"])
    for m in MAN["per_layer"]:
        assert LINE.fullmatch(m["layer"])
    for c in MAN["configs"]:
        assert LINE.fullmatch(c["source"]) and LINE.fullmatch(c["why"])


def test_entry_keys():
    for c in MAN["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in MAN["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1
    for m in MAN["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in MAN["per_layer"]:
        # the harness reports a per-layer metric in the cells it lists
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")


def test_configs_files_and_cells():
    cells = {w["name"]: w for w in MAN["workloads"]}
    used = {w["config"] for w in cells.values()}
    for c in MAN["configs"]:
        assert c["name"] in used, f"configuration {c['name']} has no cell"
        assert c["file"].startswith("benchmark/configs/")
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"]
        assert cfg["reduced"] == c["reduced"]
        assert len(cfg["source"]) <= 200
    for w in cells.values():
        assert (ROOT / "benchmark" / "traffic"
                / f"{w['traffic']}.json").is_file()
    pairs = [(w["config"], w["traffic"]) for w in cells.values()]
    assert len(pairs) == len(set(pairs))


def test_every_cell_reports_and_every_metric_reads():
    from benchmark.manifest import Manifest, load_metric

    man = Manifest()
    e2e = {m["name"] for m in MAN["end_to_end"]}
    for m in MAN["end_to_end"] + MAN["per_layer"]:
        for w in m.get("workloads", []):
            assert w in man.cells, (m["name"], w)
    for cell in man.cells:
        reported = {m["name"] for m in man.end_to_end(cell)}
        assert "setup_s" in reported and len(reported) >= 2, cell
        layers = man.per_layer(cell)
        assert layers, cell
        for m in layers:
            assert m["moves"] in e2e
            assert m["moves"] in reported, (m["name"], cell)
    for m in MAN["per_layer"]:
        assert callable(load_metric(m["name"]).read)


def test_one_layer_name_per_layer():
    layers = {}
    for m in MAN["per_layer"]:
        layers.setdefault(m["name"].split(".")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values()), layers


def test_a_new_config_and_entry_add_a_cell(tiny_manifest):
    """A cell is added by a new configuration file, new traffic files and
    manifest entries (the fixture), with no existing file edited."""
    assert {"tiny.batch", "tiny.serve"} <= set(tiny_manifest.cells)
    cfg = tiny_manifest.config(tiny_manifest.cell("tiny.batch"))
    assert cfg["nodes"] == 1000
    names = [m["name"] for m in tiny_manifest.per_layer("tiny.batch")]
    assert "kernel.k3_us_per_query.batch" in names
    spec = importlib.util.find_spec("benchmark.run")
    assert spec is not None
