"""What the measurement drivers at the repository's root share
(``hub_knee_torch.py``, ``scale_1m_torch.py``, ``scale_1m_knee_torch.py``,
``ring_occupancy_torch.py``, ``gen_scaling_model_torch.py``,
``profile_sweep_torch.py``, ``serving_latency_torch.py``): the device a run
asks for, the artifact a ``--db`` run writes, the card it ran on, host clocks
(and CUDA events) around synchronised calls, peak device memory and the
JSON artifact.

A driver runs on the card unless given ``--device cpu``; without a card it
exits 1 (:func:`no_card`). A CPU run records its counts and host times
under the device ``cpu``, never under a card's name, and its peak device
memory as ``None``.
"""

from __future__ import annotations

import json
import os
import re
import sys
import time

import torch

from ..device import synchronize


def no_card(device: str, prog: str) -> bool:
    """True, with a line on stderr, when ``device`` is the card and no card
    is visible: the driver then exits 1 and carries on nowhere else."""
    if device == "cuda" and not torch.cuda.is_available():
        print(f"{prog}: no CUDA device is visible; pass --device cpu to run "
              f"on the CPU", file=sys.stderr)
        return True
    return False


def describe(dev: torch.device) -> dict:
    """The device a run measured on: the card's ``nvidia-smi`` name and
    power limit, or the CPU."""
    if dev.type != "cuda":
        return {"type": "cpu", "card": "cpu"}
    from .cuda_timing import card_line

    return {"type": "cuda", "card": card_line(),
            "name": torch.cuda.get_device_name(dev),
            "count": torch.cuda.device_count()}


def db_tag(spec: str) -> str:
    """A file-name part for ``--db``: ``blogcatalog`` for ``synth:blogcatalog``,
    ``65536x16_42`` for ``synth:65536x16@42``, a path's last part
    otherwise."""
    spec = spec.removeprefix("synth:").rstrip("/")
    return re.sub(r"[^A-Za-z0-9]+", "_", os.path.basename(spec)).strip("_")


def graph_record(g) -> dict:
    """The operator a run's sweeps used: the graph's padded size, edges and
    whether it carries the dense matrix (``build_graph``'s
    ``dense_threshold``) or only the sparse edges."""
    return {"n": g.n, "m": g.m, "n_pad": g.n_pad,
            "operator": "dense" if g.has_dense else "sparse"}


def default_out(stem: str, db: str | None) -> str:
    """``results/<stem>_h100.json``, or ``results/<stem>_<db>_h100.json``
    for a ``--db`` run: a run on another graph never overwrites the
    default graph's artifact."""
    return (f"results/{stem}_h100.json" if db is None
            else f"results/{stem}_{db_tag(db)}_h100.json")


def timed(dev: torch.device, fn):
    """``(result, seconds)`` of ``fn()`` on a host clock, the device's
    queued work waited for before and after."""
    synchronize(dev)
    t0 = time.perf_counter()
    out = fn()
    synchronize(dev)
    return out, time.perf_counter() - t0


def timed_events(dev: torch.device, fn):
    """``(result, seconds, device_ms)``: :func:`timed`'s host clock and,
    on the card, the milliseconds between two CUDA events recorded around
    the same call on its stream (``None`` on the CPU)."""
    if dev.type != "cuda":
        out, s = timed(dev, fn)
        return out, s, None
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    synchronize(dev)
    t0 = time.perf_counter()
    start.record()
    out = fn()
    end.record()
    synchronize(dev)
    return out, time.perf_counter() - t0, start.elapsed_time(end)


def reset_peak(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)


def peak_gb(dev: torch.device) -> float | None:
    """Peak device memory since :func:`reset_peak`, GB; ``None`` on the
    CPU."""
    if dev.type != "cuda":
        return None
    return torch.cuda.max_memory_allocated(dev) / 1e9


def write_json(path: str, obj: dict) -> None:
    """Write ``obj`` to ``path`` whole: a temporary file, then a rename."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        f.write(json.dumps(obj, indent=1) + "\n")
    os.replace(tmp, path)
