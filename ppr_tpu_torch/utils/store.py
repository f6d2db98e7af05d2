"""Persistent PPR result store with resumable batch sweeps — a copy of
``ppr_tpu/utils/store.py`` (numpy only; importing it from the JAX package
would pull in JAX). The on-disk format is the same, so either package reads
a store the other wrote.

It replaces the reference's preprocessing cache: per-source text files
``<nodeId>\\t<ppr>`` under ``<ALGO>_ppr_results/<db>/...`` (written at
Monte_Carlo.java:209-231 and its siblings, read back at
Monte_Carlo.java:235-254, sized via FileUtils.sizeOfDirectory at
Monte_Carlo.java:322-325). Results land as one ``.npz`` shard per source
batch (sparse id/value pairs) plus a ``manifest.json``; an interrupted
all-pair sweep resumes from the last completed shard.

On a mesh across processes (``mesh=``, whose ranks all compute the same
rows) rank 0 alone writes, removes and finalizes the store, and every rank
waits for it at ``reset``, ``finalize`` and ``delete``, so the files are
those a single process writes. The ranks share the store's directory."""

from __future__ import annotations

import json
import os
import shutil

import numpy as np

_MANIFEST = "manifest.json"


class PPRStore:
    #: shards kept decompressed in memory for the read paths (the
    #: precomputed serving mode reads rows per query; re-inflating the
    #: npz per read would dominate the file-read query cost). Both caps
    #: apply: shard count and total resident bytes (big-graph BASE shards
    #: can hold hundreds of MB each).
    _SHARD_CACHE_CAP = 4
    _SHARD_CACHE_BYTES = 512 << 20

    def __init__(self, root: str, n: int, *, mesh=None):
        self.root = root
        self.n = n
        #: a ``parallel.mesh.Mesh``: only its writer rank touches the files
        self.mesh = mesh
        self._row_index: dict[int, str] | None = None
        self._ranges: list | None = None
        self._range_starts: list = []
        self._shard_cache: dict[str, dict[str, np.ndarray]] = {}

    # --- write path -------------------------------------------------------
    def reset(self) -> None:
        """Clear any previous finalized store (reference clears the directory
        before preprocessing, e.g. Monte_Carlo.java:203-213) but keep
        unfinalized shards so an interrupted sweep resumes."""
        if self._writer:
            if self._read_manifest().get("finalized"):
                shutil.rmtree(self.root, ignore_errors=True)
            os.makedirs(self.root, exist_ok=True)
        self._barrier()
        self._row_index = None
        self._ranges = None
        self._shard_cache.clear()

    def has_batch(self, start: int) -> bool:
        return os.path.exists(self._shard_path(start))

    def write_batch(self, start: int, sources: np.ndarray,
                    rows: np.ndarray) -> None:
        """Persist dense rows (one per source) as sparse id/value arrays:
        each row's positive entries in id order."""
        ids, vals = [], []
        for row in np.asarray(rows):
            nz = np.nonzero(row > 0.0)[0]
            ids.append(nz)
            vals.append(row[nz])
        self.write_batch_ordered(start, sources, ids, vals)

    def write_batch_ordered(
        self, start: int, sources: np.ndarray,
        ids_list: list[np.ndarray], vals_list: list[np.ndarray],
    ) -> None:
        """Persist rows as explicit (ids, vals) sequences, preserving order.

        Used by the preprocessing sweep (``models/base.py``), which writes
        each source's kept entries in column order."""
        if not self._writer:
            return
        ptr = [0]
        for ids in ids_list:
            ptr.append(ptr[-1] + len(ids))
        tmp = self._shard_path(start) + ".tmp"
        np.savez_compressed(
            tmp,
            sources=np.asarray(sources, np.int32),
            indptr=np.asarray(ptr, np.int64),
            ids=np.concatenate(ids_list).astype(np.int32)
            if ids_list else np.zeros(0, np.int32),
            vals=np.concatenate(vals_list).astype(np.float32)
            if vals_list else np.zeros(0, np.float32),
        )
        os.replace(tmp + ".npz", self._shard_path(start))

    def read_row_ordered(self, source: int):
        """(ids, vals) for one source in stored order. Copies, so callers
        never pin an evicted shard's full arrays via a slice view."""
        z = self._load_shard(source)
        pos = int(np.nonzero(z["sources"] == source)[0][0])
        lo, hi = int(z["indptr"][pos]), int(z["indptr"][pos + 1])
        return z["ids"][lo:hi].copy(), z["vals"][lo:hi].copy()

    def _load_shard(self, source: int) -> dict[str, np.ndarray]:
        shard = self._shard_for(int(source))
        if shard is None:
            raise KeyError(f"source {source} not in store {self.root}")
        cached = self._shard_cache.get(shard)
        if cached is None:
            with np.load(os.path.join(self.root, shard)) as z:
                cached = {k: z[k] for k in ("sources", "indptr", "ids",
                                            "vals")}
            size = sum(a.nbytes for a in cached.values())
            if self._SHARD_CACHE_CAP > 0 and size <= self._SHARD_CACHE_BYTES:
                def total():
                    return sum(
                        sum(a.nbytes for a in c.values())
                        for c in self._shard_cache.values()
                    )

                while self._shard_cache and (
                    len(self._shard_cache) >= self._SHARD_CACHE_CAP
                    or total() + size > self._SHARD_CACHE_BYTES
                ):
                    # evict the oldest insertion (dicts preserve order)
                    self._shard_cache.pop(next(iter(self._shard_cache)))
                self._shard_cache[shard] = cached
        return cached

    def finalize(self, **extra) -> None:
        if self._writer:
            self._write_manifest(extra)
        self._barrier()
        self._row_index = None
        self._ranges = None

    def _write_manifest(self, extra: dict) -> None:
        shards = sorted(
            f for f in os.listdir(self.root) if f.startswith("batch_")
        )
        # manifest-level source->shard ranges: attaching a store then reads
        # NO shard up front (a 262k-source store used to pay ~256 npz member
        # reads in _build_index before the first query)
        ranges = []
        for shard in shards:
            with np.load(os.path.join(self.root, shard)) as z:
                s = z["sources"]
            if s.size:
                ranges.append([int(s.min()), int(s.max()), int(s.size),
                               shard])
        ranges.sort()
        manifest = {"n": self.n, "finalized": True, "shards": shards,
                    "ranges": ranges, **extra}
        with open(os.path.join(self.root, _MANIFEST), "w") as f:
            json.dump(manifest, f)

    # --- read path --------------------------------------------------------
    def read_row(self, source: int) -> np.ndarray:
        """Dense f32[n] row for one source (the query path of preprocessing
        mode — the reference's readPreprocessedPPR file read)."""
        ids, vals = self.read_row_ordered(source)
        row = np.zeros(self.n, np.float32)
        row[ids] = vals
        return row

    def _shard_for(self, source: int) -> str | None:
        """Map source -> shard file. Fast path: the manifest's sorted
        [lo, hi, count, shard] ranges (bisect, zero shard reads). A range
        whose count < hi-lo+1 has holes — membership is confirmed against
        the shard's own sources (falling back to the full scan if absent).
        Stores finalized before manifests carried ranges use the scan."""
        import bisect

        if self._ranges is None:
            self._ranges = self._read_manifest().get("ranges", [])
            self._range_starts = [r[0] for r in self._ranges]
        ranges = self._ranges
        if ranges:
            i = bisect.bisect_right(self._range_starts, source) - 1
            if 0 <= i < len(ranges):
                lo, hi, count, shard = ranges[i]
                if lo <= source <= hi:
                    if count == hi - lo + 1:
                        return shard
                    with np.load(os.path.join(self.root, shard)) as z:
                        if np.any(z["sources"] == source):
                            return shard
            return self._build_index().get(source)
        return self._build_index().get(source)

    def _build_index(self) -> dict[int, str]:
        if self._row_index is None:
            self._row_index = {}
            manifest = self._read_manifest()
            for shard in manifest.get("shards", []):
                with np.load(os.path.join(self.root, shard)) as z:
                    for s in z["sources"]:
                        self._row_index[int(s)] = shard
        return self._row_index

    # --- management -------------------------------------------------------
    def size_bytes(self) -> int:
        total = 0
        for dirpath, _, files in os.walk(self.root):
            total += sum(os.path.getsize(os.path.join(dirpath, f)) for f in files)
        return total

    def delete(self) -> None:
        self._barrier()      # every rank has read what it needed
        if self._writer:
            shutil.rmtree(self.root, ignore_errors=True)
        self._shard_cache.clear()

    @property
    def _writer(self) -> bool:
        return self.mesh is None or self.mesh.is_writer

    def _barrier(self) -> None:
        if self.mesh is not None:
            self.mesh.barrier()

    def _shard_path(self, start: int) -> str:
        return os.path.join(self.root, f"batch_{start:09d}.npz")

    def _read_manifest(self) -> dict:
        path = os.path.join(self.root, _MANIFEST)
        if os.path.exists(path):
            with open(path) as f:
                return json.load(f)
        return {}
