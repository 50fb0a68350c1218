"""Performance database (paper Sections 3.3 and 5).

Micro-benchmark execution records — one per configuration vector, holding
the micro-benchmark's times across a sweep of fast-memory sizes — behind a
nearest-neighbour index over the 8-dimensional configuration space (HNSW
over numpy, as in :mod:`repro.core.perfdb`, with a brute-force oracle),
saved as a JSON + ``.npz`` pair in the JAX package's format.
"""

from __future__ import annotations

import heapq
import json
import warnings
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

from repro_torch.core.telemetry import ConfigVector


class PerfDBUnavailable(RuntimeError):
    """The performance database cannot be reached right now; the tuner
    holds its size and retries with backoff instead of crashing."""


@dataclass
class PerfRecord:
    """Execution record: time curve of the micro-benchmark vs fm size."""

    config: ConfigVector
    fm_fracs: np.ndarray  # fractions of the reference fast-memory size, desc
    times: np.ndarray  # micro-benchmark execution time per fm frac

    def __post_init__(self) -> None:
        self.fm_fracs = np.asarray(self.fm_fracs, dtype=np.float64)
        self.times = np.asarray(self.times, dtype=np.float64)
        if self.fm_fracs.shape != self.times.shape:
            raise ValueError("fm_fracs/times shape mismatch")

    @property
    def baseline_time(self) -> float:
        """Micro-benchmark time with fast memory only (fm_frac == 1)."""
        i = int(np.argmin(np.abs(self.fm_fracs - 1.0)))
        return float(self.times[i])

    def predicted_loss(self) -> np.ndarray:
        """Relative loss per fm frac, micro-benchmark vs micro-benchmark
        (the baseline is the micro-benchmark at full fast memory)."""
        x = self.baseline_time
        return (self.times - x) / x

    def min_fm_within(self, target_loss: float) -> float | None:
        """Smallest fm fraction whose predicted loss <= target, else None."""
        loss = self.predicted_loss()
        ok = self.fm_fracs[loss <= target_loss + 1e-12]
        return float(ok.min()) if ok.size else None


# --------------------------------------------------------------------- HNSW


class _HNSW:
    """Minimal hierarchical navigable small world graph over L2 distance."""

    def __init__(self, dim: int, m: int = 12, ef_construction: int = 64, seed: int = 0):
        self.dim = dim
        self.m = m
        self.m0 = 2 * m
        self.ef_construction = ef_construction
        self.ml = 1.0 / np.log(m)
        self.vectors = np.empty((0, dim), dtype=np.float64)
        self.levels: list[int] = []
        # neighbors[level][node] -> list[int]
        self.neighbors: list[dict[int, list[int]]] = []
        self.entry: int = -1
        self.max_level: int = -1
        self._rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        return len(self.levels)

    def _dist(self, q: np.ndarray, ids) -> np.ndarray:
        ids = np.asarray(ids, dtype=np.int64)
        d = self.vectors[ids] - q
        return np.einsum("ij,ij->i", d, d)

    def _search_layer(self, q: np.ndarray, entry: int, ef: int, level: int):
        """Beam search in one layer; returns (ids, dists) of up to ef best.

        ``cand`` is a min-heap by distance; ``best`` is a bounded max-heap
        (stored negated, with negated ids so eviction ties break exactly
        like ``max()`` over ``(dist, id)`` tuples).
        """
        nbrs = self.neighbors[level]
        visited = {entry}
        d0 = float(self._dist(q, [entry])[0])
        cand = [(d0, entry)]
        best = [(-d0, -entry)]
        while cand:
            d, c = heapq.heappop(cand)
            if d > -best[0][0] and len(best) >= ef:
                break
            neigh = [n for n in nbrs.get(c, []) if n not in visited]
            if not neigh:
                continue
            visited.update(neigh)
            dists = self._dist(q, neigh)
            for dn, n in zip(dists, neigh):
                dn = float(dn)
                if len(best) < ef or dn < -best[0][0]:
                    heapq.heappush(cand, (dn, n))
                    heapq.heappush(best, (-dn, -n))
                    if len(best) > ef:
                        heapq.heappop(best)
        out = sorted((-nd, -nn) for nd, nn in best)
        ids = np.array([n for _, n in out], dtype=np.int64)
        ds = np.array([dd for dd, _ in out], dtype=np.float64)
        return ids, ds

    def add(self, vec: np.ndarray) -> int:
        vec = np.asarray(vec, dtype=np.float64).reshape(1, -1)
        node = len(self.levels)
        self.vectors = np.concatenate([self.vectors, vec], axis=0)
        level = int(-np.log(max(self._rng.random(), 1e-12)) * self.ml)
        self.levels.append(level)
        while len(self.neighbors) <= level:
            self.neighbors.append({})
        for lvl in range(level + 1):
            self.neighbors[lvl].setdefault(node, [])
        if self.entry < 0:
            self.entry = node
            self.max_level = level
            return node
        q = vec[0]
        ep = self.entry
        # greedy descent through layers above the node's level
        for lvl in range(self.max_level, level, -1):
            ids, _ = self._search_layer(q, ep, 1, lvl)
            ep = int(ids[0])
        for lvl in range(min(level, self.max_level), -1, -1):
            ids, _ = self._search_layer(q, ep, self.ef_construction, lvl)
            mmax = self.m0 if lvl == 0 else self.m
            chosen = ids[:mmax]
            self.neighbors[lvl][node] = [int(i) for i in chosen]
            for c in chosen:
                lst = self.neighbors[lvl].setdefault(int(c), [])
                lst.append(node)
                if len(lst) > mmax:
                    # prune to the mmax closest
                    d = self._dist(self.vectors[int(c)], lst)
                    keep = np.argsort(d)[:mmax]
                    self.neighbors[lvl][int(c)] = [lst[i] for i in keep]
            ep = int(ids[0])
        if level > self.max_level:
            self.max_level = level
            self.entry = node
        return node

    def search(self, q: np.ndarray, k: int = 1, ef: int = 48):
        if self.entry < 0:
            return np.empty(0, np.int64), np.empty(0, np.float64)
        q = np.asarray(q, dtype=np.float64)
        ep = self.entry
        for lvl in range(self.max_level, 0, -1):
            ids, _ = self._search_layer(q, ep, 1, lvl)
            ep = int(ids[0])
        ids, ds = self._search_layer(q, ep, max(ef, k), 0)
        return ids[:k], ds[:k]


# ------------------------------------------------------------------- PerfDB


@dataclass
class PerfDB:
    """The performance database: HNSW index + record store."""

    records: list = field(default_factory=list)
    m: int = 12
    ef_construction: int = 64
    _index: _HNSW | None = None
    # per-dimension scale for distance space (set at build from data spread)
    _scale: np.ndarray | None = None

    def add(self, record: PerfRecord) -> None:
        self.records.append(record)
        self._index = None  # invalidate

    def build(self) -> None:
        if not self.records:
            raise ValueError("empty performance database")
        raw = np.stack([r.config.normalized() for r in self.records])
        spread = raw.std(axis=0)
        self._scale = np.divide(
            1.0, spread, out=np.ones_like(spread), where=spread > 1e-9
        )
        self._index = _HNSW(
            dim=raw.shape[1], m=self.m, ef_construction=self.ef_construction
        )
        for v in raw * self._scale:
            self._index.add(v)

    def _embed(self, cv: ConfigVector) -> np.ndarray:
        return cv.normalized() * self._scale

    def query(self, cv: ConfigVector, k: int = 1) -> list:
        """Nearest execution records for a runtime configuration vector;
        records with non-finite times are skipped with a warning."""
        if self._index is None:
            self.build()
        ids, _ = self._index.search(self._embed(cv), k=k)
        out = []
        for i in ids:
            r = self.records[int(i)]
            if not np.all(np.isfinite(r.times)):
                warnings.warn(
                    "PerfDB.query: skipping record with non-finite times "
                    f"(rss_pages={r.config.rss_pages:g})",
                    RuntimeWarning,
                    stacklevel=2,
                )
                continue
            out.append(r)
        return out

    def query_brute(self, cv: ConfigVector, k: int = 1) -> list:
        """Exact nearest neighbours (recall oracle for tests)."""
        if self._scale is None:
            self.build()
        raw = np.stack([r.config.normalized() for r in self.records]) * self._scale
        d = raw - self._embed(cv)
        order = np.argsort(np.einsum("ij,ij->i", d, d))[:k]
        return [self.records[int(i)] for i in order]

    # ------------------------------------------------------------ persistence
    def save(self, path: str | Path) -> None:
        """Write ``path.json`` (the configs) and ``path.npz`` (the curves)."""
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        meta = []
        arrays = {}
        for i, r in enumerate(self.records):
            meta.append(r.config.to_dict())
            arrays[f"fm_{i}"] = r.fm_fracs
            arrays[f"t_{i}"] = r.times
        np.savez_compressed(path.with_suffix(".npz"), **arrays)
        path.with_suffix(".json").write_text(json.dumps(meta))

    @classmethod
    def load(cls, path: str | Path) -> "PerfDB":
        """A database saved by :meth:`save` (of either package), built."""
        path = Path(path)
        meta = json.loads(path.with_suffix(".json").read_text())
        arrays = np.load(path.with_suffix(".npz"))
        db = cls()
        for i, cfg in enumerate(meta):
            db.add(
                PerfRecord(
                    config=ConfigVector(**cfg),
                    fm_fracs=arrays[f"fm_{i}"],
                    times=arrays[f"t_{i}"],
                )
            )
        db.build()
        return db
