"""Search pipelines: the hybrid-query score-normalization processor
(BASELINE config #4) and the named-pipeline registry (the port of the JAX
package's ``search/pipeline.py``, a host-only module copied as it is).

A pipeline is a named JSON document; the one phase-results processor
implemented is ``normalization-processor`` (the neural-search plugin's):

- normalization: ``min_max`` (per sub-query: (s-min)/(max-min), 1.0 on
  a degenerate range) or ``l2`` (s / ||scores||);
- combination: ``arithmetic_mean`` / ``geometric_mean`` /
  ``harmonic_mean`` with optional per-sub-query ``weights``.

A ``hybrid`` query's sub-queries each produce an independent top-k on
the device; normalization and combination are a small host reduce over
those lists, in float64 numpy as in the reference, so nothing here
touches the device.  ``SearchPipelineService`` persists the pipelines in
``search_pipelines.json`` under the node's data path, the reference's
file, so either package's node reads the other's.
"""

from __future__ import annotations

import json
import os
import threading
from typing import Optional

import numpy as np

from opensearch_tpu_torch.common.errors import (IllegalArgumentError,
                                          OpenSearchTpuError,
                                          ValidationError)


class PipelineMissingError(OpenSearchTpuError):
    status = 404


DEFAULT_NORMALIZATION = {"technique": "min_max"}
DEFAULT_COMBINATION = {"technique": "arithmetic_mean"}


def normalize_scores(scores: np.ndarray, technique: str) -> np.ndarray:
    if len(scores) == 0:
        return scores
    if technique == "min_max":
        lo, hi = float(scores.min()), float(scores.max())
        if hi - lo < 1e-12:
            return np.ones_like(scores)
        return (scores - lo) / (hi - lo)
    if technique == "l2":
        norm = float(np.sqrt((scores * scores).sum()))
        return scores / norm if norm > 1e-12 else np.ones_like(scores)
    raise IllegalArgumentError(
        f"unknown normalization technique [{technique}]")


def combine_scores(per_query: list[float], weights: list[float],
                   technique: str) -> float:
    """Combine one doc's normalized sub-query scores (absent sub-queries
    contribute 0, matching the neural-search processor)."""
    w = np.asarray(weights, np.float64)
    s = np.asarray(per_query, np.float64)
    if technique == "arithmetic_mean":
        return float((w * s).sum() / w.sum())
    if technique == "geometric_mean":
        # zeros collapse the product: only positive entries participate,
        # weighted geometric mean over them
        pos = s > 0
        if not pos.any():
            return 0.0
        return float(np.exp((w[pos] * np.log(s[pos])).sum() / w[pos].sum()))
    if technique == "harmonic_mean":
        pos = s > 0
        if not pos.any():
            return 0.0
        return float(w[pos].sum() / (w[pos] / s[pos]).sum())
    raise IllegalArgumentError(
        f"unknown combination technique [{technique}]")


class NormalizationConfig:
    def __init__(self, body: Optional[dict] = None):
        body = body or {}
        self.normalization = (body.get("normalization")
                              or DEFAULT_NORMALIZATION).get(
            "technique", DEFAULT_NORMALIZATION["technique"])
        if self.normalization not in ("min_max", "l2"):
            raise IllegalArgumentError(
                f"unknown normalization technique [{self.normalization}]")
        comb = body.get("combination") or DEFAULT_COMBINATION
        self.combination = comb.get("technique", "arithmetic_mean")
        if self.combination not in ("arithmetic_mean", "geometric_mean",
                                    "harmonic_mean"):
            raise IllegalArgumentError(
                f"unknown combination technique [{self.combination}]")
        self.weights = (comb.get("parameters") or {}).get("weights")
        if self.weights is not None:
            if (not isinstance(self.weights, list)
                    or any(not isinstance(w, (int, float)) or w < 0
                           for w in self.weights)
                    or sum(self.weights) <= 0):
                raise IllegalArgumentError(
                    "combination weights must be non-negative numbers "
                    "with a positive sum")

    def apply(self, per_query_rows: list[list[dict]], k: int) -> list[dict]:
        """``per_query_rows``: one row list per sub-query (rows carry
        seg/local/score).  Returns the combined, re-sorted row list."""
        nq = len(per_query_rows)
        weights = self.weights or [1.0] * nq
        if len(weights) != nq:
            raise ValidationError(
                f"combination weights has {len(weights)} entries for "
                f"{nq} sub-queries")
        normalized: dict[tuple, list[float]] = {}
        for qi, rows in enumerate(per_query_rows):
            scores = np.asarray([r["score"] for r in rows], np.float64)
            norm = normalize_scores(scores, self.normalization)
            for r, ns in zip(rows, norm):
                key = (r["seg"], r["local"])
                slot = normalized.setdefault(key, [0.0] * nq)
                slot[qi] = float(ns)
        combined = []
        for (seg, local), per_q in normalized.items():
            combined.append({
                "seg": seg, "local": local,
                "score": combine_scores(per_q, weights, self.combination)})
        combined.sort(key=lambda r: (-r["score"], r["seg"], r["local"]))
        return combined[:k]


_KNOWN_PROCESSORS = ("normalization-processor",)
_PROCESSOR_META_KEYS = ("tag", "description", "ignore_failure")


def _processor_of(entry) -> tuple[str, dict]:
    """(name, config) of one processor entry; meta keys (tag/...) are
    allowed alongside; anything else is a client error, never a crash."""
    if not isinstance(entry, dict):
        raise IllegalArgumentError(
            f"processor entry must be an object, got "
            f"[{type(entry).__name__}]")
    names = [k for k in entry if k not in _PROCESSOR_META_KEYS]
    if len(names) != 1:
        raise IllegalArgumentError(
            f"processor entry must have exactly one processor type, "
            f"got {names}")
    name = names[0]
    if name not in _KNOWN_PROCESSORS:
        raise IllegalArgumentError(
            f"unknown phase_results processor [{name}] — supported: "
            f"{list(_KNOWN_PROCESSORS)}")
    conf = entry[name]
    if conf is not None and not isinstance(conf, dict):
        raise IllegalArgumentError(
            f"processor [{name}] config must be an object")
    return name, conf or {}


class SearchPipelineService:
    """Named-pipeline registry with on-disk persistence (the cluster-state
    storage of the reference, node-local here)."""

    def __init__(self, data_path: str):
        self._file = os.path.join(data_path, "search_pipelines.json")
        self._lock = threading.Lock()
        self._pipelines: dict[str, dict] = {}
        if os.path.exists(self._file):
            with open(self._file) as f:
                self._pipelines = json.load(f)

    def _persist(self):
        tmp = self._file + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self._pipelines, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self._file)

    def put(self, pipeline_id: str, body: dict) -> dict:
        for p in body.get("phase_results_processors") or []:
            _name, conf = _processor_of(p)
            NormalizationConfig(conf)     # validates techniques eagerly
        with self._lock:
            self._pipelines[pipeline_id] = body
            self._persist()
        return {"acknowledged": True}

    def get(self, pipeline_id: Optional[str] = None) -> dict:
        with self._lock:
            if pipeline_id is None:
                return dict(self._pipelines)
            if pipeline_id not in self._pipelines:
                raise PipelineMissingError(
                    f"search pipeline [{pipeline_id}] not found")
            return {pipeline_id: self._pipelines[pipeline_id]}

    def delete(self, pipeline_id: str) -> dict:
        with self._lock:
            if pipeline_id not in self._pipelines:
                raise PipelineMissingError(
                    f"search pipeline [{pipeline_id}] not found")
            del self._pipelines[pipeline_id]
            self._persist()
        return {"acknowledged": True}

    def hybrid_conf(self, pipeline_id: str) -> Optional[dict]:
        """The named pipeline's normalization-processor config dict (the
        value the REST layer threads to _hybrid_search), or None when
        the pipeline has no such processor."""
        body = self.get(pipeline_id)[pipeline_id]
        for p in body.get("phase_results_processors") or []:
            name, conf = _processor_of(p)
            if name == "normalization-processor":
                return conf
        return None
