"""Aggregations: request parsing, per-segment collection, mergeable
partials, cross-shard reduce, response formatting (the port of the JAX
package's ``search/aggs.py``: the same parse, partials and reduce; the
device sites run on torch tensors).

Device sites: metric partials, the ordinal ``value_count``, ``terms`` on
a keyword and ``histogram`` / ``date_histogram`` with their metric subs
go through ``ops/aggs.py`` ``bucket_collect``: on the card one K5 launch
(``csrc/aggs.cu``) over every segment of the request per call, and one
copy back.  ``filter`` / ``filters`` / ``missing`` masks run the query
phase's plan per segment (``compile_query``, ``build_arrays``,
``run_full``), ``range`` masks are ``ops/filters.py`` torch ops, and
``percentiles`` past ``PCT_RAW_MAX`` values per segment uses
``masked_centroids``.  Everything else is numpy over the matched masks
copied back.  Float sums follow ``ops/aggs.py``'s fixed order, so the
card's answers equal the CPU's byte for byte.

Analog of the reference's two-phase model (per-shard collect via
``BucketCollector`` -> coordinator ``InternalAggregations.reduce``; ref
search/aggregations/BucketCollector.java:46,
bucket/histogram/DateHistogramAggregator.java,
bucket/terms/GlobalOrdinalsStringTermsAggregator.java,
action/search/QueryPhaseResultConsumer.java:178).  Collection is
array-oriented: bucket counts and metric partials are scatter-adds over
doc-value columns (ops/aggs.py).

The two phases are REAL phases here, crossing process boundaries:

- ``AggregationExecutor.collect`` runs shard-side and produces a
  JSON-serializable partial per agg (wire-safe: plain scalars/lists);
- ``reduce_aggs`` runs coordinator-side over any number of partials and
  produces the final response JSON.  The single-shard ``run`` is
  literally ``reduce_aggs(one partial)``, so every local test also
  validates the distributed path.

Approximate-on-purpose partials (matching the reference's contracts):
cardinality degrades from an exact value set to HyperLogLog registers
past ``precision_threshold`` (HyperLogLogPlusPlus.java analog);
percentiles degrade from raw values to weight-merged centroids past a
size cap (TDigest analog); terms are truncated to ``shard_size`` per
shard with ``doc_count_error_upper_bound`` computed from the smallest
included count of the shards that omitted a key.

Composition model: every bucket agg that selects a doc subset (filter,
filters, range, missing, global) recurses with a narrowed matched mask, so
arbitrary nesting works; terms/histogram support metric sub-aggs computed
in the same pass via two-level scatters.
"""

from __future__ import annotations

import datetime as _dt
import hashlib
import re
from dataclasses import dataclass, field as dc_field

import numpy as np
import torch

from opensearch_tpu_torch.common.errors import (IllegalArgumentError,
                                                ParsingError)
from opensearch_tpu_torch.mapping.types import (format_date_millis,
                                                parse_date_millis)
from opensearch_tpu_torch.ops import aggs as agg_ops

MAX_BUCKETS = 65536          # search.max_buckets default
CARD_EXACT_MAX = 3000        # cardinality precision_threshold default
PCT_RAW_MAX = 10_000         # percentiles: raw values above this compress
PCT_CENTROIDS = 1024
HLL_P = 12                   # 4096 registers, ~1.6% relative error
_METRIC_TYPES = {"min", "max", "sum", "avg", "value_count", "stats",
                 "cardinality", "percentiles", "extended_stats",
                 "weighted_avg", "percentile_ranks",
                 "median_absolute_deviation", "top_hits"}
_BUCKET_TYPES = {"terms", "histogram", "date_histogram", "range",
                 "date_range", "ip_range", "filter", "filters", "global",
                 "missing", "significant_terms", "rare_terms",
                 "multi_terms", "composite"}
# pipeline aggs (search/pipeline_aggs.py) parse like any agg but collect
# nothing shard-side; they run as a reduce post-pass
from opensearch_tpu_torch.search.pipeline_aggs import (  # noqa: E402
    PIPELINE_TYPES as _PIPELINE_TYPES, apply_pipelines as _apply_pipelines)


_TUPLE_METRICS = {"min", "max", "sum", "avg", "value_count", "stats"}


def _host(x) -> np.ndarray:
    """A matched mask or scores as a numpy array (a device tensor is
    copied back)."""
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _metric_subs(req):
    """Sub-aggs that collect via the (sum, count, min, max) tuple
    machinery under terms/histogram/multi_terms/composite buckets.
    Pipeline subs collect nothing; top_hits has its own per-bucket path;
    anything else under these parents is an explicit 400 (the richer
    composition surface lives under filter/filters/range/global/missing,
    which recurse with full generality)."""
    out = []
    for s in req.subs:
        if s.type in _PIPELINE_TYPES or s.type == "top_hits":
            continue
        if s.type == "composite":
            raise IllegalArgumentError(
                "[composite] aggregation cannot be used with a parent "
                f"aggregation of type: [{req.type}]")
        if s.type not in _TUPLE_METRICS:
            raise IllegalArgumentError(
                f"[{req.type}] does not support [{s.type}] "
                "sub-aggregations (nest it under a filter instead)")
        out.append(s)
    return out


def _top_hits_subs(req):
    return [s for s in req.subs if s.type == "top_hits"]


@dataclass
class AggRequest:
    name: str
    type: str
    params: dict
    subs: list = dc_field(default_factory=list)


def parse_aggs(aggs_json: dict) -> list[AggRequest]:
    out = []
    for name, body in (aggs_json or {}).items():
        subs_json = body.get("aggs") or body.get("aggregations") or {}
        types = [k for k in body if k not in ("aggs", "aggregations", "meta")]
        if len(types) != 1:
            raise ParsingError(
                f"aggregation [{name}] must have exactly one type, got {types}")
        typ = types[0]
        if typ not in _METRIC_TYPES | _BUCKET_TYPES | _PIPELINE_TYPES:
            raise ParsingError(f"unknown aggregation type [{typ}]")
        subs = parse_aggs(subs_json)
        if typ in _METRIC_TYPES and subs:
            raise ParsingError(
                f"metric aggregation [{name}] cannot have sub-aggregations")
        if typ in _PIPELINE_TYPES and subs:
            raise ParsingError(
                f"pipeline aggregation [{name}] cannot have sub-aggregations")
        out.append(AggRequest(name, typ, body[typ], subs))
    return out


_DURATION = re.compile(r"^(\d+)(nanos|micros|ms|s|m|h|d)$")
_DUR_MS = {"nanos": 1e-6, "micros": 1e-3, "ms": 1, "s": 1000,
           "m": 60_000, "h": 3_600_000, "d": 86_400_000}
_CAL_FIXED_MS = {"second": 1000, "1s": 1000, "minute": 60_000, "1m": 60_000,
                 "hour": 3_600_000, "1h": 3_600_000, "day": 86_400_000,
                 "1d": 86_400_000, "week": 7 * 86_400_000, "1w": 7 * 86_400_000}


def _parse_duration_ms(s: str) -> int:
    m = _DURATION.match(str(s))
    if not m:
        raise IllegalArgumentError(f"failed to parse interval [{s}]")
    return int(m.group(1)) * _DUR_MS[m.group(2)]


def _floor_month(dt: _dt.datetime, months: int) -> _dt.datetime:
    total = dt.year * 12 + (dt.month - 1)
    total = (total // months) * months
    return _dt.datetime(total // 12, total % 12 + 1, 1, tzinfo=_dt.timezone.utc)


def _add_months(dt: _dt.datetime, months: int) -> _dt.datetime:
    total = dt.year * 12 + (dt.month - 1) + months
    return _dt.datetime(total // 12, total % 12 + 1, 1, tzinfo=_dt.timezone.utc)


def build_date_edges(lo: int, hi: int, calendar=None, fixed=None,
                     offset: int = 0) -> np.ndarray:
    """Ascending bucket edges (epoch millis) covering [lo, hi], aligned to
    the interval (Rounding.java analog, UTC only)."""
    if calendar in ("month", "1M", "quarter", "1q", "year", "1y"):
        months = {"month": 1, "1M": 1, "quarter": 3, "1q": 3,
                  "year": 12, "1y": 12}[calendar]
        start = _floor_month(
            _dt.datetime.fromtimestamp(lo / 1000, tz=_dt.timezone.utc), months)
        edges = [start]
        while edges[-1].timestamp() * 1000 <= hi:
            edges.append(_add_months(edges[-1], months))
        arr = np.asarray([int(e.timestamp() * 1000) for e in edges],
                         dtype=np.int64)
    else:
        if calendar is not None:
            ms = _CAL_FIXED_MS.get(calendar)
            if ms is None:
                raise IllegalArgumentError(
                    f"unknown calendar_interval [{calendar}]")
        else:
            ms = _parse_duration_ms(fixed)
        if calendar in ("week", "1w"):
            offset = (offset + 4 * 86_400_000) % ms   # epoch was a Thursday
        first = (lo - offset) // ms * ms + offset
        if first > lo:
            first -= ms
        n = (hi - first) // ms + 2
        if n > MAX_BUCKETS:
            raise IllegalArgumentError(
                f"trying to create too many buckets ({n} > {MAX_BUCKETS})")
        arr = first + ms * np.arange(n, dtype=np.int64)
    if len(arr) - 1 > MAX_BUCKETS:
        raise IllegalArgumentError(
            f"trying to create too many buckets ({len(arr) - 1} > {MAX_BUCKETS})")
    return arr


_NAMED_DATE_FORMATS = {
    "iso8601": "__iso8601__",
    "strict_date": "yyyy-MM-dd", "date": "yyyy-MM-dd",
    "strict_date_time": "yyyy-MM-dd'T'HH:mm:ss.SSSZ",
    "basic_date": "yyyyMMdd",
    "year_month_day": "yyyy-MM-dd",
    "strict_date_hour_minute_second": "yyyy-MM-dd'T'HH:mm:ss",
}


def _fmt_date(millis: int, fmt: str | None) -> str:
    if not fmt:
        return format_date_millis(int(millis))
    fmt = _NAMED_DATE_FORMATS.get(fmt, fmt)
    if fmt == "__iso8601__":
        return format_date_millis(int(millis))
    py = (fmt.replace("yyyy", "%Y").replace("MM", "%m").replace("dd", "%d")
          .replace("HH", "%H").replace("mm", "%M").replace("ss", "%S")
          .replace("'T'", "T"))
    dt = _dt.datetime.fromtimestamp(millis / 1000, tz=_dt.timezone.utc)
    return dt.strftime(py)


# ---------------------------------------------------------------------------
# Partial-tuple helpers (sum, count, min, max) — JSON-safe (no infinities).
# ---------------------------------------------------------------------------


def _ser_tuple(t) -> list:
    s, c, mn, mx = t
    return [float(s), int(c),
            None if not np.isfinite(mn) else float(mn),
            None if not np.isfinite(mx) else float(mx)]


def _merge_tuples(parts: list) -> tuple:
    s, c, mn, mx = 0.0, 0, np.inf, -np.inf
    for p in parts:
        if p is None:
            continue
        s += p[0]
        c += int(p[1])
        if p[2] is not None:
            mn = min(mn, p[2])
        if p[3] is not None:
            mx = max(mx, p[3])
    return s, c, mn, mx


def _top_hits_sort(sort):
    """(field, desc) for a top_hits sort spec; (None, True) = by _score.
    Numeric-field sorts only (the agg's common shape); anything else is
    a 400, not a silent misorder."""
    if sort is None:
        return None, True
    if isinstance(sort, list):
        if len(sort) != 1:
            raise IllegalArgumentError(
                "[top_hits] supports a single sort key")
        sort = sort[0]
    if isinstance(sort, str):
        return (None, True) if sort == "_score" else (sort, False)
    ((field, spec),) = sort.items()
    desc = (spec.get("order", "asc") if isinstance(spec, dict)
            else spec) == "desc"
    if field == "_score":
        return None, True
    return field, desc


def _finish_metric(typ: str, merged: tuple, params: dict | None = None):
    s, c, mn, mx = merged
    if typ == "sum":
        return {"value": s}
    if typ == "min":
        return {"value": mn if c else None}
    if typ == "max":
        return {"value": mx if c else None}
    if typ == "avg":
        return {"value": (s / c) if c else None}
    if typ == "value_count":
        return {"value": c}
    if typ == "stats":
        return {"count": c, "min": mn if c else None, "max": mx if c else None,
                "avg": (s / c) if c else None, "sum": s}
    raise IllegalArgumentError(f"metric type [{typ}] has no tuple finisher")


# ---------------------------------------------------------------------------
# HyperLogLog (cardinality past the exact threshold).
# ---------------------------------------------------------------------------


_SM_A = np.uint64(0x9E3779B97F4A7C15)
_SM_B = np.uint64(0xBF58476D1CE4E5B9)
_SM_C = np.uint64(0x94D049BB133111EB)


def _splitmix64(x: np.ndarray) -> np.ndarray:
    """Vectorized splitmix64 finalizer (uint64 -> uint64) — stable across
    processes, so values hashed on different shard nodes land in the same
    HLL register."""
    with np.errstate(over="ignore"):
        x = x + _SM_A
        x = (x ^ (x >> np.uint64(30))) * _SM_B
        x = (x ^ (x >> np.uint64(27))) * _SM_C
        return x ^ (x >> np.uint64(31))


def _hash64_values(values) -> np.ndarray:
    """uint64 hashes of a homogeneous value batch: integer and float
    ndarrays vectorize straight off their dtype (the high-cardinality
    numeric path — no Python object churn); anything else falls back to
    per-value inspection, with blake2b for strings (ordinal vocabularies
    are bounded)."""
    if isinstance(values, np.ndarray):
        if np.issubdtype(values.dtype, np.integer):
            return _splitmix64(values.astype(np.int64).view(np.uint64))
        if np.issubdtype(values.dtype, np.floating):
            f = values.astype(np.float64)
            f = np.where(f == 0.0, 0.0, f)   # canonicalize -0.0
            return _splitmix64(f.view(np.uint64))
        values = values.tolist()
    vals = list(values)
    if not vals:
        return np.zeros(0, np.uint64)
    if all(isinstance(v, bool) or isinstance(v, (int, np.integer))
           for v in vals):
        return _splitmix64(np.asarray(vals, np.int64).view(np.uint64))
    if all(isinstance(v, (int, float, np.floating, np.integer))
           for v in vals):
        f = np.asarray(vals, np.float64)
        f = np.where(f == 0.0, 0.0, f)       # canonicalize -0.0
        return _splitmix64(f.view(np.uint64))
    return np.asarray([int.from_bytes(
        hashlib.blake2b(repr(v).encode(), digest_size=8).digest(),
        "little") for v in vals], np.uint64)


def _hll_add_hashes(regs: np.ndarray, hashes: np.ndarray) -> np.ndarray:
    idx = (hashes & np.uint64((1 << HLL_P) - 1)).astype(np.int64)
    w = hashes >> np.uint64(HLL_P)
    nbits = 64 - HLL_P
    # bit_length via successive shifts (log2 on uint64 is lossy)
    bit_length = np.zeros(len(hashes), np.int64)
    ww = w.copy()
    for shift in (32, 16, 8, 4, 2, 1):
        big = ww >= (np.uint64(1) << np.uint64(shift))
        bit_length = np.where(big, bit_length + shift, bit_length)
        ww = np.where(big, ww >> np.uint64(shift), ww)
    bit_length = np.where(w != 0, bit_length + 1, 0)
    # rank = leading zeros of the (64-P)-bit suffix + 1
    rank = (nbits - bit_length + 1).astype(np.uint8)
    np.maximum.at(regs, idx, rank)
    return regs


def _hll_from_values(values) -> np.ndarray:
    regs = np.zeros(1 << HLL_P, np.uint8)
    return _hll_add_hashes(regs, _hash64_values(values))


def _hll_estimate(regs: np.ndarray) -> int:
    m = regs.size
    alpha = 0.7213 / (1 + 1.079 / m)
    est = alpha * m * m / float(np.sum(2.0 ** -regs.astype(np.float64)))
    if est <= 2.5 * m:
        zeros = int((regs == 0).sum())
        if zeros:
            est = m * np.log(m / zeros)
    return int(round(est))


# ---------------------------------------------------------------------------
# Weighted centroids (percentiles past the raw cap) — TDigest-lite.
# ---------------------------------------------------------------------------


def _compress_centroids(values: np.ndarray, weights: np.ndarray,
                        n: int = PCT_CENTROIDS):
    order = np.argsort(values, kind="stable")
    v, w = values[order], weights[order]
    cw = np.cumsum(w)
    total = cw[-1]
    bins = np.minimum(((cw - w / 2.0) / total * n).astype(np.int64), n - 1)
    sums = np.bincount(bins, weights=v * w, minlength=n)
    ws = np.bincount(bins, weights=w, minlength=n)
    keep = ws > 0
    return sums[keep] / ws[keep], ws[keep]


def _weighted_percentile(v: np.ndarray, w: np.ndarray, p: float) -> float:
    """Linear-interpolated quantile over point masses; reproduces
    np.percentile exactly when every weight is 1."""
    order = np.argsort(v, kind="stable")
    v, w = v[order], w[order]
    pos = np.cumsum(w) - 1.0
    target = p / 100.0 * (w.sum() - 1.0)
    return float(np.interp(target, pos, v))


# ---------------------------------------------------------------------------
# Shard-side collection
# ---------------------------------------------------------------------------


class AggregationExecutor:
    """Runs an agg tree over per-segment matched masks.

    ``seg_views`` is [(seg, dseg, matched)] — the query phase's
    matched masks, one per segment.
    """

    def __init__(self, ctx, scores_of: dict | None = None):
        self.ctx = ctx               # compiler.ShardContext
        # per-segment query-phase scores (seg.name -> [n_pad] array);
        # only top_hits needs them, and only when sorting by _score
        self.scores_of = scores_of or {}

    def run(self, aggs_json: dict, seg_views: list) -> dict:
        """Single-shard convenience: collect + reduce of one partial."""
        return reduce_aggs(aggs_json, [self.collect(aggs_json, seg_views)])

    def collect(self, aggs_json: dict, seg_views: list) -> dict:
        """Shard-side phase: one JSON-serializable partial per agg."""
        reqs = parse_aggs(aggs_json)
        return {r.name: self._part_one(r, seg_views) for r in reqs}

    # -- helpers ----------------------------------------------------------

    def _field_type(self, req, caller):
        field = req.params.get("field")
        if field is None:
            if caller == "terms":
                raise ParsingError(
                    "Required one of fields [field, script], but none "
                    "were specified. ")
            raise ParsingError(f"[{caller}] aggregation requires a [field]")
        ft = self.ctx.field_type(field)
        if ft is not None and ft.dv_kind == "none":
            raise IllegalArgumentError(
                f"Text fields are not optimised for operations that require "
                f"per-document field data like aggregations and sorting, so "
                f"these operations are disabled by default. Please use a "
                f"keyword field instead. Alternatively, set fielddata=true "
                f"on [{field}]")
        return field, ft

    def _numeric_column(self, seg, field):
        return seg.numeric_dv.get(field)

    def _dev_numeric(self, dseg, field):
        return dseg.numeric.get(field)

    @staticmethod
    def _collect(segs, mode, n_subs=0, edges=None, self_metric=False):
        """The bucket collector (K5 on the card: one launch over every
        segment of ``segs``, one copy back) as per segment ``(counts,
        [(sum, count, min, max) per sub])`` numpy arrays."""
        if not segs:
            return []
        flat = agg_ops.bucket_collect(segs, mode=mode, edges=edges,
                                      self_metric=self_metric)
        return agg_ops.unpack(flat.cpu().numpy(), segs,
                              1 if self_metric else n_subs)

    # -- dispatch ---------------------------------------------------------

    def _part_one(self, req, seg_views) -> dict:
        if req.type in _PIPELINE_TYPES:
            return {"t": "pipeline"}     # reduce-side only, no shard work
        if req.type in ("min", "max", "sum", "avg", "value_count", "stats"):
            return self._part_metric(req, seg_views)
        fn = getattr(self, f"_part_{req.type}", None)
        if fn is None:
            raise ParsingError(f"unknown aggregation type [{req.type}]")
        return fn(req, seg_views)

    # -- metrics ----------------------------------------------------------

    def _collect_metric_partials(self, field, seg_views):
        s = 0.0
        c = 0
        mn, mx = np.inf, -np.inf
        segs = []
        for seg, dseg, matched in seg_views:
            col = self._dev_numeric(dseg, field)
            if col is None:
                continue
            segs.append(agg_ops.CollectSegment(
                matched, col["values"], col["value_docs"], 1))
        for _counts, ((ss, cc, mnn, mxx),) in self._collect(
                segs, "single", self_metric=True):
            s += float(ss[0])
            c += int(cc[0])
            mn = min(mn, float(mnn[0]))
            mx = max(mx, float(mxx[0]))
        return s, c, mn, mx

    def _part_metric(self, req, seg_views) -> dict:
        field, ft = self._field_type(req, req.type)
        if (req.type == "value_count" and ft is not None
                and ft.dv_kind == "ordinal"):
            segs = [agg_ops.CollectSegment(matched, col["ords"],
                                           col["value_docs"], 1)
                    for _seg, dseg, matched in seg_views
                    for col in (dseg.ordinal.get(field),) if col is not None]
            total = sum(int(counts[0]) for counts, _subs in
                        self._collect(segs, "single"))
            return {"t": "metric", "v": [0.0, total, None, None]}
        return {"t": "metric",
                "v": _ser_tuple(self._collect_metric_partials(field,
                                                              seg_views))}

    def _part_cardinality(self, req, seg_views) -> dict:
        """Exact set below precision_threshold; STREAMING degradation to
        HLL registers past it — the set never grows beyond the threshold
        no matter how many distinct values the segments hold (r3 Weak #5:
        bounded memory)."""
        field, ft = self._field_type(req, "cardinality")
        threshold = int(req.params.get("precision_threshold",
                                       CARD_EXACT_MAX))
        distinct: set = set()
        regs = None
        for seg, dseg, matched in seg_views:
            m = _host(matched)
            if ft is not None and ft.dv_kind == "ordinal":
                dv = seg.ordinal_dv.get(field)
                if dv is None:
                    continue
                ok = m[dv.value_docs] if len(dv.value_docs) else \
                    np.zeros(0, bool)
                new = [dv.ord_terms[o] for o in np.unique(dv.ords[ok])]
            else:
                dv = seg.numeric_dv.get(field)
                if dv is None:
                    continue
                ok = m[dv.value_docs] if len(dv.value_docs) else \
                    np.zeros(0, bool)
                new = np.unique(dv.values[ok])   # stays an ndarray:
                # the HLL path hashes it straight off the dtype
            if regs is None:
                # exact while possible: the union may dedup below the
                # threshold even when count-sums exceed it
                distinct.update(new if isinstance(new, list)
                                else new.tolist())
                if len(distinct) > threshold:
                    regs = _hll_from_values(distinct)
                    distinct.clear()
            else:
                regs = _hll_add_hashes(regs, _hash64_values(new))
        if regs is None:
            return {"t": "card", "kind": "set",
                    "v": sorted(distinct, key=repr), "thr": threshold}
        return {"t": "card", "kind": "hll", "regs": regs.tolist(),
                "thr": threshold}

    def _part_percentiles(self, req, seg_views) -> dict:
        """Small matched sets stay raw (exact quantiles); past the cap the
        DEVICE sorts and bins values into equal-weight centroids
        (ops/aggs.py masked_centroids) — host memory stays O(PCT_CENTROIDS)
        per segment no matter how many values matched (SURVEY §7.2's
        on-device agg mandate; fixes r3 Weak #5's unbounded
        materialization)."""
        field, _ = self._field_type(req, "percentiles")
        raw_chunks = []
        cent_m, cent_w = [], []
        for seg, dseg, matched in seg_views:
            dv = seg.numeric_dv.get(field)
            col = self._dev_numeric(dseg, field)
            if dv is None or col is None or not len(dv.value_docs):
                continue
            n_matched = int(matched[col["value_docs"].long()].sum())
            if n_matched == 0:
                continue
            if n_matched <= PCT_RAW_MAX:
                ok = _host(matched)[dv.value_docs]
                raw_chunks.append(dv.values[ok].astype(np.float64))
            else:
                means, weights = agg_ops.masked_centroids(
                    col["values"], col["value_docs"], matched,
                    n_cent=PCT_CENTROIDS)
                means, weights = means.cpu().numpy(), weights.cpu().numpy()
                keep = weights > 0
                cent_m.append(means[keep])
                cent_w.append(weights[keep].astype(np.float64))
        if not raw_chunks and not cent_m:
            return {"t": "pct", "kind": "raw", "v": []}
        if cent_m or sum(len(c) for c in raw_chunks) > PCT_RAW_MAX:
            if raw_chunks:
                allv = np.concatenate(raw_chunks)
                cent_m.append(allv)
                cent_w.append(np.ones_like(allv))
            m = np.concatenate(cent_m)
            w = np.concatenate(cent_w)
            if len(m) > 4 * PCT_CENTROIDS:
                m, w = _compress_centroids(m, w)
            return {"t": "pct", "kind": "cent",
                    "m": m.tolist(), "w": w.tolist()}
        allv = np.concatenate(raw_chunks)
        return {"t": "pct", "kind": "raw", "v": allv.tolist()}

    def _part_percentile_ranks(self, req, seg_views) -> dict:
        """Same mergeable value sketch as percentiles (raw below the cap,
        equal-weight centroids above); the rank direction happens at
        reduce.  Ref metrics/PercentileRanksAggregationBuilder.java."""
        if req.params.get("values") is None:
            raise ParsingError(
                "[percentile_ranks] requires a [values] array")
        return self._part_percentiles(req, seg_views)

    def _part_median_absolute_deviation(self, req, seg_views) -> dict:
        """MAD over the same sketch (exact on raw partials; on centroid
        partials the weighted-median deviation is the TDigest-style
        approximation the reference documents).  Ref
        metrics/MedianAbsoluteDeviationAggregator.java."""
        return self._part_percentiles(req, seg_views)

    def _part_extended_stats(self, req, seg_views) -> dict:
        """stats + sum_of_squares partial (the extra moment the variance
        family needs).  Ref metrics/ExtendedStatsAggregator.java."""
        field, _ = self._field_type(req, "extended_stats")
        s = sq = 0.0
        c = 0
        mn, mx = np.inf, -np.inf
        for seg, dseg, matched in seg_views:
            dv = seg.numeric_dv.get(field)
            if dv is None or not len(dv.value_docs):
                continue
            ok = _host(matched)[dv.value_docs]
            v = dv.values[ok].astype(np.float64)
            if not len(v):
                continue
            s += float(v.sum())
            sq += float((v * v).sum())
            c += int(len(v))
            mn = min(mn, float(v.min()))
            mx = max(mx, float(v.max()))
        return {"t": "estats",
                "v": _ser_tuple((s, c, mn, mx)) + [float(sq)]}

    def _part_weighted_avg(self, req, seg_views) -> dict:
        """sum(value*weight) / sum(weight) partial.  Multi-valued value
        fields weight every value by the doc's (single-valued) weight;
        docs missing the weight field are skipped, docs missing the
        value field use [value.missing] if set.  Ref
        metrics/WeightedAvgAggregator.java."""
        vcfg = req.params.get("value") or {}
        wcfg = req.params.get("weight") or {}
        vfield, wfield = vcfg.get("field"), wcfg.get("field")
        if not vfield or not wfield:
            raise ParsingError(
                "[weighted_avg] requires [value.field] and [weight.field]")
        v_missing = vcfg.get("missing")
        vw_sum = w_sum = 0.0
        for seg, dseg, matched in seg_views:
            wdv = seg.numeric_dv.get(wfield)
            if wdv is None or not len(wdv.value_docs):
                continue
            m = _host(matched)
            weight_of = np.zeros(seg.n_docs)
            has_w = np.zeros(seg.n_docs, bool)
            wok = m[wdv.value_docs]
            weight_of[wdv.value_docs[wok]] = wdv.values[wok].astype(np.float64)
            has_w[wdv.value_docs[wok]] = True
            vdv = seg.numeric_dv.get(vfield)
            got_v = np.zeros(seg.n_docs, bool)
            if vdv is not None and len(vdv.value_docs):
                vok = m[vdv.value_docs] & has_w[vdv.value_docs]
                vd = vdv.value_docs[vok]
                vw_sum += float((vdv.values[vok].astype(np.float64)
                                 * weight_of[vd]).sum())
                # each doc's weight counts once no matter how many values
                got_v[vd] = True
                w_sum += float(weight_of[np.nonzero(got_v)[0]].sum())
            if v_missing is not None:
                fill = has_w & ~got_v & m[: seg.n_docs]
                vw_sum += float(v_missing) * float(weight_of[fill].sum())
                w_sum += float(weight_of[fill].sum())
        return {"t": "wavg", "v": [vw_sum, w_sum]}

    def _part_top_hits(self, req, seg_views) -> dict:
        """Per-shard top hits by query score (or a numeric field sort),
        serialized with their _source so the coordinator merge needs no
        second fetch round-trip.  Ref metrics/TopHitsAggregator.java."""
        hits, total = self._top_hits_collect(req, seg_views)
        return {"t": "tophits", "hits": hits, "total": total}

    def _top_hits_collect(self, req, seg_views):
        from opensearch_tpu_torch.search.fetch import filter_source

        size = int(req.params.get("size", 3))
        from_ = int(req.params.get("from", 0))
        want = from_ + size
        sort_field, sort_desc = _top_hits_sort(req.params.get("sort"))
        source_spec = req.params.get("_source")
        rows = []
        total = 0
        for seg, dseg, matched in seg_views:
            m = _host(matched)[: seg.n_docs]
            docs = np.nonzero(m)[0]
            total += int(len(docs))
            if not len(docs):
                continue
            if sort_field is None:
                scores = self.scores_of.get(seg.seg_id)
                key = (_host(scores)[: seg.n_docs][docs]
                       if scores is not None
                       else np.zeros(len(docs)))
                desc = True
            else:
                dv = seg.numeric_dv.get(sort_field)
                key = np.full(len(docs), np.nan)
                if dv is not None and len(dv.value_docs):
                    col = np.full(seg.n_docs, np.nan)
                    col[dv.value_docs[::-1]] = dv.values[::-1]  # first value
                    key = col[docs]
                desc = sort_desc
            nan_safe = np.where(np.isnan(key), -np.inf if desc else np.inf,
                                key)                   # missing sorts last
            order = np.argsort(-nan_safe if desc else nan_safe,
                               kind="stable")[:want]
            for i in order:
                d = int(docs[i])
                k = key[i]
                rows.append((float(k) if np.isfinite(k) else None, seg, d))
        last = -np.inf if (sort_field is None or sort_desc) else np.inf
        rows.sort(key=lambda r: r[0] if r[0] is not None else last,
                  reverse=(sort_field is None or sort_desc))
        out = []
        for k, seg, d in rows[:want]:
            hit = {"_id": seg.doc_ids[d],
                   "_score": k if sort_field is None else None}
            src = filter_source(seg.source(d), source_spec)
            if src is not None:
                hit["_source"] = src
            if sort_field is not None:
                hit["sort"] = [k]
            out.append(hit)
        return out, total

    # -- terms ------------------------------------------------------------

    def _part_terms(self, req, seg_views) -> dict:
        field, ft = self._field_type(req, "terms")
        size = int(req.params.get("size", 10))
        order = req.params.get("order", {"_count": "desc"})
        missing = req.params.get("missing")
        if ft is None:
            if missing is None:
                return {"t": "terms", "tn": None, "dk": None,
                        "buckets": [], "others": 0, "min_inc": 0}
            # unmapped field + missing: every matched doc buckets under
            # the missing value (TermsAggregatorFactory unmapped+missing)
            total = sum(int(_host(m)[: s.n_docs].sum())
                        for s, _d, m in seg_views)
            value_type = req.params.get("value_type")
            if value_type == "date":
                tn, dk = "date", "long"
                missing = int(parse_date_millis(missing))
            elif isinstance(missing, bool):
                tn, dk, missing = "boolean", "long", int(missing)
            elif isinstance(missing, str):
                tn, dk = "keyword", "ordinal"
            elif isinstance(missing, int):
                tn, dk = "long", "long"
            else:
                tn, dk = "double", "double"
            buckets = [[missing, total, {}]] if total else []
            return {"t": "terms", "tn": tn, "dk": dk, "buckets": buckets,
                    "others": 0, "min_inc": 0}
        msubs = _metric_subs(req)
        if ft.dv_kind == "ordinal":
            merged, sub_parts = self._terms_ordinal(field, seg_views, msubs)
        else:
            merged, sub_parts = self._terms_numeric(field, seg_views, msubs)
        if int(req.params.get("min_doc_count", 1)) == 0:
            # zero-count buckets: every term of the index joins with 0
            # (TermsAggregator's buildEmptyAggregation grid fill)
            for seg, _d, _m in seg_views:
                if ft.dv_kind == "ordinal":
                    dv = seg.ordinal_dv.get(field)
                    for t in (dv.ord_terms if dv is not None else ()):
                        merged.setdefault(t, 0)
                else:
                    dv = seg.numeric_dv.get(field)
                    if dv is not None:
                        for v in np.unique(dv.values):
                            key = (float(v) if dv.kind == "double"
                                   else int(v))
                            merged.setdefault(key, 0)
        if missing is not None:
            # docs without a value for the field take the missing value
            absent = 0
            for seg, dseg, matched in seg_views:
                m = _host(matched)[: seg.n_docs]
                dv = (seg.ordinal_dv if ft.dv_kind == "ordinal"
                      else seg.numeric_dv).get(field)
                with_val = (len(np.unique(dv.value_docs[
                    m[dv.value_docs]])) if dv is not None
                    and len(dv.value_docs) else 0)
                absent += int(m.sum()) - with_val
            if absent:
                key = (missing if ft.dv_kind == "ordinal"
                       else (float(missing) if ft.dv_kind == "double"
                             else int(parse_date_millis(missing)
                                      if ft.type_name == "date"
                                      and isinstance(missing, str)
                                      else missing)))
                merged[key] = merged.get(key, 0) + absent
        shard_size = int(req.params.get("shard_size")
                         or max(size, int(size * 1.5 + 10)))
        items = sorted(merged.items(), key=_terms_order_key(order))
        kept, tail = items[:shard_size], items[shard_size:]
        others = sum(c for _k, c in tail)
        # the error-bound contract only holds for count-descending order
        is_count_desc = _is_count_desc(order)
        min_inc = kept[-1][1] if (tail and kept and is_count_desc) else 0
        buckets = []
        th_subs = _top_hits_subs(req)
        for key, count in kept:
            subs = {sub.name: _ser_tuple(sub_parts.get(
                (sub.name, key), (0.0, 0, np.inf, -np.inf)))
                for sub in msubs}
            for sub in th_subs:     # per-bucket top hits: narrowed mask
                subs[sub.name] = self._part_top_hits(
                    sub, self._terms_key_views(field, ft, seg_views, key))
            buckets.append([key, int(count), subs])
        return {"t": "terms", "tn": ft.type_name, "dk": ft.dv_kind,
                "buckets": buckets, "others": int(others),
                "min_inc": int(min_inc)}

    def _terms_key_views(self, field, ft, seg_views, key):
        """seg_views narrowed to docs holding ``key`` in ``field``."""
        out = []
        for seg, dseg, matched in seg_views:
            m = _host(matched)[: seg.n_docs]
            mask = np.zeros(seg.n_docs, bool)
            if ft.dv_kind == "ordinal":
                dv = seg.ordinal_dv.get(field)
                if dv is not None and len(dv.value_docs):
                    o = dv.term_to_ord.get(key, -1)
                    if o >= 0:
                        mask[dv.value_docs[dv.ords == o]] = True
            else:
                dv = seg.numeric_dv.get(field)
                if dv is not None and len(dv.value_docs):
                    mask[dv.value_docs[dv.values == key]] = True
            out.append((seg, dseg, m & mask))
        return out

    def _terms_ordinal(self, field, seg_views, subs):
        """Ordinal doc counts and the metric subs' partials of every
        segment from one collector call (K5's ordinal mode on the card:
        one launch, the subs in it), merged across segments by term in
        numpy: each segment's counts and partials add into per-term
        arrays in segment order, as the reference's per-term loop adds
        them."""
        views = [(seg.ordinal_dv[field], dseg.ordinal[field], dseg, matched)
                 for seg, dseg, matched in seg_views
                 if seg.ordinal_dv.get(field) is not None
                 and dseg.ordinal.get(field) is not None]
        sub_fields = [self._field_type(sub, sub.type)[0]
                      for sub in subs] if views else []
        segs = [agg_ops.CollectSegment(
            matched, col["ords"], col["value_docs"], len(dv.ord_terms),
            [self._dev_numeric(dseg, sf) for sf in sub_fields])
            for dv, col, dseg, matched in views]
        index: dict = {}
        gids = [np.fromiter((index.setdefault(t, len(index))
                             for t in dv.ord_terms), np.int64,
                            len(dv.ord_terms)) for dv, _c, _d, _m in views]
        n_terms = len(index)
        total = np.zeros(n_terms, np.int64)
        seen = np.zeros(n_terms, bool)
        acc = [(np.zeros(n_terms), np.zeros(n_terms, np.int64),
                np.full(n_terms, np.inf), np.full(n_terms, -np.inf))
               for _sub in subs]
        for (dv, _c, _d, _m), seg_in, g_of, (counts, sub_out) in zip(
                views, segs, gids,
                self._collect(segs, "ordinal", len(subs))):
            nz = np.nonzero(counts[: len(dv.ord_terms)])[0]
            g = g_of[nz]                    # distinct within a segment
            total[g] += counts[nz]
            seen[g] = True
            for (ps, pc, pmn, pmx), scol, (s, c, mn, mx) in zip(
                    acc, seg_in.subs, sub_out):
                if scol is None:
                    continue
                ps[g] += s[nz]
                pc[g] += c[nz]
                pmn[g] = np.minimum(pmn[g], mn[nz])
                pmx[g] = np.maximum(pmx[g], mx[nz])
        merged = {t: int(total[i]) for t, i in index.items() if seen[i]}
        sub_parts = {(sub.name, t): (float(ps[i]), int(pc[i]),
                                     float(pmn[i]), float(pmx[i]))
                     for sub, (ps, pc, pmn, pmx) in zip(subs, acc)
                     for t, i in index.items() if seen[i]}
        return merged, sub_parts

    def _terms_numeric(self, field, seg_views, subs):
        merged: dict = {}
        sub_parts: dict = {}
        for seg, dseg, matched in seg_views:
            dv = seg.numeric_dv.get(field)
            if dv is None or not len(dv.value_docs):
                continue
            m = _host(matched)
            ok = m[dv.value_docs]
            vals, docs = dv.values[ok], dv.value_docs[ok]
            # docs count once per distinct value; keep the native dtype for
            # the dedup — a float64 cast would collapse longs above 2^53
            pair_dtype = np.int64 if dv.kind == "long" else np.float64
            pairs = np.unique(np.stack([vals.astype(pair_dtype),
                                        docs.astype(pair_dtype)]), axis=1)
            uniq_vals, counts = np.unique(pairs[0], return_counts=True)
            for v, c in zip(uniq_vals, counts):
                key = float(v) if dv.kind == "double" else int(v)
                merged[key] = merged.get(key, 0) + int(c)
            for sub in subs:
                sf, _sft = self._field_type(sub, sub.type)
                sdv = seg.numeric_dv.get(sf)
                if sdv is None:
                    continue
                per_doc_sum = np.zeros(seg.n_docs)
                per_doc_cnt = np.zeros(seg.n_docs, np.int64)
                per_doc_min = np.full(seg.n_docs, np.inf)
                per_doc_max = np.full(seg.n_docs, -np.inf)
                sok = m[sdv.value_docs] if len(sdv.value_docs) else np.zeros(0, bool)
                np.add.at(per_doc_sum, sdv.value_docs[sok],
                          sdv.values[sok].astype(np.float64))
                np.add.at(per_doc_cnt, sdv.value_docs[sok], 1)
                np.minimum.at(per_doc_min, sdv.value_docs[sok],
                              sdv.values[sok].astype(np.float64))
                np.maximum.at(per_doc_max, sdv.value_docs[sok],
                              sdv.values[sok].astype(np.float64))
                for v, d in zip(pairs[0], pairs[1].astype(np.int64)):
                    key0 = v if dv.kind == "double" else int(v)
                    key = (sub.name, key0)
                    ps, pc, pmn, pmx = sub_parts.get(key,
                                                     (0.0, 0, np.inf, -np.inf))
                    sub_parts[key] = (ps + per_doc_sum[d],
                                      pc + int(per_doc_cnt[d]),
                                      min(pmn, per_doc_min[d]),
                                      max(pmx, per_doc_max[d]))
        return merged, sub_parts

    # -- significant / rare / multi terms ---------------------------------

    def _field_term_counts(self, field, ft, seg, matched_np) -> dict:
        """term -> doc_count over one segment's matched mask (each doc
        counts once per distinct value)."""
        out: dict = {}
        if ft.dv_kind == "ordinal":
            dv = seg.ordinal_dv.get(field)
            if dv is None or not len(dv.value_docs):
                return out
            ok = matched_np[dv.value_docs]
            ords, counts = np.unique(dv.ords[ok], return_counts=True)
            for o, c in zip(ords, counts):
                if o >= 0:
                    out[dv.ord_terms[o]] = int(c)
        else:
            dv = seg.numeric_dv.get(field)
            if dv is None or not len(dv.value_docs):
                return out
            ok = matched_np[dv.value_docs]
            pair_dtype = np.int64 if dv.kind == "long" else np.float64
            pairs = np.unique(np.stack(
                [dv.values[ok].astype(pair_dtype),
                 dv.value_docs[ok].astype(pair_dtype)]), axis=1)
            vals, counts = np.unique(pairs[0], return_counts=True)
            for v, c in zip(vals, counts):
                key = float(v) if dv.kind == "double" else int(v)
                out[key] = int(c)
        return out

    def _part_significant_terms(self, req, seg_views) -> dict:
        """Foreground (matched) vs background (whole live segment) term
        counts; the JLH scoring happens at reduce over the merged totals.
        Ref bucket/terms/SignificantTermsAggregatorFactory.java +
        heuristic/JLHScore.java."""
        field, ft = self._field_type(req, "significant_terms")
        if ft is None:
            return {"t": "sig", "tn": None, "dk": None, "fg_total": 0,
                    "bg_total": 0, "buckets": []}
        fg: dict = {}
        bg: dict = {}
        fg_total = bg_total = 0
        for seg, dseg, matched in seg_views:
            m = _host(matched)[: seg.n_docs]
            live = _host(self.ctx.live_mask(seg, dseg))[: seg.n_docs]
            fg_total += int(m.sum())
            bg_total += int(live.sum())
            for t, c in self._field_term_counts(field, ft, seg, m).items():
                fg[t] = fg.get(t, 0) + c
            for t, c in self._field_term_counts(field, ft, seg,
                                                live).items():
                bg[t] = bg.get(t, 0) + c
        shard_size = int(req.params.get("shard_size")
                         or max(int(req.params.get("size", 10)) * 2, 100))
        rows = [[t, c, bg.get(t, c)] for t, c in fg.items()]
        rows.sort(key=lambda r: -_jlh(r[1], fg_total, r[2], bg_total))
        return {"t": "sig", "tn": ft.type_name, "dk": ft.dv_kind,
                "fg_total": fg_total, "bg_total": bg_total,
                "buckets": rows[:shard_size]}

    def _part_rare_terms(self, req, seg_views) -> dict:
        """Counts for terms at-or-below max_doc_count, plus the names of
        terms already over it ('over'): a term rare on every shard can
        still sum over the threshold, and a term omitted by one shard is
        ambiguous without the over-list (the reference uses a CuckooFilter
        for the same exclusion — bucket/terms/RareTermsAggregator).."""
        field, ft = self._field_type(req, "rare_terms")
        max_dc = int(req.params.get("max_doc_count", 1))
        if max_dc < 1 or max_dc > 100:
            raise IllegalArgumentError(
                "[max_doc_count] must be in [1, 100]")
        if ft is None:
            return {"t": "rare", "tn": None, "dk": None, "buckets": [],
                    "over": []}
        counts: dict = {}
        for seg, dseg, matched in seg_views:
            m = _host(matched)[: seg.n_docs]
            for t, c in self._field_term_counts(field, ft, seg, m).items():
                counts[t] = counts.get(t, 0) + c
        rare = [[t, c] for t, c in counts.items() if c <= max_dc]
        over = [t for t, c in counts.items() if c > max_dc]
        return {"t": "rare", "tn": ft.type_name, "dk": ft.dv_kind,
                "buckets": rare, "over": over}

    def _part_multi_terms(self, req, seg_views) -> dict:
        """Buckets per combination of values across N fields (cartesian
        per doc, the reference's MultiTermsAggregator).  Metric sub-aggs
        accumulate per combination in the same pass."""
        specs = req.params.get("terms")
        if not isinstance(specs, list) or len(specs) < 2:
            raise ParsingError(
                "[multi_terms] requires at least two [terms] sources")
        if _top_hits_subs(req):
            raise IllegalArgumentError(
                "[multi_terms] does not support [top_hits] "
                "sub-aggregations (nest top_hits under terms or a filter)")
        fields = []
        for spec in specs:
            f = spec.get("field")
            if not f:
                raise ParsingError("[multi_terms] source requires [field]")
            fields.append((f, self.ctx.field_type(f)))
        msubs = _metric_subs(req)
        merged: dict = {}
        sub_parts: dict = {}
        for seg, dseg, matched in seg_views:
            m = _host(matched)[: seg.n_docs]
            per_field = [self._doc_values_lists(f, ft, seg, m)
                         for f, ft in fields]
            docs = set(per_field[0])
            for vals in per_field[1:]:
                docs &= set(vals)
            sub_cols = [self._doc_metric_tuples(sub, seg, m)
                        for sub in msubs]
            import itertools

            for d in docs:
                combos = list(itertools.product(
                    *[vals[d] for vals in per_field]))
                for key in combos:
                    merged[key] = merged.get(key, 0) + 1
                for si, sub in enumerate(msubs):
                    tup = sub_cols[si].get(d)
                    if tup is None:
                        continue
                    for key in combos:
                        prev = sub_parts.get((sub.name, key),
                                             (0.0, 0, np.inf, -np.inf))
                        sub_parts[(sub.name, key)] = (
                            prev[0] + tup[0], prev[1] + tup[1],
                            min(prev[2], tup[2]), max(prev[3], tup[3]))
        size = int(req.params.get("size", 10))
        shard_size = int(req.params.get("shard_size")
                         or max(size, int(size * 1.5 + 10)))
        order = req.params.get("order", {"_count": "desc"})
        items = sorted(merged.items(), key=_terms_order_key(order))
        kept, tail = items[:shard_size], items[shard_size:]
        min_inc = (kept[-1][1] if tail and kept and _is_count_desc(order)
                   else 0)
        buckets = []
        for key, count in kept:
            subs = {sub.name: _ser_tuple(sub_parts.get(
                (sub.name, key), (0.0, 0, np.inf, -np.inf)))
                for sub in msubs}
            buckets.append([list(key), int(count), subs])
        return {"t": "mterms", "buckets": buckets,
                "others": sum(c for _k, c in tail), "min_inc": int(min_inc)}

    def _doc_values_lists(self, field, ft, seg, matched_np) -> dict:
        """doc -> list of values for one field (matched docs only)."""
        out: dict = {}
        if ft is not None and ft.dv_kind == "ordinal":
            dv = seg.ordinal_dv.get(field)
            if dv is None:
                return out
            ok = matched_np[dv.value_docs] & (dv.ords >= 0)
            for d, o in zip(dv.value_docs[ok], dv.ords[ok]):
                out.setdefault(int(d), []).append(dv.ord_terms[o])
        else:
            dv = seg.numeric_dv.get(field)
            if dv is None:
                return out
            ok = matched_np[dv.value_docs]
            for d, v in zip(dv.value_docs[ok], dv.values[ok]):
                out.setdefault(int(d), []).append(
                    float(v) if dv.kind == "double" else int(v))
        return out

    def _doc_metric_tuples(self, sub, seg, matched_np) -> dict:
        """doc -> (sum, count, min, max) for one metric sub-agg field."""
        sf, _sft = self._field_type(sub, sub.type)
        dv = seg.numeric_dv.get(sf)
        out: dict = {}
        if dv is None:
            return out
        ok = matched_np[dv.value_docs]
        for d, v in zip(dv.value_docs[ok], dv.values[ok].astype(np.float64)):
            prev = out.get(int(d), (0.0, 0, np.inf, -np.inf))
            out[int(d)] = (prev[0] + v, prev[1] + 1, min(prev[2], v),
                           max(prev[3], v))
        return out

    # -- composite --------------------------------------------------------

    def _part_composite(self, req, seg_views) -> dict:
        """Paginated multi-source buckets: each shard emits its first
        ``size`` keys after ``after`` in composite order, so the merged
        union always contains the global first ``size`` (ref
        bucket/composite/CompositeAggregator.java).  Sources: terms,
        histogram, date_histogram."""
        sources = _composite_sources(req)
        if int(req.params.get("size", 10)) > MAX_BUCKETS:
            raise IllegalArgumentError(
                f"Trying to create too many buckets "
                f"({req.params.get('size')} > {MAX_BUCKETS})")
        if _top_hits_subs(req):
            raise IllegalArgumentError(
                "[composite] does not support [top_hits] "
                "sub-aggregations (nest top_hits under terms or a filter)")
        size = int(req.params.get("size", 10))
        after = req.params.get("after")
        if after is not None:
            missing_srcs = [s[0] for s in sources if s[0] not in after]
            if missing_srcs:
                raise ParsingError(
                    f"[composite] after key is missing sources "
                    f"{missing_srcs}")
        if after is not None:
            vals = []
            for name, _f, _x, _o, kind, _fmt in sources:
                v = after[name]
                if kind == "date" and isinstance(v, str) \
                        and not v.lstrip("-").isdigit():
                    v = parse_date_millis(v)
                vals.append(v)
            after_key = tuple(vals)
        else:
            after_key = None
        msubs = _metric_subs(req)
        merged: dict = {}
        sub_parts: dict = {}
        for seg, dseg, matched in seg_views:
            m = _host(matched)[: seg.n_docs]
            per_source = []
            for name, field, xform, _order, _kind, _fmt in sources:
                ft = self.ctx.field_type(field)
                vals = self._doc_values_lists(field, ft, seg, m)
                if xform is not None:
                    vals = {d: sorted({xform(v) for v in vs})
                            for d, vs in vals.items()}
                per_source.append(vals)
            docs = set(per_source[0])
            for vals in per_source[1:]:
                docs &= set(vals)
            sub_cols = [self._doc_metric_tuples(sub, seg, m)
                        for sub in msubs]
            import itertools

            for d in docs:
                combos = set(itertools.product(
                    *[vals[d] for vals in per_source]))
                for key in combos:
                    merged[key] = merged.get(key, 0) + 1
                for si, sub in enumerate(msubs):
                    tup = sub_cols[si].get(d)
                    if tup is None:
                        continue
                    for key in combos:
                        prev = sub_parts.get((sub.name, key),
                                             (0.0, 0, np.inf, -np.inf))
                        sub_parts[(sub.name, key)] = (
                            prev[0] + tup[0], prev[1] + tup[1],
                            min(prev[2], tup[2]), max(prev[3], tup[3]))
        cmp_key = _composite_sort_key(sources)
        items = sorted(merged.items(), key=lambda kv: cmp_key(kv[0]))
        if after_key is not None:
            ak = cmp_key(after_key)
            items = [kv for kv in items if cmp_key(kv[0]) > ak]
        items = items[:size]
        buckets = []
        for key, count in items:
            subs = {sub.name: _ser_tuple(sub_parts.get(
                (sub.name, key), (0.0, 0, np.inf, -np.inf)))
                for sub in msubs}
            buckets.append([list(key), int(count), subs])
        return {"t": "composite", "buckets": buckets}

    # -- histograms -------------------------------------------------------

    def _part_histogram(self, req, seg_views) -> dict:
        field, ft = self._field_type(req, "histogram")
        interval = float(req.params["interval"])
        if interval <= 0:
            raise IllegalArgumentError("[interval] must be > 0")
        offset = float(req.params.get("offset", 0))
        s, c, mn, mx = self._collect_metric_partials(field, seg_views)
        if not c:
            return {"t": "hist", "mn": None, "mx": None, "buckets": []}
        first = np.floor((mn - offset) / interval) * interval + offset
        n = int((mx - first) // interval) + 2
        if n > MAX_BUCKETS:
            raise IllegalArgumentError(
                f"trying to create too many buckets ({n} > {MAX_BUCKETS})")
        edges = first + interval * np.arange(n, dtype=np.float64)
        buckets = self._histogram_buckets(req, field, seg_views, edges,
                                          keys=edges[:-1])
        return {"t": "hist", "mn": float(mn), "mx": float(mx),
                "buckets": buckets}

    def _part_date_histogram(self, req, seg_views) -> dict:
        field, ft = self._field_type(req, "date_histogram")
        calendar = req.params.get("calendar_interval")
        fixed = req.params.get("fixed_interval") or req.params.get("interval")
        if calendar is None and fixed is None:
            raise ParsingError(
                "date_histogram requires calendar_interval or fixed_interval")
        offset = _dh_offset(req)
        s, c, mn, mx = self._collect_metric_partials(field, seg_views)
        if not c:
            return {"t": "hist", "mn": None, "mx": None, "buckets": []}
        edges = build_date_edges(int(mn), int(mx), calendar=calendar,
                                 fixed=None if calendar else fixed,
                                 offset=int(offset))
        buckets = self._histogram_buckets(req, field, seg_views,
                                          edges.astype(np.float64),
                                          keys=edges[:-1])
        return {"t": "hist", "mn": int(mn), "mx": int(mx),
                "buckets": buckets}

    def _histogram_buckets(self, req, field, seg_views, edges, keys) -> list:
        """Shared histogram inner loop: per-bucket counts + metric
        sub-partials over aligned edges; emits only non-empty buckets
        (the reduce regenerates the full grid for gap filling)."""
        if _top_hits_subs(req):
            raise IllegalArgumentError(
                f"[{req.type}] does not support [top_hits] "
                "sub-aggregations (nest top_hits under terms or a filter)")
        n_buckets = len(keys)
        totals = np.zeros(n_buckets, np.int64)
        msubs = _metric_subs(req)
        sub_parts = {sub.name: [np.zeros(n_buckets),
                                np.zeros(n_buckets, np.int64),
                                np.full(n_buckets, np.inf),
                                np.full(n_buckets, -np.inf)]
                     for sub in msubs}
        views = [(col, dseg, matched) for _seg, dseg, matched in seg_views
                 for col in (self._dev_numeric(dseg, field),)
                 if col is not None]
        sub_fields = [self._field_type(sub, sub.type)[0]
                      for sub in msubs] if views else []
        # one collector call for every segment: K5's edges mode on the
        # card, the metric subs in the same launch
        segs = [agg_ops.CollectSegment(
            matched, col["values"], col["value_docs"], n_buckets,
            [self._dev_numeric(dseg, sf) for sf in sub_fields])
            for col, dseg, matched in views]
        edges_t = torch.as_tensor(np.asarray(edges, np.float64),
                                  device=self.ctx.device)
        for seg_in, (counts, sub_out) in zip(
                segs, self._collect(segs, "edges", len(msubs),
                                    edges=edges_t)):
            totals += counts[:n_buckets]
            for sub, scol, (s, c, mn, mx) in zip(msubs, seg_in.subs,
                                                 sub_out):
                if scol is None:
                    continue
                acc = sub_parts[sub.name]
                acc[0] += s[:n_buckets]
                acc[1] += c[:n_buckets]
                acc[2] = np.minimum(acc[2], mn[:n_buckets])
                acc[3] = np.maximum(acc[3], mx[:n_buckets])
        out = []
        for i in np.nonzero(totals)[0]:
            subs = {sub.name: _ser_tuple((float(sub_parts[sub.name][0][i]),
                                          int(sub_parts[sub.name][1][i]),
                                          float(sub_parts[sub.name][2][i]),
                                          float(sub_parts[sub.name][3][i])))
                    for sub in msubs}
            out.append([float(keys[i]), int(totals[i]), subs])
        return out

    # -- mask-composition buckets ----------------------------------------

    def _narrow(self, seg_views, mask_fn):
        """New seg_views with matched &= mask_fn(seg, dseg)."""
        out = []
        for seg, dseg, matched in seg_views:
            out.append((seg, dseg, matched & mask_fn(seg, dseg)))
        return out

    def _filter_mask_fn(self, query_json):
        from opensearch_tpu_torch.search.compiler import compile_query
        from opensearch_tpu_torch.search.query_dsl import parse_query

        plan, bind = compile_query(parse_query(query_json), self.ctx,
                                   scored=False)
        return lambda seg, dseg: self._run_mask(plan, bind, seg, dseg)

    def _run_mask(self, plan, bind, seg, dseg):
        """The matched mask of an unscored plan over one segment (the
        query phase's per-segment program)."""
        from opensearch_tpu_torch.search import plan as P
        from opensearch_tpu_torch.search.executor import build_arrays

        dims, ins = plan.prepare(bind, seg, dseg, self.ctx)
        A = build_arrays(dseg, plan.arrays(), self.ctx.mapper,
                         live=self.ctx.live_mask(seg, dseg),
                         partial_ok=plan.skip_arrays(dims))
        _scores, matched = P.run_full(plan, dims, A, ins, -np.inf)
        return matched

    def _single_bucket(self, req, narrowed) -> dict:
        return {"t": "single",
                "doc_count": sum(int(m.sum()) for _s, _d, m in narrowed),
                "subs": {sub.name: self._part_one(sub, narrowed)
                         for sub in req.subs
                         if sub.type not in _PIPELINE_TYPES}}

    def _part_filter(self, req, seg_views) -> dict:
        return self._single_bucket(
            req, self._narrow(seg_views, self._filter_mask_fn(req.params)))

    def _part_filters(self, req, seg_views) -> dict:
        filters = req.params.get("filters")
        if not isinstance(filters, dict):
            raise ParsingError("[filters] aggregation requires keyed filters")
        buckets = {}
        for key, query_json in filters.items():
            narrowed = self._narrow(seg_views, self._filter_mask_fn(query_json))
            buckets[key] = self._single_bucket(req, narrowed)
        return {"t": "filters", "buckets": buckets}

    def _part_global(self, req, seg_views) -> dict:
        widened = [(seg, dseg, self.ctx.live_mask(seg, dseg))
                   for seg, dseg, _m in seg_views]
        return self._single_bucket(req, widened)

    def _part_missing(self, req, seg_views) -> dict:
        field, ft = self._field_type(req, "missing")
        from opensearch_tpu_torch.search.query_dsl import ExistsQuery
        from opensearch_tpu_torch.search.compiler import compile_query

        plan, bind = compile_query(ExistsQuery(field=field), self.ctx,
                                   scored=False)

        def mask_fn(seg, dseg):
            exists = self._run_mask(plan, bind, seg, dseg)
            return ~exists & self.ctx.live_mask(seg, dseg)
        return self._single_bucket(req, self._narrow(seg_views, mask_fn))

    def _part_range(self, req, seg_views, is_date=False,
                    kind="numeric") -> dict:
        field, ft = self._field_type(req, "range")
        ranges = req.params.get("ranges")
        if not ranges:
            raise ParsingError("[range] aggregation requires [ranges]")

        def parse_bound(v):
            if v is None:
                return None
            if is_date:
                # the FIELD's parser honors format: epoch_second etc.
                return (ft.range_bound(v) if ft is not None
                        else parse_date_millis(v))
            if kind == "ip":
                from opensearch_tpu_torch.mapping.types import parse_ip_long
                return parse_ip_long(v)
            return float(v)

        # buckets sort by (from asc, to asc) regardless of request
        # order (RangeAggregator's range sorting)
        def _order_key(r):
            f = parse_bound(r.get("from"))
            t = parse_bound(r.get("to"))
            return (-np.inf if f is None else f,
                    np.inf if t is None else t)
        ranges = sorted(ranges, key=_order_key)
        buckets = []
        for r in ranges:
            frm = r.get("from")
            to = r.get("to")
            frm_v = parse_bound(frm)
            to_v = parse_bound(to)
            inc_hi = bool(r.get("_to_inclusive", False))

            missing = req.params.get("missing")
            missing_v = parse_bound(missing) if missing is not None \
                else None
            lo_b = -np.inf if frm_v is None else frm_v
            hi_b = np.inf if to_v is None else to_v
            missing_in = (missing_v is not None and lo_b <= missing_v
                          and (missing_v <= hi_b if inc_hi
                               else missing_v < hi_b))

            def mask_fn(seg, dseg, frm_v=frm_v, to_v=to_v,
                        inc_hi=inc_hi, missing_in=missing_in):
                col = self._dev_numeric(dseg, field)
                if col is None:
                    # every doc lacks the field
                    return torch.full((dseg.n_pad,), bool(missing_in),
                                      dtype=torch.bool, device=dseg.device)
                from opensearch_tpu_torch.ops.filters import range_mask
                lo = -np.inf if frm_v is None else frm_v
                hi = np.inf if to_v is None else to_v
                vals = col["values"].to(torch.float64)
                hit = range_mask(vals, col["value_docs"], lo, hi,
                                 include_lo=True, include_hi=inc_hi,
                                 n_pad=dseg.n_pad)
                if missing_in:
                    # docs without a value take the [missing] value
                    hit = hit | ~col["exists"]
                return hit
            narrowed = self._narrow(seg_views, mask_fn)
            key = r.get("key")
            if key is None:
                def _bound(raw, parsed):
                    if raw is None:
                        return "*"
                    if is_date:
                        # numeric literals echo verbatim; date STRINGS
                        # render at millis precision
                        if isinstance(raw, str) and not str(
                                raw).lstrip("-").isdigit():
                            return format_date_millis(int(parsed))
                        return str(raw)
                    if kind == "ip":
                        return str(raw)
                    return str(float(parsed))
                key = _bound(frm, frm_v) + "-" + _bound(to, to_v)
            b = self._single_bucket(req, narrowed)
            b["key"] = key
            if frm is not None:
                b["from"] = frm if kind == "ip" else frm_v
            if to is not None:
                b["to"] = to if kind == "ip" else to_v
            buckets.append(b)
        return {"t": "ranges", "buckets": buckets}

    def _part_date_range(self, req, seg_views) -> dict:
        return self._part_range(req, seg_views, is_date=True)

    def _part_ip_range(self, req, seg_views) -> dict:
        """ip_range: from/to ip literals or CIDR masks over the monotone
        int64 ip column (bucket/range/IpRangeAggregationBuilder; a mask
        becomes an INCLUSIVE [network, broadcast] range)."""
        import ipaddress

        ranges = []
        for r in req.params.get("ranges") or []:
            if "mask" in r:
                net = ipaddress.ip_network(str(r["mask"]), strict=False)
                ranges.append({"key": r.get("key", str(r["mask"])),
                               "from": str(net.network_address),
                               "to": str(ipaddress.ip_address(
                                   int(net.broadcast_address) + 1))})
            else:
                ranges.append(dict(r))
        req2 = AggRequest(req.name, "ip_range",
                          {**req.params, "ranges": ranges}, req.subs)
        return self._part_range(req2, seg_views, kind="ip")


# ---------------------------------------------------------------------------
# Coordinator-side reduce (InternalAggregations.reduce analog) — pure
# function of the request + serialized partials; needs no segments, so it
# runs identically on a coordinating-only node.
# ---------------------------------------------------------------------------


def reduce_aggs(aggs_json: dict, partials: list[dict]) -> dict:
    reqs = parse_aggs(aggs_json)
    out = {r.name: _red_one(r, [p.get(r.name) for p in partials
                                if p is not None
                                and p.get(r.name) is not None])
           for r in reqs if r.type not in _PIPELINE_TYPES}
    # pipeline aggs run over the fully-reduced tree (the reference's
    # post-reduce PipelineAggregator pass)
    return _apply_pipelines(reqs, out)


def _red_one(req, parts: list):
    if req.type in ("min", "max", "sum", "avg", "value_count", "stats"):
        return _finish_metric(req.type,
                              _merge_tuples([p["v"] for p in parts]))
    fn = _REDUCERS.get(req.type)
    if fn is None:
        raise ParsingError(f"unknown aggregation type [{req.type}]")
    return fn(req, parts)


def _red_cardinality(req, parts):
    exact: set = set()
    hll = None
    threshold = min((p.get("thr", CARD_EXACT_MAX) for p in parts),
                    default=CARD_EXACT_MAX)
    for p in parts:
        if p["kind"] == "set":
            exact.update(_freeze(v) for v in p["v"])
        else:
            regs = np.asarray(p["regs"], np.uint8)
            hll = regs if hll is None else np.maximum(hll, regs)
    if hll is None and len(exact) <= threshold:
        return {"value": len(exact)}
    if exact:
        regs = _hll_from_values(exact)
        hll = regs if hll is None else np.maximum(hll, regs)
    return {"value": _hll_estimate(hll)}


def _freeze(v):
    return tuple(v) if isinstance(v, list) else v


def _red_percentiles(req, parts):
    percents = req.params.get("percents",
                              [1.0, 5.0, 25.0, 50.0, 75.0, 95.0, 99.0])
    vs, ws = [], []
    all_raw = True
    for p in parts:
        if p["kind"] == "raw":
            if p["v"]:
                vs.append(np.asarray(p["v"], np.float64))
                ws.append(np.ones(len(p["v"])))
        else:
            all_raw = False
            vs.append(np.asarray(p["m"], np.float64))
            ws.append(np.asarray(p["w"], np.float64))
    if not vs:
        return {"values": {f"{p}": None for p in percents}}
    v, w = np.concatenate(vs), np.concatenate(ws)
    if all_raw:
        return {"values": {f"{float(p)}": float(np.percentile(v, p))
                           for p in percents}}
    return {"values": {f"{float(p)}": _weighted_percentile(v, w, p)
                       for p in percents}}


def _red_extended_stats(req, parts):
    s, c, mn, mx = _merge_tuples([p["v"][:4] for p in parts])
    sq = sum(float(p["v"][4]) for p in parts)
    sigma = float(req.params.get("sigma", 2.0))
    if not c:
        return {"count": 0, "min": None, "max": None, "avg": None,
                "sum": 0.0, "sum_of_squares": None, "variance": None,
                "std_deviation": None,
                "std_deviation_bounds": {"upper": None, "lower": None}}
    avg = s / c
    var = sq / c - avg * avg
    std = float(np.sqrt(max(var, 0.0)))
    var_samp = (sq - c * avg * avg) / (c - 1) if c > 1 else None
    return {"count": int(c), "min": mn, "max": mx, "avg": avg, "sum": s,
            "sum_of_squares": sq, "variance": var,
            "variance_population": var, "variance_sampling": var_samp,
            "std_deviation": std, "std_deviation_population": std,
            "std_deviation_sampling": (float(np.sqrt(max(var_samp, 0.0)))
                                       if var_samp is not None else None),
            "std_deviation_bounds": {"upper": avg + sigma * std,
                                     "lower": avg - sigma * std}}


def _red_weighted_avg(req, parts):
    vw = sum(p["v"][0] for p in parts)
    w = sum(p["v"][1] for p in parts)
    return {"value": (vw / w) if w else None}


def _pct_values_weights(parts):
    vs, ws = [], []
    for p in parts:
        if p["kind"] == "raw":
            if p["v"]:
                vs.append(np.asarray(p["v"], np.float64))
                ws.append(np.ones(len(p["v"])))
        else:
            vs.append(np.asarray(p["m"], np.float64))
            ws.append(np.asarray(p["w"], np.float64))
    if not vs:
        return None, None
    return np.concatenate(vs), np.concatenate(ws)


def _red_percentile_ranks(req, parts):
    values = req.params.get("values") or []
    v, w = _pct_values_weights(parts)
    out = {}
    for x in values:
        if v is None:
            out[f"{float(x)}"] = None
        else:
            out[f"{float(x)}"] = float(
                100.0 * w[v <= float(x)].sum() / w.sum())
    return {"values": out}


def _red_mad(req, parts):
    v, w = _pct_values_weights(parts)
    if v is None:
        return {"value": None}
    med = _weighted_percentile(v, w, 50.0)
    return {"value": _weighted_percentile(np.abs(v - med), w, 50.0)}


def _red_top_hits(req, parts):
    size = int(req.params.get("size", 3))
    from_ = int(req.params.get("from", 0))
    sort_field, sort_desc = _top_hits_sort(req.params.get("sort"))
    hits = [h for p in parts for h in p["hits"]]
    if sort_field is None:
        hits.sort(key=lambda h: (h.get("_score") if h.get("_score")
                                 is not None else -np.inf), reverse=True)
    else:
        last = -np.inf if sort_desc else np.inf
        hits.sort(key=lambda h: (h["sort"][0] if h.get("sort")
                                 and h["sort"][0] is not None else last),
                  reverse=sort_desc)
    total = sum(p["total"] for p in parts)
    page = hits[from_: from_ + size]
    max_score = None
    scores = [h["_score"] for h in hits if h.get("_score") is not None]
    if scores:
        max_score = max(scores)
    return {"hits": {"total": {"value": int(total), "relation": "eq"},
                     "max_score": max_score, "hits": page}}


def _is_count_desc(order) -> bool:
    if isinstance(order, list):
        order = order[0] if order else {"_count": "desc"}
    ((what, direction),) = order.items()
    return what == "_count" and str(direction).lower() == "desc"


def _terms_order_key(order):
    if isinstance(order, list):
        order = order[0] if order else {"_count": "desc"}
    ((what, direction),) = order.items()
    desc = str(direction).lower() == "desc"
    if what == "_count":
        return lambda kv: ((-kv[1] if desc else kv[1]), kv[0])
    if what in ("_key", "_term"):
        # python can't negate strings: rely on sort stability via reverse
        import functools

        def cmp(a, b):
            if a[0] == b[0]:
                return 0
            lt = a[0] < b[0]
            if desc:
                lt = not lt
            return -1 if lt else 1
        return functools.cmp_to_key(cmp)
    raise IllegalArgumentError(f"terms order [{what}] is not supported")


def _term_key(key, tn, dk):
    if tn == "boolean":
        return int(key)
    if dk == "long":
        return int(key)
    if dk == "double":
        return float(key)
    return key


def _term_key_as_string(key, tn):
    if tn == "boolean":
        return "true" if key else "false"
    if tn == "date":
        return format_date_millis(int(key))
    return None


def _red_terms(req, parts):
    size = int(req.params.get("size", 10))
    min_doc_count = int(req.params.get("min_doc_count", 1))
    order = req.params.get("order", {"_count": "desc"})
    tn = dk = None
    merged: dict = {}
    sub_parts: dict = {}
    keys_of: list[set] = []
    for p in parts:
        if p.get("tn") is not None:
            tn, dk = p["tn"], p["dk"]
        seen = set()
        for key, count, subs in p["buckets"]:
            if isinstance(key, float) and dk == "long":
                key = int(key)      # JSON round-trip may floatify longs
            seen.add(key)
            merged[key] = merged.get(key, 0) + count
            for sname, tup in subs.items():
                if isinstance(tup, dict):      # top_hits partial
                    sub_parts.setdefault((sname, key), []).append(tup)
                    continue
                prev = sub_parts.get((sname, key))
                sub_parts[(sname, key)] = (
                    _ser_tuple(_merge_tuples([prev, tup]))
                    if prev is not None else tup)
        keys_of.append(seen)
    if tn is None:
        return {"doc_count_error_upper_bound": 0, "sum_other_doc_count": 0,
                "buckets": []}
    inc, exc = req.params.get("include"), req.params.get("exclude")
    if inc is not None or exc is not None:
        sel = _terms_include_filter(inc, exc, tn)
        merged = {k: c for k, c in merged.items() if sel(k)}
    items = [(k, c) for k, c in merged.items() if c >= min_doc_count]
    items.sort(key=_terms_order_key(order))
    total_in_buckets = sum(c for _k, c in items)
    items = items[:size]
    error = 0
    buckets = []
    for key, count in items:
        # a shard that truncated its list and omitted this key may hold up
        # to its min_inc more docs for it (the reference's per-bucket
        # doc_count_error derivation)
        err = sum(p["min_inc"] for p, seen in zip(parts, keys_of)
                  if key not in seen)
        error = max(error, err)
        b = {"key": _term_key(key, tn, dk), "doc_count": int(count)}
        kas = _term_key_as_string(key, tn)
        if kas is not None:
            b["key_as_string"] = kas
        for sub in _metric_subs(req):
            tup = sub_parts.get((sub.name, key))
            b[sub.name] = _finish_metric(
                sub.type, _merge_tuples([tup]) if tup is not None
                else (0.0, 0, np.inf, -np.inf))
        for sub in _top_hits_subs(req):
            b[sub.name] = _red_top_hits(
                sub, sub_parts.get((sub.name, key), []))
        buckets.append(b)
    sum_other = (total_in_buckets - sum(b["doc_count"] for b in buckets)
                 + sum(p["others"] for p in parts))
    return {"doc_count_error_upper_bound": int(error),
            "sum_other_doc_count": int(sum_other),
            "buckets": buckets}


def _mix64(v: int) -> int:
    """BitMixer.mix64 (Stafford variant 9, libs/common BitMixer.java:120)
    — signed, for floorMod parity with the reference's partitioning."""
    m = (1 << 64) - 1
    z = v & m
    z = ((z ^ (z >> 32)) * 0x4CD6944C5CC20B6D) & m
    z = ((z ^ (z >> 29)) * 0xFC12C5B19D3259E9) & m
    z ^= z >> 32
    return z - (1 << 64) if z >= (1 << 63) else z


def _terms_include_filter(inc, exc, tn):
    """terms include/exclude: exact-value arrays, a regex string, or the
    partition form {partition, num_partitions} — hash-compatible with
    the reference (IncludeExclude.java:239 murmur3_x86_32 seed 31 +
    floorMod for strings; Long.hashCode for numerics)."""
    if isinstance(inc, dict):
        part = int(inc.get("partition", -1))
        num = int(inc.get("num_partitions", 0))
        if part < 0 or num <= 0 or part >= num:
            raise IllegalArgumentError(
                "Missing or invalid [partition]/[num_partitions] for "
                "partition-based include")
        if exc is not None:
            raise IllegalArgumentError(
                "Cannot specify any excludes when using a "
                "partition-based include")
        from opensearch_tpu_torch.indices.service import murmur3_32

        def sel(key):
            if isinstance(key, str):
                h = murmur3_32(key.encode("utf-8"), 31)
                if h >= 2**31:
                    h -= 2**32
            else:
                h = _mix64(int(key))       # BitMixer.mix64 (long keys)
            return h % num == part
        return sel
    def norm(vals):
        out = set()
        for v in vals:
            out.add(v)
            out.add(str(v))
            if tn == "date":
                try:
                    out.add(parse_date_millis(v))
                except (ValueError, IllegalArgumentError, TypeError):
                    pass
        return out

    def key_forms(key):
        forms = {key, str(key)}
        kas = _term_key_as_string(key, tn)
        if kas is not None:
            forms.add(kas)
        return forms

    def matches(spec, key):
        if spec is None:
            return None
        if isinstance(spec, str):            # regex form
            return any(re.fullmatch(spec, str(f)) for f in key_forms(key))
        vals = norm(spec if isinstance(spec, list) else [spec])
        return bool(key_forms(key) & vals)

    def sel(key):
        if inc is not None and not matches(inc, key):
            return False
        if exc is not None and matches(exc, key):
            return False
        return True
    return sel


def _dh_offset(req) -> int:
    offset = req.params.get("offset", 0)
    if isinstance(offset, str) and offset:
        offset = _parse_duration_ms(offset.lstrip("+-")) * (
            -1 if offset.startswith("-") else 1)
    return int(offset)


def _red_histogram(req, parts, is_date=False):
    min_doc_count = int(req.params.get("min_doc_count", 0))
    mns = [p["mn"] for p in parts if p["mn"] is not None]
    mxs = [p["mx"] for p in parts if p["mx"] is not None]
    if not mns:
        return {"buckets": []}
    mn, mx = min(mns), max(mxs)
    if is_date:
        calendar = req.params.get("calendar_interval")
        fixed = req.params.get("fixed_interval") or req.params.get("interval")
        if calendar is None and fixed is None:
            raise ParsingError(
                "date_histogram requires calendar_interval or fixed_interval")
        edges = build_date_edges(int(mn), int(mx), calendar=calendar,
                                 fixed=None if calendar else fixed,
                                 offset=_dh_offset(req))
        keys = edges[:-1].astype(np.int64)
        fmt = req.params.get("format") or ""
    else:
        interval = float(req.params["interval"])
        if interval <= 0:
            raise IllegalArgumentError("[interval] must be > 0")
        offset = float(req.params.get("offset", 0))
        first = np.floor((mn - offset) / interval) * interval + offset
        n = int((mx - first) // interval) + 2
        if n > MAX_BUCKETS:
            raise IllegalArgumentError(
                f"trying to create too many buckets ({n} > {MAX_BUCKETS})")
        keys = (first + interval * np.arange(n - 1, dtype=np.float64))
        fmt = None
    # merge shard buckets onto the global grid; float keys land exactly on
    # grid points (same rounding arithmetic shard-side), so match by
    # nearest-grid-index rather than float equality
    counts = np.zeros(len(keys), np.int64)
    subs_acc: dict = {}
    for p in parts:
        for key, count, subs in p["buckets"]:
            if is_date:
                i = int(np.searchsorted(keys, int(round(key))))
                if i >= len(keys) or keys[i] != int(round(key)):
                    i = max(0, i - 1)
            else:
                i = min(max(int(round((key - keys[0]) / interval)), 0),
                        len(keys) - 1)
            counts[i] += count
            for sname, tup in subs.items():
                prev = subs_acc.get((sname, i))
                subs_acc[(sname, i)] = (
                    _ser_tuple(_merge_tuples([prev, tup]))
                    if prev is not None else tup)
    buckets = []
    for i, key in enumerate(keys):
        if counts[i] < min_doc_count:
            continue
        b = {"key": int(key) if is_date else float(key),
             "doc_count": int(counts[i])}
        if is_date:
            b["key_as_string"] = _fmt_date(int(key), fmt or None)
        for sub in _metric_subs(req):
            tup = subs_acc.get((sub.name, i))
            b[sub.name] = _finish_metric(
                sub.type, _merge_tuples([tup]) if tup is not None
                else (0.0, 0, np.inf, -np.inf))
        buckets.append(b)
    return {"buckets": buckets}


def _composite_sources(req):
    """[(name, field, value_transform, order, kind)] for a composite
    request's sources."""
    import math as _math

    sources = req.params.get("sources")
    if not isinstance(sources, list) or not sources:
        raise ParsingError("Required [sources]")
    out = []
    for s in sources:
        if not isinstance(s, dict) or len(s) != 1:
            raise ParsingError("[composite] source must have one name")
        ((name, body),) = s.items()
        if not isinstance(body, dict) or len(body) != 1:
            raise ParsingError(
                f"[composite] source [{name}] must have one type")
        ((styp, cfg),) = body.items()
        field = cfg.get("field")
        if not field:
            raise ParsingError(f"[composite] source [{name}] requires "
                               "[field]")
        order = cfg.get("order", "asc")
        if styp == "terms":
            xform, kind = None, "terms"
        elif styp == "histogram":
            interval = float(cfg.get("interval", 0))
            if interval <= 0:
                raise ParsingError("[interval] must be > 0")
            xform = lambda v, i=interval: _math.floor(float(v) / i) * i  # noqa: E731
            kind = "histogram"
        elif styp == "date_histogram":
            calendar = cfg.get("calendar_interval")
            if calendar in ("month", "1M"):
                def xform(v):
                    dt = _dt.datetime.fromtimestamp(
                        int(v) / 1000, tz=_dt.timezone.utc)
                    return int(_floor_month(dt, 1).timestamp() * 1000)
            elif calendar in ("year", "1y"):
                def xform(v):
                    dt = _dt.datetime.fromtimestamp(
                        int(v) / 1000, tz=_dt.timezone.utc)
                    return int(_dt.datetime(
                        dt.year, 1, 1,
                        tzinfo=_dt.timezone.utc).timestamp() * 1000)
            else:
                fixed = cfg.get("fixed_interval") or cfg.get("interval")
                ms = _CAL_FIXED_MS.get(calendar)
                if ms is None:
                    if fixed is None:
                        raise ParsingError(
                            f"[composite] source [{name}] requires an "
                            "interval")
                    ms = _parse_duration_ms(fixed)
                off = cfg.get("offset", 0)
                if isinstance(off, str) and off:
                    off = (_parse_duration_ms(off.lstrip("+-"))
                           * (-1 if off.startswith("-") else 1))
                off = int(off)
                xform = (lambda v, m=ms, o=off:
                         ((int(v) - o) // m) * m + o)  # noqa: E731
            kind = "date"
        else:
            raise ParsingError(
                f"[composite] source type [{styp}] is not supported")
        out.append((name, field, xform, order, kind,
                    cfg.get("format")))
    return out


def _composite_sort_key(sources):
    """Comparable wrapper honoring each source's asc/desc order."""
    import functools

    orders = [s[3] for s in sources]

    def cmp(a, b):
        for av, bv, o in zip(a, b, orders):
            if av == bv:
                continue
            lt = av < bv
            if str(o).lower() == "desc":
                lt = not lt
            return -1 if lt else 1
        return 0

    return functools.cmp_to_key(cmp)


def _red_composite(req, parts):
    sources = _composite_sources(req)
    size = int(req.params.get("size", 10))
    merged: dict = {}
    sub_parts: dict = {}
    for p in parts:
        for key, count, subs in p["buckets"]:
            key = tuple(int(v) if s[4] == "date"
                        else (float(v) if s[4] == "histogram" else v)
                        for v, s in zip(key, sources))
            merged[key] = merged.get(key, 0) + count
            for sname, tup in subs.items():
                prev = sub_parts.get((sname, key))
                sub_parts[(sname, key)] = (
                    _ser_tuple(_merge_tuples([prev, tup]))
                    if prev is not None else tup)
    K = _composite_sort_key(sources)
    items = sorted(merged.items(), key=lambda kv: K(kv[0]))[:size]
    buckets = []
    for key, count in items:
        rendered = {}
        for v, s in zip(key, sources):
            name, kind, fmt = s[0], s[4], s[5]
            if kind == "date" and fmt:
                v = _fmt_date(int(v), fmt)
            rendered[name] = v
        b = {"key": rendered, "doc_count": int(count)}
        for sub in _metric_subs(req):
            tup = sub_parts.get((sub.name, key))
            b[sub.name] = _finish_metric(
                sub.type, _merge_tuples([tup]) if tup is not None
                else (0.0, 0, np.inf, -np.inf))
        buckets.append(b)
    out = {"buckets": buckets}
    if buckets:
        out["after_key"] = buckets[-1]["key"]
    return out


def _jlh(fg: int, fg_total: int, bg: int, bg_total: int) -> float:
    """JLH significance: (fg% - bg%) * (fg% / bg%) — the reference's
    default heuristic (bucket/terms/heuristic/JLHScore.java:103)."""
    if not fg_total or not bg_total or not bg:
        return 0.0
    fg_rate = fg / fg_total
    bg_rate = bg / bg_total
    if fg_rate <= bg_rate:
        return 0.0
    return (fg_rate - bg_rate) * (fg_rate / bg_rate)


def _red_significant_terms(req, parts):
    size = int(req.params.get("size", 10))
    min_doc_count = int(req.params.get("min_doc_count", 3))
    tn = dk = None
    fg_total = bg_total = 0
    fg: dict = {}
    bg: dict = {}
    for p in parts:
        if p.get("tn") is not None:
            tn, dk = p["tn"], p["dk"]
        fg_total += p["fg_total"]
        bg_total += p["bg_total"]
        for key, f, b in p["buckets"]:
            if isinstance(key, float) and dk == "long":
                key = int(key)
            fg[key] = fg.get(key, 0) + f
            bg[key] = bg.get(key, 0) + b
    scored = []
    for key, f in fg.items():
        if f < min_doc_count:
            continue
        score = _jlh(f, fg_total, bg[key], bg_total)
        if score > 0:
            scored.append((score, key, f, bg[key]))
    scored.sort(key=lambda r: (-r[0], r[1]))
    buckets = [{"key": _term_key(key, tn, dk), "doc_count": int(f),
                "score": score, "bg_count": int(b)}
               for score, key, f, b in scored[:size]]
    return {"doc_count": int(fg_total), "bg_count": int(bg_total),
            "buckets": buckets}


def _red_rare_terms(req, parts):
    max_dc = int(req.params.get("max_doc_count", 1))
    tn = dk = None
    counts: dict = {}
    over: set = set()
    for p in parts:
        if p.get("tn") is not None:
            tn, dk = p["tn"], p["dk"]
        over.update(_freeze(t) for t in p.get("over", []))
        for key, c in p["buckets"]:
            if isinstance(key, float) and dk == "long":
                key = int(key)
            counts[key] = counts.get(key, 0) + c
    items = [(k, c) for k, c in counts.items()
             if c <= max_dc and k not in over]
    items.sort(key=lambda kv: kv[0])
    return {"buckets": [{"key": _term_key(k, tn, dk), "doc_count": int(c)}
                        for k, c in items]}


def _red_multi_terms(req, parts):
    size = int(req.params.get("size", 10))
    min_doc_count = int(req.params.get("min_doc_count", 1))
    order = req.params.get("order", {"_count": "desc"})
    merged: dict = {}
    sub_parts: dict = {}
    keys_of: list[set] = []
    for p in parts:
        seen = set()
        for key, count, subs in p["buckets"]:
            key = tuple(key)
            seen.add(key)
            merged[key] = merged.get(key, 0) + count
            for sname, tup in subs.items():
                prev = sub_parts.get((sname, key))
                sub_parts[(sname, key)] = (
                    _ser_tuple(_merge_tuples([prev, tup]))
                    if prev is not None else tup)
        keys_of.append(seen)
    items = [(k, c) for k, c in merged.items() if c >= min_doc_count]
    items.sort(key=_terms_order_key(order))
    total_in_buckets = sum(c for _k, c in items)
    items = items[:size]
    buckets = []
    error = 0
    for key, count in items:
        err = sum(p["min_inc"] for p, seen in zip(parts, keys_of)
                  if key not in seen)
        error = max(error, err)
        b = {"key": list(key),
             "key_as_string": "|".join(str(k) for k in key),
             "doc_count": int(count)}
        for sub in _metric_subs(req):
            tup = sub_parts.get((sub.name, key))
            b[sub.name] = _finish_metric(
                sub.type, _merge_tuples([tup]) if tup is not None
                else (0.0, 0, np.inf, -np.inf))
        buckets.append(b)
    sum_other = (total_in_buckets - sum(b["doc_count"] for b in buckets)
                 + sum(p["others"] for p in parts))
    return {"doc_count_error_upper_bound": int(error),
            "sum_other_doc_count": int(sum_other),
            "buckets": buckets}


def _red_single(req, parts):
    out = {"doc_count": sum(p["doc_count"] for p in parts)}
    for sub in req.subs:
        if sub.type in _PIPELINE_TYPES:
            continue                    # applied in the post-reduce pass
        out[sub.name] = _red_one(sub, [p["subs"][sub.name] for p in parts
                                       if sub.name in p.get("subs", {})])
    return out


def _red_filters(req, parts):
    keys = []
    for p in parts:
        for k in p["buckets"]:
            if k not in keys:
                keys.append(k)
    buckets = {}
    for k in keys:
        kparts = [p["buckets"][k] for p in parts if k in p["buckets"]]
        buckets[k] = _red_single(req, kparts)
    return {"buckets": buckets}


def _red_ranges(req, parts):
    if not parts:
        return {"buckets": []}
    n = len(parts[0]["buckets"])
    buckets = []
    for i in range(n):
        slot = [p["buckets"][i] for p in parts]
        b = _red_single(req, slot)
        proto = slot[0]
        b["key"] = proto["key"]
        if "from" in proto:
            b["from"] = proto["from"]
        if "to" in proto:
            b["to"] = proto["to"]
        buckets.append(b)
    return {"buckets": buckets}


_REDUCERS = {
    "cardinality": _red_cardinality,
    "percentiles": _red_percentiles,
    "percentile_ranks": _red_percentile_ranks,
    "median_absolute_deviation": _red_mad,
    "extended_stats": _red_extended_stats,
    "weighted_avg": _red_weighted_avg,
    "top_hits": _red_top_hits,
    "terms": _red_terms,
    "significant_terms": _red_significant_terms,
    "rare_terms": _red_rare_terms,
    "multi_terms": _red_multi_terms,
    "composite": _red_composite,
    "histogram": lambda req, parts: _red_histogram(req, parts, is_date=False),
    "date_histogram": lambda req, parts: _red_histogram(req, parts,
                                                        is_date=True),
    "filter": _red_single,
    "filters": _red_filters,
    "global": _red_single,
    "missing": _red_single,
    "range": _red_ranges,
    "date_range": _red_ranges,
    "ip_range": _red_ranges,
}
