"""Aggregations of the PyTorch port (``search/aggs.py``,
``search/pipeline_aggs.py``, K5's plain version) against the JAX
package, on the CPU.

One case per test of ``tests/test_aggs.py`` (15), ``tests/test_aggs_tail.py``
(14) and ``tests/test_pipeline_aggs.py`` (18), on the same docs and the
same request, through both packages' searchers (the port's segments are
the reference's, carried by ``segment_arrays`` / ``segment_from_arrays``);
the 3-shard cases collect wire partials (a JSON round trip) per shard and
reduce them with each package's ``reduce_aggs``.  The whole
``aggregations`` object is compared:

- keys, doc counts, ``doc_count_error_upper_bound``,
  ``sum_other_doc_count``, counts, min and max exactly (``EXACT``);
- every other float (sums and what derives from them: avg, stats, the
  pipelines over them) exactly, or within rtol 1e-12 where it sums a
  double column.  The port adds each bucket's entries in a pairwise tree
  (``ops/aggs.py``: the order K5 can reproduce on the card without float
  atomics), the reference sequentially; on long and date columns every
  partial sum stays below 2^53 and the two are equal, on doubles they
  differ by a few ulps.

Five of the cases run again over segments with deleted docs.  Also: the
``fare`` double column of ``testing/corpus.py`` equals what the
writer builds; a ``match`` body with ``aggs`` and ``size`` 10 never takes
the batched (K3) route, in ``msearch`` or in the continuous batcher.
"""

import json
import math

import numpy as np
import pytest

from opensearch_tpu.index.segment import SegmentWriter as JaxWriter
from opensearch_tpu.mapping.mapper import DocumentMapper as JaxMapper
from opensearch_tpu.ops import bm25 as jbm25
from opensearch_tpu.search import aggs as jaggs
from opensearch_tpu.search.executor import ShardSearcher as JaxSearcher
from opensearch_tpu_torch.index.segment import (SegmentWriter,
                                                segment_arrays,
                                                segment_from_arrays)
from opensearch_tpu_torch.mapping.mapper import DocumentMapper
from opensearch_tpu_torch.search import aggs as taggs
from opensearch_tpu_torch.search.executor import ShardSearcher
from opensearch_tpu_torch.testing import corpus

RTOL = 1e-12
EXACT = frozenset({"key", "doc_count", "doc_count_error_upper_bound",
                   "sum_other_doc_count", "count", "min", "max",
                   "bg_count", "key_as_string", "keys"})


@pytest.fixture(autouse=True)
def _device_scoring(monkeypatch):
    # the reference scores on its device path, as the port's tests hold it
    monkeypatch.setattr(jbm25, "HOST_SCORING", False)


def assert_aggs_equal(got, ref, path="", exact=frozenset()):
    """``got`` (the port) equals ``ref`` (the reference) under the rules
    of the module doc; ``exact`` names aggs whose every float must be
    equal (min / max metrics)."""
    assert type(got) is type(ref) or {type(got), type(ref)} <= {int, float}, \
        (path, got, ref)
    if isinstance(ref, dict):
        assert list(got) == list(ref), (path, list(got), list(ref))
        for k in ref:
            assert_aggs_equal(got[k], ref[k], f"{path}.{k}",
                              exact | ({k} if k in EXACT else set()))
    elif isinstance(ref, list):
        assert len(got) == len(ref), (path, got, ref)
        for i, (g, r) in enumerate(zip(got, ref)):
            assert_aggs_equal(g, r, f"{path}[{i}]", exact)
    elif isinstance(ref, float) and not (exact & set(path.split(".")[-1:])
                                         or any(n in exact for n in
                                                path.split("."))):
        if got != ref and not (math.isnan(got) and math.isnan(ref)):
            assert abs(got - ref) <= RTOL * abs(ref), (path, got, ref)
    else:
        assert got == ref, (path, got, ref)


def pair_of(jsegs, mapping):
    """The reference's searcher over ``jsegs`` and the port's over the
    same segments, on the CPU."""
    tsegs = [segment_from_arrays(*segment_arrays(s)) for s in jsegs]
    return (JaxSearcher(jsegs, JaxMapper(mapping)),
            ShardSearcher(tsegs, DocumentMapper(mapping), device="cpu"))


def both_search(pair, body, exact=frozenset()):
    ref, got = pair[0].search(body), pair[1].search(body)
    assert [h["_id"] for h in got["hits"]["hits"]] == \
        [h["_id"] for h in ref["hits"]["hits"]]
    assert got["hits"]["total"] == ref["hits"]["total"]
    assert_aggs_equal(got["aggregations"], ref["aggregations"],
                      exact=frozenset(exact))
    return got


# -- tests/test_aggs.py ------------------------------------------------------

AGG_MAPPING = {"properties": {
    "color": {"type": "keyword"}, "n": {"type": "long"},
    "price": {"type": "double"}, "day": {"type": "date"},
    "flag": {"type": "boolean"}, "body": {"type": "text"}}}
COLORS = ["red", "green", "blue", "cyan"]


@pytest.fixture(scope="module")
def agg_pair():
    """``tests/test_aggs.py``'s corpus: 150 docs in 3 segments, seed 5."""
    rng = np.random.default_rng(5)
    mapper, writer = JaxMapper(AGG_MAPPING), JaxWriter()
    segs, doc_no = [], 0
    for si in range(3):
        parsed = []
        for _ in range(50):
            src = {"color": list(rng.choice(COLORS, size=rng.integers(1, 3),
                                            replace=False)),
                   "n": int(rng.integers(0, 50)),
                   "price": float(np.round(rng.uniform(1, 100), 2)),
                   "day": f"2023-{rng.integers(1, 7):02d}-"
                          f"{rng.integers(1, 28):02d}",
                   "flag": bool(rng.integers(0, 2)),
                   "body": "match me" if rng.uniform() < 0.5
                   else "skip this"}
            if rng.uniform() < 0.15:
                del src["price"]
            parsed.append(mapper.parse(str(doc_no), src))
            doc_no += 1
        segs.append(writer.build(parsed, f"s{si}"))
    return pair_of(segs, AGG_MAPPING)


AGG_CASES = {
    "terms_keyword": ({"by_color": {"terms": {"field": "color"}}}, None, 0),
    "terms_keyword_key_order_and_size": ({"a": {"terms": {
        "field": "color", "size": 2, "order": {"_key": "asc"}}}}, None, 0),
    "terms_long_and_boolean": ({
        "by_n": {"terms": {"field": "n", "size": 5}},
        "by_flag": {"terms": {"field": "flag"}}}, None, 0),
    "metrics": ({
        "mx": {"max": {"field": "price"}}, "mn": {"min": {"field": "price"}},
        "sm": {"sum": {"field": "price"}}, "av": {"avg": {"field": "price"}},
        "vc": {"value_count": {"field": "price"}},
        "st": {"stats": {"field": "n"}},
        "card": {"cardinality": {"field": "color"}},
        "pct": {"percentiles": {"field": "n", "percents": [50]}}},
        None, 0),
    "terms_with_sub_metrics": ({"by_color": {
        "terms": {"field": "color", "size": 10},
        "aggs": {"avg_n": {"avg": {"field": "n"}},
                 "sum_price": {"sum": {"field": "price"}}}}}, None, 0),
    "date_histogram_month": ({"per_month": {
        "date_histogram": {"field": "day", "calendar_interval": "month"},
        "aggs": {"stats_n": {"stats": {"field": "n"}}}}}, None, 0),
    "date_histogram_fixed_interval": ({"weekly": {"date_histogram": {
        "field": "day", "fixed_interval": "7d"}}}, None, 0),
    "histogram_numeric": ({"h": {"histogram": {"field": "n",
                                               "interval": 10}}}, None, 0),
    "filter_and_filters": ({
        "cheap": {"filter": {"range": {"n": {"lt": 25}}},
                  "aggs": {"colors": {"terms": {"field": "color"}}}},
        "split": {"filters": {"filters": {
            "low": {"range": {"n": {"lt": 25}}},
            "high": {"range": {"n": {"gte": 25}}}}}}}, None, 0),
    "range_agg": ({"r": {
        "range": {"field": "n", "ranges": [
            {"to": 20}, {"from": 20, "to": 40, "key": "mid"}, {"from": 40}]},
        "aggs": {"avg_price": {"avg": {"field": "price"}}}}}, None, 0),
    "global_and_missing": ({
        "all": {"global": {}, "aggs": {"c": {"value_count": {"field": "n"}}}},
        "no_price": {"missing": {"field": "price"}}},
        {"match": {"body": "match"}}, 0),
    "aggs_respect_query": ({"s": {"sum": {"field": "n"}}},
                           {"match": {"body": "match"}}, 0),
    "aggs_with_hits": ({"mx": {"max": {"field": "n"}}},
                       {"match_all": {}}, 5),
}


@pytest.mark.parametrize("case", list(AGG_CASES))
def test_aggs_cases_equal_the_reference(agg_pair, case):
    aggs, query, size = AGG_CASES[case]
    body = {"aggs": aggs, "size": size}
    if query:
        body["query"] = query
    both_search(agg_pair, body, exact={"mx", "mn"})


METRIC_AGGS = {f"{m}_{f}": {m: {"field": f}} for f in ("n", "price")
               for m in ("min", "max", "avg", "sum", "value_count",
                         "stats")}


@pytest.mark.parametrize("extra", [
    {},
    {"colors": {"value_count": {"field": "color"}},
     "min_n_again": {"min": {"field": "n"}},
     "per_n": {"terms": {"field": "color"},
               "aggs": {"s": {"sum": {"field": "n"}}}},
     "gone": {"max": {"field": "no_such_field"}}}],
    ids=["12_metrics", "with_keyword_count_repeat_and_terms"])
def test_metric_aggs_share_one_collector_call(agg_pair, monkeypatch, extra):
    """A request's top-level metric aggs (6 metrics x 2 fields, phase 11's
    shape) make ONE collector call over every segment, each distinct
    column once, a keyword's ``value_count`` in it; the response equals
    the reference's.  A bucket agg beside them makes its own call."""
    from opensearch_tpu_torch.ops import aggs as agg_ops

    calls = []
    real = agg_ops.bucket_collect

    def counting(segments, **kw):
        calls.append((len(segments), kw))
        return real(segments, **kw)

    monkeypatch.setattr(agg_ops, "bucket_collect", counting)
    body = {"size": 0, "query": {"match_all": {}},
            "aggs": {**METRIC_AGGS, **extra}}
    both_search(agg_pair, body, exact={k for k in body["aggs"]
                                       if k.startswith(("min", "max"))})
    n_seg = len(agg_pair[1].segments)
    n_cols = 3 if extra else 2
    n_jobs, kw = calls[0]
    assert (n_jobs, kw["mode"], kw["self_metric"]) == (
        n_cols * n_seg, "single",
        [True] * (2 * n_seg) + [False] * n_seg * (n_cols - 2))
    assert len(calls) == (2 if extra else 1)


@pytest.mark.parametrize("case", ["terms_with_sub_metrics",
                                  "date_histogram_month", "metrics",
                                  "global_and_missing",
                                  "filter_and_filters"])
def test_aggs_over_deleted_docs_equal_the_reference(case):
    """Deleted docs are in no bucket and no metric (the live mask is in
    every matched mask, ``global`` and ``missing`` included)."""
    rng = np.random.default_rng(17)
    mapper, writer = JaxMapper(AGG_MAPPING), JaxWriter()
    segs = []
    for si in range(2):
        docs = [{"color": [COLORS[(i + si) % 4]], "n": i % 50,
                 "price": float(np.round(rng.uniform(1, 100), 2)),
                 "day": f"2023-{1 + i % 6:02d}-{1 + i % 27:02d}",
                 "flag": bool(i % 2), "body": "match me"}
                for i in range(60)]
        seg = writer.build([mapper.parse(f"{si}-{i}", d)
                            for i, d in enumerate(docs)], f"d{si}")
        seg.apply_deletes(rng.choice(60, size=15, replace=False))
        segs.append(seg)
    aggs, query, size = AGG_CASES[case]
    body = {"aggs": aggs, "size": size}
    if query:
        body["query"] = query
    got = both_search(pair_of(segs, AGG_MAPPING), body, exact={"mx", "mn"})
    assert got["hits"]["total"]["value"] <= 90


def test_percentiles_device_centroids_equal_the_reference(monkeypatch):
    """Past PCT_RAW_MAX both packages bin the matched values into
    equal-weight centroids on the device (``masked_centroids``); the
    centroid means differ within rtol 1e-12 (pairwise bins against the
    reference's sequential ones), so the interpolated percentiles do
    too."""
    rng = np.random.default_rng(5)
    vals = (rng.normal(size=8000) * 50 + 100).astype(np.float64)
    mapping = {"properties": {"v": {"type": "double"}}}
    mapper, writer = JaxMapper(mapping), JaxWriter()
    segs = [writer.build([mapper.parse(f"{si}-{i}",
                                       {"v": float(vals[si * 4000 + i])})
                          for i in range(4000)], f"pc{si}")
            for si in range(2)]
    pair = pair_of(segs, mapping)
    monkeypatch.setattr(jaggs, "PCT_RAW_MAX", 1000)
    monkeypatch.setattr(taggs, "PCT_RAW_MAX", 1000)
    body = {"size": 0, "aggs": {"p": {"percentiles": {
        "field": "v", "percents": [5.0, 50.0, 95.0]}}}}
    got = both_search(pair, body)
    views = [(s, s.device(pair[1].device),
              pair[1].ctx.live_mask(s, s.device(pair[1].device)))
             for s in pair[1].segments]
    partial = taggs.AggregationExecutor(pair[1].ctx).collect(
        {"p": {"percentiles": {"field": "v"}}}, views)
    assert partial["p"]["kind"] == "cent" and len(partial["p"]["m"]) <= 4096
    for p, v in got["aggregations"]["p"]["values"].items():
        assert abs(v - float(np.percentile(vals, float(p)))) < 2.0


def test_cardinality_streams_to_hll_past_threshold():
    n = 6000
    mapping = {"properties": {"v": {"type": "long"}}}
    mapper, writer = JaxMapper(mapping), JaxWriter()
    segs = [writer.build([mapper.parse(f"{si}-{i}", {"v": si * 3000 + i})
                          for i in range(3000)], f"cd{si}")
            for si in range(2)]
    pair = pair_of(segs, mapping)
    for thr in (100, 40000):
        got = both_search(pair, {"size": 0, "aggs": {"c": {"cardinality": {
            "field": "v", "precision_threshold": thr}}}})
        assert abs(got["aggregations"]["c"]["value"] - n) / n < 0.05


# -- tests/test_aggs_tail.py and tests/test_pipeline_aggs.py -----------------

TAIL_MAPPING = {"properties": {
    "cat": {"type": "keyword"}, "tag": {"type": "keyword"},
    "n": {"type": "long"}, "price": {"type": "double"},
    "w": {"type": "double"}, "body": {"type": "text"},
    "day": {"type": "date"}}}
CATS = ["a", "b", "c"]
TAIL_DOCS = [{"cat": CATS[i % 3],
              "tag": f"t{i % 7}" if i % 9 else f"rare{i}",
              "n": int(i % 5), "price": float(i), "w": float(1 + i % 3),
              "body": ("sig special" if (CATS[i % 3] == "a" and i % 2 == 0)
                       else "common filler"),
              "day": f"2023-0{(i % 3) + 1}-15"} for i in range(90)]

PIPE_MAPPING = {"properties": {
    "day": {"type": "date"}, "price": {"type": "double"},
    "sparse": {"type": "double"}, "group": {"type": "keyword"}}}
PIPE_DOCS = []
for _m in range(1, 7):
    for _i in range(_m * 2):
        _d = {"day": f"2023-{_m:02d}-{(_i % 27) + 1:02d}",
              "price": float(_m * 10 + _i),
              "group": "a" if _i % 2 == 0 else "b"}
        if _m != 2:
            _d["sparse"] = float(_m)
        PIPE_DOCS.append(_d)


def split_segments(docs, mapping, n_segments, sep="-"):
    mapper, writer = JaxMapper(mapping), JaxWriter()
    per = math.ceil(len(docs) / n_segments)
    segs = []
    for si in range(n_segments):
        chunk = docs[si * per: (si + 1) * per]
        if chunk:
            segs.append(writer.build([mapper.parse(f"{si}{sep}{i}", d)
                                      for i, d in enumerate(chunk)],
                                     f"s{si}"))
    return segs


def run_both(docs, mapping, aggs, query=None, n_shards=1, sep="-"):
    """Each package's ``aggregations`` for ``aggs``: one shard, or
    ``n_shards`` one-segment shards whose JSON-round-tripped partials
    each package reduces."""
    body = {"size": 0, "query": query or {"match_all": {}}, "aggs": aggs}
    segs = split_segments(docs, mapping, n_shards, sep)
    if n_shards == 1:
        jax_s, port_s = pair_of(segs, mapping)
        return (port_s.search(body)["aggregations"],
                jax_s.search(body)["aggregations"])
    parts = {"ref": [], "port": []}
    for seg in segs:
        jax_s, port_s = pair_of([seg], mapping)
        parts["ref"].append(json.loads(json.dumps(
            jax_s.search(body, agg_partials=True)["aggregation_partials"])))
        parts["port"].append(json.loads(json.dumps(
            port_s.search(body, agg_partials=True)["aggregation_partials"])))
    return (taggs.reduce_aggs(aggs, parts["port"]),
            jaggs.reduce_aggs(aggs, parts["ref"]))


TAIL_CASES = {
    "extended_stats": ({"es": {"extended_stats": {"field": "price"}}},
                       None, (1, 3)),
    "weighted_avg": ({"wa": {"weighted_avg": {
        "value": {"field": "price"}, "weight": {"field": "w"}}}},
        None, (1, 3)),
    "percentile_ranks": ({"pr": {"percentile_ranks": {
        "field": "price", "values": [10, 50, 89]}}}, None, (1, 3)),
    "median_absolute_deviation": ({"mad": {"median_absolute_deviation": {
        "field": "price"}}}, None, (1, 3)),
    "significant_terms_jlh": ({"sig": {"significant_terms": {
        "field": "cat", "min_doc_count": 1}}},
        {"match": {"body": "sig"}}, (1, 3)),
    "rare_terms": ({"rare": {"rare_terms": {"field": "tag"}}}, None,
                   (1, 3)),
    "rare_terms_cross_shard_exclusion": ({
        "r40": {"rare_terms": {"field": "cat", "max_doc_count": 40}},
        "r20": {"rare_terms": {"field": "cat", "max_doc_count": 20}}},
        None, (3,)),
    "multi_terms_with_metric_sub": ({"mt": {
        "multi_terms": {"terms": [{"field": "cat"}, {"field": "n"}],
                        "size": 50},
        "aggs": {"p": {"sum": {"field": "price"}}}}}, None, (1, 3)),
    "top_hits_top_level_and_under_terms": ({
        "cats": {"terms": {"field": "cat"},
                 "aggs": {"best": {"top_hits": {
                     "size": 2, "sort": [{"price": {"order": "desc"}}],
                     "_source": ["price", "cat"]}}}},
        "overall": {"top_hits": {"size": 3, "sort": [
            {"price": {"order": "desc"}}]}}}, None, (1, 3)),
    "top_hits_by_score": ({"th": {"top_hits": {"size": 2}}},
                          {"match": {"body": "sig"}}, (1,)),
    "composite_date_histogram_source_with_sub": ({"comp": {
        "composite": {"size": 10, "sources": [{"month": {
            "date_histogram": {"field": "day",
                               "calendar_interval": "month"}}}]},
        "aggs": {"p": {"avg": {"field": "price"}}}}}, None, (1, 3)),
}
TAIL_PARAMS = [(name, n) for name, (_a, _q, shards) in TAIL_CASES.items()
               for n in shards]


@pytest.mark.parametrize("case,n_shards", TAIL_PARAMS,
                         ids=[f"{c}-{n}" for c, n in TAIL_PARAMS])
def test_tail_cases_equal_the_reference(case, n_shards):
    aggs, query, _shards = TAIL_CASES[case]
    got, ref = run_both(TAIL_DOCS, TAIL_MAPPING, aggs, query, n_shards)
    assert_aggs_equal(got, ref)


@pytest.mark.parametrize("n_shards", [1, 3])
def test_composite_terms_pagination(n_shards):
    after = None
    for _page in range(10):
        comp = {"size": 4, "sources": [{"c": {"terms": {"field": "cat"}}},
                                       {"num": {"terms": {"field": "n"}}}]}
        if after is not None:
            comp["after"] = after
        got, ref = run_both(TAIL_DOCS, TAIL_MAPPING,
                            {"comp": {"composite": comp}}, None, n_shards)
        assert_aggs_equal(got, ref)
        after = got["comp"].get("after_key")
        if not got["comp"]["buckets"] or after is None:
            break


def test_composite_desc_order():
    comp = {"size": 2, "sources": [{"c": {"terms": {"field": "cat",
                                                    "order": "desc"}}}]}
    got, ref = run_both(TAIL_DOCS, TAIL_MAPPING, {"comp": {"composite": comp}})
    assert_aggs_equal(got, ref)
    comp["after"] = got["comp"]["after_key"]
    got, ref = run_both(TAIL_DOCS, TAIL_MAPPING, {"comp": {"composite": comp}})
    assert_aggs_equal(got, ref)
    assert [b["key"]["c"] for b in got["comp"]["buckets"]] == ["a"]


@pytest.mark.parametrize("aggs", [
    {"t": {"terms": {"field": "cat"},
           "aggs": {"c": {"cardinality": {"field": "tag"}}}}},
    {"h": {"histogram": {"field": "price", "interval": 10},
           "aggs": {"th": {"top_hits": {}}}}}], ids=["cardinality", "top_hits"])
def test_unsupported_sub_agg_is_400(aggs):
    from opensearch_tpu.common.errors import IllegalArgumentError as JErr
    from opensearch_tpu_torch.common.errors import IllegalArgumentError

    jax_s, port_s = pair_of(split_segments(TAIL_DOCS, TAIL_MAPPING, 1),
                            TAIL_MAPPING)
    with pytest.raises(JErr) as ref:
        jax_s.search({"size": 0, "aggs": aggs})
    with pytest.raises(IllegalArgumentError) as got:
        port_s.search({"size": 0, "aggs": aggs})
    assert str(got.value) == str(ref.value)


HISTO = {"date_histogram": {"field": "day", "calendar_interval": "month"},
         "aggs": {"total": {"sum": {"field": "price"}}}}
SPARSE = {"date_histogram": {"field": "day", "calendar_interval": "month"},
          "aggs": {"a": {"avg": {"field": "sparse"}}}}


def _with(base, **subs):
    return {**base, "aggs": {**base["aggs"], **subs}}


PIPE_CASES = {
    "cumulative_sum_and_derivative": ({"histo": _with(
        HISTO, cum={"cumulative_sum": {"buckets_path": "total"}},
        deriv={"derivative": {"buckets_path": "total"}})}, (1, 3)),
    "derivative_count_path_and_unit": ({"histo": {
        "date_histogram": {"field": "day", "fixed_interval": "1d"},
        "aggs": {"d": {"derivative": {"buckets_path": "_count",
                                      "unit": "1d"}}}}}, (1,)),
    "serial_diff_lag2": ({"histo": _with(HISTO, sd={"serial_diff": {
        "buckets_path": "total", "lag": 2}})}, (1,)),
    "moving_fn_window_excludes_current": ({"histo": _with(HISTO, mf={
        "moving_fn": {"buckets_path": "total", "window": 2,
                      "script": "MovingFunctions.max(values)"}})}, (1,)),
    "moving_avg_alias_models": ({"histo": _with(
        HISTO,
        simple={"moving_avg": {"buckets_path": "total", "window": 3,
                               "model": "simple"}},
        linear={"moving_avg": {"buckets_path": "total", "window": 3,
                               "model": "linear"}})}, (1,)),
    "sibling_bucket_metrics": ({
        "histo": HISTO,
        "avg_m": {"avg_bucket": {"buckets_path": "histo>total"}},
        "max_m": {"max_bucket": {"buckets_path": "histo>total"}},
        "min_m": {"min_bucket": {"buckets_path": "histo>total"}},
        "sum_m": {"sum_bucket": {"buckets_path": "histo>total"}},
        "stats_m": {"stats_bucket": {"buckets_path": "histo>total"}},
        "est_m": {"extended_stats_bucket": {"buckets_path": "histo>total"}},
        "pct_m": {"percentiles_bucket": {"buckets_path": "histo>total",
                                         "percents": [50.0, 100.0]}}},
        (1, 3)),
    "stats_bucket_count_path": ({
        "histo": {"date_histogram": {"field": "day",
                                     "calendar_interval": "month"}},
        "st": {"stats_bucket": {"buckets_path": "histo>_count"}}}, (1,)),
    "bucket_script_and_selector": ({"histo": _with(
        HISTO,
        per_doc={"bucket_script": {"buckets_path": {"t": "total",
                                                    "c": "_count"},
                                   "script": "params.t / params.c"}},
        keep_big={"bucket_selector": {"buckets_path": {"c": "_count"},
                                      "script": "params.c > 4"}})}, (1, 3)),
    "bucket_script_bare_names_and_ternary": ({"histo": _with(
        HISTO, bs={"bucket_script": {"buckets_path": {"t": "total"},
                                     "script": "t > 100 ? t * 2 : 0"}})},
        (1,)),
    "bucket_sort_desc_and_size": ({"histo": _with(HISTO, by_total={
        "bucket_sort": {"sort": [{"total": {"order": "desc"}}],
                        "size": 3}})}, (1,)),
    "bucket_sort_from_without_sort": ({"histo": {
        **HISTO, "aggs": {"trunc": {"bucket_sort": {"from": 4}}}}}, (1,)),
    "chained_pipelines": ({
        "histo": _with(HISTO,
                       cum={"cumulative_sum": {"buckets_path": "total"}},
                       d_of_c={"derivative": {"buckets_path": "cum"}}),
        "max_d": {"max_bucket": {"buckets_path": "histo>d_of_c"}}}, (1,)),
    "pipeline_inside_single_bucket_filter": ({"only_a": {
        "filter": {"term": {"group": "a"}},
        "aggs": {"histo": HISTO,
                 "avg_m": {"avg_bucket": {"buckets_path": "histo>total"}}}}},
        (1,)),
    "sibling_path_through_single_bucket": ({
        "only_a": {"filter": {"term": {"group": "a"}},
                   "aggs": {"histo": HISTO}},
        "avg_m": {"avg_bucket": {"buckets_path": "only_a>histo>total"}}},
        (1,)),
    "gap_policy_skip_vs_insert_zeros": ({
        "skip": _with(SPARSE, d={"derivative": {"buckets_path": "a",
                                                "gap_policy": "skip"}}),
        "zeros": _with(SPARSE, d={"derivative": {
            "buckets_path": "a", "gap_policy": "insert_zeros"}})}, (1,)),
    "keep_values_gap_preserves_previous": ({"histo": _with(SPARSE, d={
        "derivative": {"buckets_path": "a",
                       "gap_policy": "keep_values"}})}, (1,)),
}
PIPE_PARAMS = [(name, n) for name, (_a, shards) in PIPE_CASES.items()
               for n in shards]


@pytest.mark.parametrize("case,n_shards", PIPE_PARAMS,
                         ids=[f"{c}-{n}" for c, n in PIPE_PARAMS])
def test_pipeline_cases_equal_the_reference(case, n_shards):
    aggs, _shards = PIPE_CASES[case]
    got, ref = run_both(PIPE_DOCS, PIPE_MAPPING, aggs, None, n_shards,
                        sep="_")
    assert_aggs_equal(got, ref)


@pytest.mark.parametrize("aggs,error", [
    ({"x": {"cumulative_sum": {"buckets_path": "t"},
            "aggs": {"y": {"sum": {"field": "price"}}}}}, "ParsingError"),
    ({"cs": {"cumulative_sum": {"buckets_path": "h>m"}}},
     "IllegalArgumentError"),
    ({"f": {"filter": {"term": {"group": "a"}},
            "aggs": {"cs": {"cumulative_sum": {"buckets_path": "x"}}}}},
     "IllegalArgumentError")],
    ids=["pipeline_agg_rejects_subs",
         "parent_pipeline_outside_multibucket_is_rejected",
         "parent_pipeline_under_single_bucket_is_rejected"])
def test_pipeline_rejections_equal_the_reference(aggs, error):
    from opensearch_tpu.common import errors as jerrors
    from opensearch_tpu_torch.common import errors as terrors

    segs = split_segments(PIPE_DOCS, PIPE_MAPPING, 1, "_")
    jax_s, port_s = pair_of(segs, PIPE_MAPPING)
    body = {"size": 0, "aggs": aggs}
    with pytest.raises(getattr(jerrors, error)) as ref:
        jax_s.search(body)
    with pytest.raises(getattr(terrors, error)) as got:
        port_s.search(body)
    assert str(got.value) == str(ref.value)


# -- the corpus's double column; aggs bodies stay off the batched route -----

def test_corpus_fare_column_equals_the_writer():
    n = 300
    cols = corpus.doc_value_columns(n, seed=3)
    segs = corpus.make_segments(corpus.build_raw_corpus(n), 2, columns=cols)
    mapper = DocumentMapper({"properties": {"fare": {"type": "double"}}})
    lo = 0
    for seg in segs:
        written = SegmentWriter().build(
            [mapper.parse(str(i), {"fare": float(cols["fare"][i])})
             for i in range(lo, lo + seg.n_docs)], "w")
        a, _ = segment_arrays(seg)
        b, _ = segment_arrays(written)
        for key in b:
            if key.startswith("numeric.fare."):
                assert a[key].dtype == b[key].dtype, key
                np.testing.assert_array_equal(a[key], b[key], err_msg=key)
        lo += seg.n_docs
    assert cols["fare"].dtype == np.float64
    assert np.array_equal(cols["fare"], np.round(cols["fare"], 2))
    # the columns drawn before it did not move
    again = corpus.doc_value_columns(n, seed=3)
    assert all(np.array_equal(cols[k], again[k]) for k in cols)


def test_match_with_aggs_never_takes_the_batched_route(monkeypatch):
    from opensearch_tpu_torch.search import batch as tbatch
    from opensearch_tpu_torch.search import engine as tengine

    segs = split_segments(TAIL_DOCS, TAIL_MAPPING, 3)
    jax_s, port_s = pair_of(segs, TAIL_MAPPING)
    body = {"query": {"match": {"body": "sig special"}}, "size": 10,
            "aggs": {"c": {"terms": {"field": "cat"},
                           "aggs": {"p": {"avg": {"field": "price"}}}}}}
    plain = {"query": body["query"], "size": 10}
    port_s.search(body)                        # compiled: the batcher peeks
    port_s.search(plain)
    assert tbatch.batchable(port_s, body) is None
    assert tbatch.batchable(port_s, dict(body, aggs=None,
                                         aggregations=body["aggs"])) is None
    assert tbatch.batchable(port_s, plain) is not None
    runs = []
    real_run = tbatch.BatchGroup.run
    monkeypatch.setattr(tbatch.BatchGroup, "run", lambda self, s: (
        runs.append(len(self.positions)), real_run(self, s))[1])
    outs = port_s.msearch([body, plain, body])
    ref = jax_s.search(body)
    for resp in (outs[0], outs[2]):
        assert_aggs_equal(resp["aggregations"], ref["aggregations"])
    assert "aggregations" not in outs[1]
    assert runs == [1]                         # only the plain body
    svc = type("Svc", (), {"_use_mesh": staticmethod(lambda b: False)})()
    monkeypatch.setattr(tengine, "BATCHER_ENABLED", True)
    resp = tengine.query_engine().execute(port_s, body, service=svc)
    assert_aggs_equal(resp["aggregations"], ref["aggregations"])
    assert runs == [1]
