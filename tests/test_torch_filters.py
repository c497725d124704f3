"""Filters and doc-value columns of the PyTorch port against the JAX
package, on the CPU.

- The four mask ops of ``ops/filters.py`` (``range_mask``,
  ``term_mask``, ``terms_mask``, ``postings_mask``) equal the
  reference's exactly, on multi-valued columns with their padding
  (values 0, value docs at the dead slot) and on int64, float64 and
  int32 (ordinal) columns.
- ``DeviceSegment`` stages the numeric and ordinal columns with the
  reference's pads and dtypes (int64 and float64, never narrowed), and
  ``segment_arrays`` / ``segment_from_arrays`` carry them across; a
  segment without a column (the last one has no ``score``) answers
  through the executor's empty stand-in columns as the reference does.
- Every ported compiler entry and filter plan, through both packages'
  searchers: ``range`` on long, double, date, keyword and ip fields,
  ``terms`` on keyword, numeric, ip (exact and CIDR) and ``_id``,
  ``term`` on numeric, ``_id`` and an ip CIDR, ``exists``, ``ids``,
  ``prefix``, and each inside ``bool`` and ``constant_score`` and as a
  ``knn`` filter; responses equal byte for byte once ``took`` is
  stripped (k-NN within rtol 1e-5 / atol 1e-6), counts equal.
- The same requests to both nodes over HTTP (``_search`` and
  ``_count``), as ``tests/test_torch_rest.py`` holds them.
- ``testing/corpus.py``'s doc-value columns equal what the writer builds
  for the same docs.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opensearch_tpu.index.segment import SegmentWriter as JaxWriter
from opensearch_tpu.mapping.mapper import DocumentMapper as JaxMapper
from opensearch_tpu.node import Node as JaxNode
from opensearch_tpu.ops import bm25 as jbm25
from opensearch_tpu.ops import filters as jfilters
from opensearch_tpu.search.executor import ShardSearcher as JaxSearcher
from opensearch_tpu_torch.index.segment import (LONG_MISSING_MAX,
                                                LONG_MISSING_MIN,
                                                SegmentWriter, pad_pow2,
                                                segment_arrays,
                                                segment_from_arrays)
from opensearch_tpu_torch.mapping.mapper import DocumentMapper
from opensearch_tpu_torch.node import Node
from opensearch_tpu_torch.ops import bm25 as tbm25
from opensearch_tpu_torch.ops import filters as tfilters
from opensearch_tpu_torch.search.executor import ShardSearcher
from opensearch_tpu_torch.testing import corpus
from opensearch_tpu_torch.testing.parity import knn_mismatch
from test_torch_ops import both as csr_both, case_bag, csr_case
from test_torch_rest import both as http_both

TAGS = [f"g{i}" for i in range(9)]
MAPPING = {"properties": {
    "body": {"type": "text"},
    "tag": {"type": "keyword"},
    "price": {"type": "long"},
    "score": {"type": "double"},
    "ts": {"type": "date"},
    "ip": {"type": "ip"},
    "vec": {"type": "knn_vector", "dimension": 4, "space_type": "l2"},
}}
SEG_SIZES = (90, 70, 40)


def filter_docs(seed: int, n: int) -> list:
    """Docs with multi-valued and missing columns: prices as lists, some
    docs without a tag, a price, a vector or a body, zero-token bodies."""
    rng = np.random.default_rng(seed)
    docs = []
    for i in range(n):
        doc = {"body": " ".join(f"w{int(w) % 20}" for w in
                                rng.zipf(1.5, size=int(rng.integers(0, 8)))),
               "tag": [TAGS[int(t)] for t in
                       rng.integers(0, len(TAGS), size=int(rng.integers(1, 3)))],
               "price": [int(p) for p in
                         rng.integers(-50, 500, size=int(rng.integers(1, 4)))],
               "score": float(np.round(rng.normal(0, 10), 3)),
               "ts": f"2024-01-{int(rng.integers(1, 29)):02d}T"
                     f"{int(rng.integers(0, 24)):02d}:00:00Z",
               "ip": f"10.0.{int(rng.integers(0, 2))}.{int(rng.integers(0, 9))}",
               "vec": rng.normal(size=4).round(3).tolist()}
        for key, every in (("tag", 7), ("price", 5), ("vec", 6),
                           ("body", 11), ("score", 9), ("ip", 8)):
            if i % every == 3:
                del doc[key]
        if i >= sum(SEG_SIZES[:2]):       # the last segment has no score
            doc.pop("score", None)
        docs.append(doc)
    return docs


def build(writer, mapper, docs):
    segs, i = [], 0
    for si, size in enumerate(SEG_SIZES):
        segs.append(writer.build([mapper.parse(str(i + j), d) for j, d in
                                  enumerate(docs[i: i + size])], f"f{si}"))
        i += size
    return segs


@pytest.fixture(scope="module", params=[4, 41])
def pair(request):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jbm25, "HOST_SCORING", False)
        docs = filter_docs(request.param, sum(SEG_SIZES))
        jsegs = build(JaxWriter(), JaxMapper(MAPPING), docs)
        rng = np.random.default_rng(request.param + 1)
        for seg in jsegs:
            seg.apply_deletes(rng.choice(seg.n_docs, size=5, replace=False))
        tsegs = [segment_from_arrays(*segment_arrays(s)) for s in jsegs]
        yield (JaxSearcher(jsegs, JaxMapper(MAPPING)),
               ShardSearcher(tsegs, DocumentMapper(MAPPING), device="cpu"))


def strip_took(resp):
    resp = json.loads(json.dumps(resp))
    resp.pop("took", None)
    return resp


FILTERS = [
    {"range": {"price": {"gte": 10, "lt": 200}}},
    {"range": {"price": {"gt": 10, "lte": 200}}},
    {"range": {"price": {"lt": 0}}},
    {"range": {"score": {"gt": -2.5, "lte": 7.25}}},
    {"range": {"score": {"gte": 0.0}}},
    {"range": {"ts": {"gte": "2024-01-05", "lt": "2024-01-20"}}},
    {"range": {"ts": {"gt": "2024-01-10T05:00:00Z"}}},
    {"range": {"tag": {"gte": "g2", "lt": "g5"}}},
    {"range": {"tag": {"gt": "g6"}}},
    {"range": {"ip": {"gte": "10.0.0.2", "lte": "10.0.1.4"}}},
    {"terms": {"tag": ["g1", "g3", "nope"]}},
    {"terms": {"price": [5, 17, 250, 499]}},
    {"terms": {"ip": ["10.0.0.1", "10.0.1.0/30"]}},
    {"terms": {"ip": ["10.0.0.3", "10.0.1.5"]}},
    {"terms": {"_id": ["1", "7", "150", "nope"]}},
    {"term": {"price": 42}},
    {"term": {"score": 1.5}},
    {"term": {"_id": "12"}},
    {"term": {"ip": "10.0.0.0/29"}},
    {"exists": {"field": "price"}},
    {"exists": {"field": "tag"}},
    {"exists": {"field": "body"}},
    {"exists": {"field": "vec"}},
    {"exists": {"field": "nope"}},
    {"exists": {"field": "_id"}},
    {"ids": {"values": ["0", "3", "88", "199"]}},
    {"prefix": {"tag": "g1"}},
]


def bodies():
    out = [{"query": f, "size": 30} for f in FILTERS]
    out += [
        {"query": {"bool": {"must": [{"match": {"body": "w1 w2"}}],
                            "filter": [{"range": {"price": {"gte": 100}}},
                                       {"terms": {"tag": ["g0", "g2"]}}]}},
         "size": 20},
        {"query": {"bool": {"must": [{"match": {"body": "w0 w3"}}],
                            "must_not": [{"range": {"ts": {
                                "lt": "2024-01-10"}}}]}}, "size": 15},
        {"query": {"bool": {"should": [{"range": {"price": {"lt": 50}}},
                                       {"term": {"tag": "g4"}},
                                       {"exists": {"field": "vec"}}],
                            "minimum_should_match": 2}}, "size": 40},
        {"query": {"constant_score": {"filter": {"range": {
            "score": {"lt": 0}}}, "boost": 3.5}}, "size": 10},
        {"query": {"bool": {"must": [{"match": {"body": "w1"}}],
                            "filter": [{"ids": {"values": ["1", "2", "5",
                                                           "40"]}}]}}},
        {"query": {"range": {"price": {"gte": 100}}}, "size": 0},
    ]
    return out


def test_filter_searches_equal_the_reference(pair):
    jax_s, port_s = pair
    for body in bodies():
        ref, got = jax_s.search(dict(body)), port_s.search(dict(body))
        assert strip_took(got) == strip_took(ref), body
    assert any(jax_s.search({"query": f})["hits"]["total"]["value"]
               for f in FILTERS)


def test_filter_counts_equal_the_reference(pair):
    jax_s, port_s = pair
    for f in FILTERS:
        assert port_s.count(f) == jax_s.count(f), f


def test_knn_with_a_range_filter(pair):
    jax_s, port_s = pair
    for flt in ({"range": {"price": {"gte": 100}}},
                {"terms": {"tag": ["g1", "g2"]}}):
        body = {"query": {"knn": {"vec": {"vector": [0.1, -0.2, 0.3, 0.0],
                                          "k": 7, "filter": flt}}},
                "size": 7}
        ref, got = jax_s.search(dict(body)), port_s.search(dict(body))
        assert ref["hits"]["hits"]
        assert knn_mismatch(got, ref) is None, knn_mismatch(got, ref)


# -- the mask ops --------------------------------------------------------------

def column_case(seed, kind):
    """A multi-valued column of 60 docs (some docs without a value),
    padded as ``DeviceSegment`` pads it."""
    rng = np.random.default_rng(seed)
    n_docs = 60
    counts = rng.integers(0, 4, size=n_docs)
    value_docs = np.repeat(np.arange(n_docs, dtype=np.int32), counts)
    if kind == "long":
        values = rng.integers(-(2**40), 2**40, size=len(value_docs))
        values[::5] = rng.integers(-3, 3, size=len(values[::5]))
    elif kind == "double":
        values = rng.normal(0, 4, size=len(value_docs)).round(2)
    else:
        values = rng.integers(0, 12, size=len(value_docs)).astype(np.int32)
    v_pad = pad_pow2(len(values))
    vals = np.zeros(v_pad, values.dtype)
    vals[: len(values)] = values
    docs = np.full(v_pad, n_docs, np.int32)
    docs[: len(values)] = value_docs
    return vals, docs, pad_pow2(n_docs + 1)


@pytest.mark.parametrize("seed", [1, 2, 3])
@pytest.mark.parametrize("kind", ["long", "double", "ordinal"])
def test_value_masks_equal_the_reference(seed, kind):
    vals, docs, n_pad = column_case(seed, kind)
    jv, jd = jnp.asarray(vals), jnp.asarray(docs)
    tv, td = torch.from_numpy(vals), torch.from_numpy(docs)
    rng = np.random.default_rng(seed + 10)
    picks = vals[rng.integers(0, len(vals), size=3)]
    bounds = [(picks[0], picks[1]), (min(picks), max(picks)),
              (vals.min() - 1, vals.max() + 1)]
    if kind == "long":
        bounds.append((np.iinfo(np.int64).min, 0))
    if kind == "double":
        bounds.append((-np.inf, np.inf))
    for lo, hi in bounds:
        for inc_lo in (True, False):
            for inc_hi in (True, False):
                kw = dict(include_lo=inc_lo, include_hi=inc_hi, n_pad=n_pad)
                ref = jfilters.range_mask(jv, jd, jnp.asarray(lo, vals.dtype),
                                          jnp.asarray(hi, vals.dtype), **kw)
                got = tfilters.range_mask(tv, td, lo.item() if hasattr(
                    lo, "item") else lo, hi.item() if hasattr(hi, "item")
                    else hi, **kw)
                np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    for value in picks:
        ref = jfilters.term_mask(jv, jd, jnp.asarray(value), n_pad=n_pad)
        got = tfilters.term_mask(tv, td, value.item(), n_pad=n_pad)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    q = np.concatenate([picks, picks[:1]])
    ref = jfilters.terms_mask(jv, jd, jnp.asarray(q), n_pad=n_pad)
    got = tfilters.terms_mask(tv, td, torch.from_numpy(q), n_pad=n_pad)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("case", [(3, 50, 12, 2, 0), (17, 300, 40, 5, 1),
                                  (11, 700, 30, 3, 3)])
def test_postings_mask_equals_the_reference(case):
    c = csr_case(*case)
    j, t = csr_both(c, "offsets", "doc_ids", "tfs", "tids", "active")
    kw = dict(n_pad=c["n_pad"], budget=c["budget"])
    ref = np.asarray(jfilters.postings_mask(*j, **kw))
    np.testing.assert_array_equal(
        tfilters.postings_mask_plain(*t, **kw).numpy(), ref)
    # the dense entry's counts-only mode, as PostingsMaskPlan reads it
    (_s, counts), = tbm25.term_bag_dense_auto([case_bag(c, scores=False)],
                                              scores=False, counts=True)
    np.testing.assert_array_equal((counts > 0).numpy(), ref)
    assert ref.any() == (case[3] > case[4])   # no active slot: no match


# -- staging and carrying the columns ------------------------------------------

def test_device_segment_stages_the_columns_as_the_reference(pair):
    jax_s, port_s = pair
    for jseg, tseg in zip(jax_s.segments, port_s.segments):
        jd, td = jseg.device(), tseg.device("cpu")
        assert set(td.numeric) == set(jd.numeric) <= {"price", "score",
                                                      "ts", "ip"}
        assert set(td.ordinal) == set(jd.ordinal) == {"tag"}
        for group in ("numeric", "ordinal"):
            for name, cols in getattr(jd, group).items():
                for col, arr in cols.items():
                    got = getattr(td, group)[name][col]
                    if col == "n_ords":
                        assert got == arr
                        continue
                    ref = np.asarray(arr)
                    assert str(got.dtype).split(".")[-1] == str(ref.dtype) \
                        or (ref.dtype == np.bool_ and got.dtype == torch.bool)
                    np.testing.assert_array_equal(got.numpy(), ref,
                                                  err_msg=f"{name}.{col}")
        price = td.numeric["price"]
        assert price["values"].dtype == torch.int64
        if "score" in td.numeric:
            assert td.numeric["score"]["values"].dtype == torch.float64
        assert int(price["minv"][-1]) == LONG_MISSING_MAX
        assert int(price["maxv"][-1]) == LONG_MISSING_MIN
        assert int(td.ordinal["tag"]["ords"][-1]) == -1
        n_vals = len(tseg.numeric_dv["price"].values)
        assert (price["value_docs"][n_vals:] == tseg.n_docs).all()
        # resident bytes count the columns
        cols = sum(td.column_bytes(g) for g in ("numeric", "ordinal"))
        assert cols > 0 and td.nbytes() >= cols + td.column_bytes("postings")


def test_segment_arrays_carry_the_doc_values(pair):
    jax_s, port_s = pair
    for jseg, tseg in zip(jax_s.segments, port_s.segments):
        ja, jm = segment_arrays(jseg)
        ta, tm = segment_arrays(tseg)
        assert jm == tm and sorted(ja) == sorted(ta)
        assert {k.split(".")[0] for k in ja} >= {"numeric", "ordinal"}
        for key in ja:
            assert ja[key].dtype == ta[key].dtype, key
            np.testing.assert_array_equal(ja[key], ta[key], err_msg=key)


@pytest.mark.parametrize("seed", [4, 41])
def test_port_writer_builds_the_reference_columns(seed):
    docs = filter_docs(seed, sum(SEG_SIZES))
    for j, t in zip(build(JaxWriter(), JaxMapper(MAPPING), docs),
                    build(SegmentWriter(), DocumentMapper(MAPPING), docs)):
        ja, jm = segment_arrays(j)
        ta, tm = segment_arrays(t)
        assert jm == tm
        for key in ja:
            np.testing.assert_array_equal(ja[key], ta[key], err_msg=key)


def test_corpus_columns_equal_the_writer(tmp_path):
    n = 300
    cols = corpus.doc_value_columns(n, seed=3)
    segs = corpus.make_segments(corpus.build_raw_corpus(n), 2,
                                columns=cols)
    mapper = DocumentMapper({"properties": {"body": {"type": "text"},
                                            **corpus.COLUMNS_MAPPING}})
    lo = 0
    for seg in segs:
        written = SegmentWriter().build(
            [mapper.parse(str(i), {"price": int(cols["price"][i]),
                                   "ts": int(cols["ts"][i]),
                                   "tag": corpus.tag_name(cols["tag"][i])})
             for i in range(lo, lo + seg.n_docs)], "w")
        a, _ = segment_arrays(seg)
        b, _ = segment_arrays(written)
        for key in b:
            if key.split(".")[0] in ("numeric", "ordinal") or \
                    key.startswith("postings.tag."):
                assert a[key].dtype == b[key].dtype, key
                np.testing.assert_array_equal(a[key], b[key], err_msg=key)
        assert seg.ordinal_dv["tag"].ord_terms == \
            written.ordinal_dv["tag"].ord_terms
        lo += seg.n_docs
    assert cols["price"].min() >= 0 and cols["price"].max() <= \
        corpus.PRICE_MAX
    assert int(cols["tag"].max()) < corpus.TAG_VALUES


# -- both nodes over HTTP ------------------------------------------------------

@pytest.fixture(scope="module")
def nodes(tmp_path_factory):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jbm25, "HOST_SCORING", False)
        ref = JaxNode(str(tmp_path_factory.mktemp("fref")), port=0).start()
        port = Node(str(tmp_path_factory.mktemp("fport")), port=0,
                    device="cpu").start()
        try:
            yield ref, port
        finally:
            ref.stop()
            port.stop()


def test_filters_over_http_equal_the_reference_node(nodes):
    http_both(nodes, "PUT", "/flt", {"settings": {"number_of_shards": 2},
                                     "mappings": MAPPING})
    lines = []
    for i, doc in enumerate(filter_docs(7, 160)):
        lines += [{"index": {"_index": "flt", "_id": str(i)}}, doc]
    status, resp = http_both(nodes, "POST", "/_bulk?refresh=true",
                             ndjson=lines)
    assert status == 200 and not resp["errors"]
    for body in bodies():
        status, resp = http_both(nodes, "POST", "/flt/_search", body)
        assert status == 200, (body, resp)
    for f in FILTERS:
        status, resp = http_both(nodes, "POST", "/flt/_count", {"query": f})
        assert status == 200, (f, resp)
