"""The geo queries of the PyTorch port and the geo columns they read,
through ``ShardSearcher`` on the CPU against the JAX package's, on the
same docs: ``geo_distance``, ``geo_bounding_box``, ``geo_polygon``,
``exists`` on a geo_point field, and the geo forms of
``distance_feature`` and the decays, over three segments of a few
hundred points in the nyc_taxis pickup box (clustered around Midtown,
some docs with several points, some with none) with deletes.  Masks and
scores must be equal byte for byte; errors of the same type and status.

Also: ``DeviceSegment.geo`` (float64 columns padded as the reference
pads them, the dead slot), ``segment_arrays`` -> ``segment_from_arrays``
carrying a JAX-package segment's geo columns, and the constant-score
bound of the geo filters.
"""

import numpy as np
import pytest
import torch

from opensearch_tpu.common.errors import OpenSearchTpuError as JaxError
from opensearch_tpu.index.segment import SegmentWriter as JaxWriter
from opensearch_tpu.mapping.mapper import DocumentMapper as JaxMapper
from opensearch_tpu.ops import bm25 as jbm25
from opensearch_tpu.search import plan as jplan
from opensearch_tpu.search.executor import ShardSearcher as JaxSearcher
from opensearch_tpu_torch.common.errors import OpenSearchTpuError
from opensearch_tpu_torch.index.segment import (pad_pow2, segment_arrays,
                                                segment_from_arrays)
from opensearch_tpu_torch.mapping.mapper import DocumentMapper
from opensearch_tpu_torch.search import plan as tplan
from opensearch_tpu_torch.search.executor import ShardSearcher
from opensearch_tpu_torch.testing import corpus
from test_torch_multiterm import check, shard_pair

MAPPING = {"properties": {"body": {"type": "text"},
                          "pickup": {"type": "geo_point"},
                          "dropoff": {"type": "geo_point"},
                          "fare": {"type": "double"}}}
SPLITS = (160, 120, 100)
MIDTOWN = corpus.MIDTOWN


def sources(n_docs=sum(SPLITS), seed=41):
    """Seeded docs and extra points: a pickup point (``relevance_columns``'
    shape: clustered around Midtown, the rest over the pickup box), a
    dropoff point on most docs, 1-3 more pickup points on every seventh
    doc and a fare."""
    cols = corpus.relevance_columns(n_docs, seed=seed)
    lats, lons = cols["pickup"]
    rng = np.random.default_rng(seed + 1)
    out, points = [], {}
    for i in range(n_docs):
        src = {"body": " ".join(rng.choice(["ride", "taxi", "cab", "fare"],
                                           size=3)),
               "pickup": {"lat": float(lats[i]), "lon": float(lons[i])},
               "dropoff": {"lat": float(np.round(rng.uniform(40.5, 40.9),
                                                 6)),
                           "lon": float(np.round(rng.uniform(-74.2, -73.7),
                                                 6))},
               "fare": float(np.round(rng.lognormal(2.3, 0.6), 2))}
        if i % 11 == 3:
            del src["pickup"]
        if i % 13 == 5:
            del src["dropoff"]
        if i % 7 == 0 and "pickup" in src:
            points[(i, "pickup")] = [
                (float(np.round(MIDTOWN[0] + rng.normal(0, 0.03), 6)),
                 float(np.round(MIDTOWN[1] + rng.normal(0, 0.03), 6)))
                for _ in range(int(rng.integers(1, 4)))]
        out.append(src)
    return out, points


@pytest.fixture(scope="module")
def shards():
    docs, points = sources()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jbm25, "HOST_SCORING", False)
        yield shard_pair(MAPPING, docs, SPLITS, deletes=7, points=points)


def vertex_lat(docs) -> float:
    """A pickup latitude of the corpus, so a polygon vertex lies on a
    value's latitude."""
    return next(d["pickup"]["lat"] for d in docs[40:] if "pickup" in d)


LOWER_MANHATTAN = {"top_left": {"lat": 40.76, "lon": -74.02},
                   "bottom_right": {"lat": 40.70, "lon": -73.97}}
OCTAGON = [(40.80, -73.99), (40.79, -73.95), (40.76, -73.93),
           (40.73, -73.95), (40.72, -73.99), (40.73, -74.03),
           (40.76, -74.05), (40.79, -74.03)]


def polygon(pts, field="pickup", **kw):
    return {"geo_polygon": {field: {"points": [{"lat": a, "lon": o}
                                               for a, o in pts]}, **kw}}


def geo_bodies(docs):
    lat = vertex_lat(docs)
    return [
        {"geo_distance": {"distance": "2km", "pickup": {
            "lat": MIDTOWN[0], "lon": MIDTOWN[1]}}},
        {"geo_distance": {"distance": "20km", "pickup": "40.758,-73.9855"}},
        {"geo_distance": {"distance": 1500, "pickup": [-73.99, 40.75]}},
        {"geo_distance": {"distance": "1.2mi", "dropoff": "40.7,-74.0",
                          "boost": 2.0}},
        {"geo_distance": {"distance": "0km", "pickup": {
            "lat": docs[1]["pickup"]["lat"],
            "lon": docs[1]["pickup"]["lon"]}}},
        {"geo_distance": {"distance": "3km", "missing_field": "40.7,-74"}},
        {"geo_bounding_box": {"pickup": LOWER_MANHATTAN}},
        {"geo_bounding_box": {"pickup": {"top": 40.8, "left": -74.0,
                                         "bottom": 40.74,
                                         "right": -73.96}}},
        {"geo_bounding_box": {"dropoff": {
            "top_left": "40.9,-74.3", "bottom_right": [-73.8, 40.6]},
            "boost": 0.5}},
        polygon(OCTAGON),
        polygon(OCTAGON[:3]),
        polygon([(40.70, -74.05), (40.82, -74.05), (40.82, -73.99),
                 (40.75, -73.99), (40.75, -73.90), (40.70, -73.90)]),
        polygon([(lat, -74.05), (lat + 0.05, -73.98), (lat, -73.90),
                 (lat - 0.05, -73.98)]),
        polygon([(lat, -74.30), (lat, -73.60), (40.40, -73.60),
                 (40.40, -74.30)]),
        polygon(OCTAGON + [OCTAGON[-1], OCTAGON[-1]], field="dropoff"),
        {"exists": {"field": "pickup"}},
        {"exists": {"field": "dropoff", "boost": 3.0}},
        {"bool": {"must": [{"match": {"body": "taxi"}}],
                  "filter": [{"geo_distance": {
                      "distance": "5km", "pickup": "40.75,-73.98"}}],
                  "must_not": [polygon(OCTAGON[:4])]}},
        {"constant_score": {"filter": {"geo_bounding_box": {
            "pickup": LOWER_MANHATTAN}}, "boost": 1.7}},
        {"bool": {"should": [{"exists": {"field": "dropoff"}},
                             {"geo_distance": {"distance": "1km",
                                               "pickup": "40.76,-73.98"}}],
                  "minimum_should_match": 2}},
        {"distance_feature": {"field": "pickup", "origin": "40.758,-73.9855",
                              "pivot": "1km"}},
        {"distance_feature": {"field": "dropoff", "origin": [-73.9, 40.8],
                              "pivot": "5km", "boost": 2.0}},
        {"function_score": {"query": {"match": {"body": "taxi cab"}},
                            "functions": [
                                {"gauss": {"pickup": {
                                    "origin": "40.758,-73.9855",
                                    "scale": "2km"}}},
                                {"linear": {"dropoff": {
                                    "origin": "40.7,-74.0", "scale": "8km",
                                    "offset": "500m"}}, "weight": 3.0},
                                {"exp": {"pickup": {
                                    "origin": {"lat": 40.8, "lon": -73.95},
                                    "scale": "4km", "decay": 0.2}},
                                 "filter": {"geo_bounding_box": {
                                     "pickup": LOWER_MANHATTAN}}}],
                            "score_mode": "sum"}},
    ]


GEO_BODIES = geo_bodies(sources()[0])


@pytest.mark.parametrize("query", GEO_BODIES,
                         ids=[f"{i}-{next(iter(q))}"
                              for i, q in enumerate(GEO_BODIES)])
def test_geo_query_equals_reference(shards, query):
    for extra in ({"size": 10}, {"size": 400}):
        check(shards, {"query": query, **extra})
    jax_s, port_s = shards
    assert port_s.count(query) == jax_s.count(query), query


def test_polygon_vertex_on_a_latitude(shards):
    """A vertex on a point's exact latitude: the even-odd test counts
    the two edges that meet there as the reference does, and the point
    is matched or not on both sides alike."""
    docs, _points = sources()
    lat = vertex_lat(docs)
    body = polygon([(lat, -74.05), (lat + 0.05, -73.98), (lat, -73.90),
                    (lat - 0.05, -73.98)])
    resp = check(shards, {"query": body, "size": 400})
    assert resp["hits"]["total"]["value"] > 0


def test_geo_columns_staged_as_the_reference():
    """``DeviceSegment.geo``: float64 lats / lons (the float32 host values
    widened), padded to ``pad_pow2(V)`` with 0.0, value docs padded with
    the dead slot ``n_docs``, ``exists`` over ``n_pad``; counted in
    ``nbytes``; a field absent from a segment reads an empty dummy."""
    docs, points = sources()
    _jax_s, port_s = shard_pair(MAPPING, docs, SPLITS, points=points)
    for seg in port_s.segments:
        d = seg.device("cpu")
        dv = seg.geo_dv["pickup"]
        g = d.geo["pickup"]
        v, v_pad = len(dv.lats), pad_pow2(len(dv.lats))
        assert g["lats"].dtype == g["lons"].dtype == torch.float64
        assert g["lats"].shape == (v_pad,)
        np.testing.assert_array_equal(g["lats"][:v].numpy(),
                                      dv.lats.astype(np.float64))
        np.testing.assert_array_equal(g["lons"][:v].numpy(),
                                      dv.lons.astype(np.float64))
        assert not g["lats"][v:].any()
        assert (g["value_docs"][v:] == seg.n_docs).all()
        np.testing.assert_array_equal(g["value_docs"][:v].numpy(),
                                      dv.value_docs)
        assert g["exists"].shape == (d.n_pad,)
        np.testing.assert_array_equal(g["exists"][:seg.n_docs].numpy(),
                                      dv.exists)
        assert d.column_bytes("geo") == sum(
            t.numel() * t.element_size() for f in d.geo.values()
            for t in f.values())
        assert d.nbytes() >= d.column_bytes("geo") > 0


def test_segment_arrays_carry_geo(monkeypatch):
    """A JAX-package segment's geo columns reach the port through
    ``segment_arrays`` / ``segment_from_arrays`` equal to what the
    port's writer builds, and the geo queries over the carried segments
    answer as the reference over its own."""
    monkeypatch.setattr(jbm25, "HOST_SCORING", False)
    docs, points = sources(150, seed=8)
    jmapper = JaxMapper(MAPPING)
    tmapper = DocumentMapper(MAPPING)
    jsegs, written = [], []
    for si, (lo, hi) in enumerate(((0, 90), (90, 150))):
        for mapper, writer, out in ((jmapper, JaxWriter(), jsegs),
                                    (tmapper, None, written)):
            parsed = [mapper.parse(str(i), docs[i]) for i in range(lo, hi)]
            for (doc, field), pts in points.items():
                if lo <= doc < hi:
                    parsed[doc - lo].geo_points[field].extend(pts)
            if writer is None:
                from opensearch_tpu_torch.index.segment import SegmentWriter
                writer = SegmentWriter()
            out.append(writer.build(parsed, f"g{si}"))
    carried = [segment_from_arrays(*segment_arrays(s)) for s in jsegs]
    for c, w in zip(carried, written):
        assert sorted(c.geo_dv) == ["dropoff", "pickup"]
        a, meta_a = segment_arrays(c)
        b, meta_b = segment_arrays(w)
        assert meta_a["geo"] == meta_b["geo"] == ["dropoff", "pickup"]
        for key in b:
            if key.startswith("geo."):
                assert a[key].dtype == b[key].dtype, key
                np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    pair_ = (JaxSearcher(jsegs, jmapper),
             ShardSearcher(carried, tmapper, device="cpu"))
    for query in GEO_BODIES[:17]:
        check(pair_, {"query": query, "size": 200})


def test_constant_score_bounds(shards):
    """The geo filters' bound is their boost (the reference registers
    the same), so ``min_score`` prunes them alike."""
    _jax_s, port_s = shards
    for query in ({"geo_distance": {"distance": "2km",
                                    "pickup": "40.758,-73.9855",
                                    "boost": 2.0}},
                  {"geo_bounding_box": {"pickup": LOWER_MANHATTAN,
                                        "boost": 2.0}},
                  polygon(OCTAGON, boost=2.0)):
        plan, bind = port_s.compiled(query)
        assert isinstance(plan, (tplan.GeoDistancePlan, tplan.GeoBoxPlan,
                                 tplan.GeoPolygonPlan))
        assert plan.max_score_bound(bind, port_s.segments[0]) == \
            jplan._boost_bound(None, bind, None)
        for ms in (1.5, 2.5):
            check(shards, {"query": query, "min_score": ms, "size": 50})


ERROR_BODIES = [
    {"geo_distance": {"distance": "2km", "fare": "40.7,-74.0"}},
    {"geo_bounding_box": {"body": LOWER_MANHATTAN}},
    polygon(OCTAGON, field="fare"),
    {"geo_polygon": {"pickup": {"points": [{"lat": 1, "lon": 1}]}}},
    {"geo_distance": {"distance": "far", "pickup": "40.7,-74.0"}},
    {"geo_bounding_box": {"pickup": {"top": 40.0, "left": -74.0,
                                     "bottom": 41.0, "right": -73.0}}},
    {"distance_feature": {"field": "pickup", "origin": "40.7,-74.0",
                          "pivot": "0km"}},
]


@pytest.mark.parametrize("query", ERROR_BODIES,
                         ids=[f"{i}-{next(iter(q))}"
                              for i, q in enumerate(ERROR_BODIES)])
def test_errors_equal_reference(shards, query):
    jax_s, port_s = shards
    with pytest.raises(JaxError) as ref:
        jax_s.search({"query": query})
    with pytest.raises(OpenSearchTpuError) as got:
        port_s.search({"query": query})
    assert type(got.value).__name__ == type(ref.value).__name__
    assert got.value.status == ref.value.status
