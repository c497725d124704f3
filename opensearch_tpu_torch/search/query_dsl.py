"""Query DSL: JSON -> typed query tree.

Analog of the reference's ``index/query/*QueryBuilder`` classes (47 builders,
server/src/main/java/org/opensearch/index/query/; parsed via
``AbstractQueryBuilder.parseInnerQueryBuilder``).  Parsing is independent of
any shard: the tree is compiled against a shard's segments by
``opensearch_tpu_torch.search.plan`` (the ``toQuery(QueryShardContext)`` analog,
ref index/query/QueryShardContext.java:95).
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field as dc_field
from typing import Any, Optional

from opensearch_tpu_torch.common.errors import ParsingError


@dataclass
class Query:
    boost: float = 1.0


@dataclass
class MatchAllQuery(Query):
    pass


@dataclass
class MatchNoneQuery(Query):
    pass


@dataclass
class TermQuery(Query):
    field: str = ""
    value: Any = None


@dataclass
class TermsQuery(Query):
    field: str = ""
    values: list = dc_field(default_factory=list)


@dataclass
class MatchQuery(Query):
    field: str = ""
    query: Any = None
    operator: str = "or"            # or | and
    minimum_should_match: Optional[str] = None
    fuzziness: Optional[str] = None
    lenient: bool = False           # format mismatch -> no match, not 400
    analyzer: Optional[str] = None


@dataclass
class MatchPhraseQuery(Query):
    field: str = ""
    query: Any = None
    slop: int = 0


@dataclass
class MatchPhrasePrefixQuery(Query):
    field: str = ""
    query: Any = None
    slop: int = 0
    max_expansions: int = 50


@dataclass
class MatchBoolPrefixQuery(Query):
    field: str = ""
    query: Any = None
    operator: str = "or"
    max_expansions: int = 50
    minimum_should_match: Optional[str] = None
    analyzer: Optional[str] = None
    fuzziness: Optional[str] = None


@dataclass
class GeoPolygonQuery(Query):
    field: str = ""
    points: list = dc_field(default_factory=list)   # [(lat, lon)]


@dataclass
class RankFeatureQuery(Query):
    """Score by a per-doc feature value (modules/mapper-extras
    RankFeatureQueryBuilder): saturation (default), log, or sigmoid."""

    field: str = ""
    saturation: Optional[dict] = None
    log: Optional[dict] = None
    sigmoid: Optional[dict] = None


@dataclass
class MultiMatchQuery(Query):
    fields: list = dc_field(default_factory=list)   # [(field, boost)]
    query: Any = None
    type: str = "best_fields"        # best_fields | most_fields | phrase
    operator: str = "or"
    tie_breaker: float = 0.0
    minimum_should_match: Optional[str] = None
    lenient: bool = False
    analyzer: Optional[str] = None
    fuzziness: Optional[str] = None


@dataclass
class BoolQuery(Query):
    must: list = dc_field(default_factory=list)
    should: list = dc_field(default_factory=list)
    must_not: list = dc_field(default_factory=list)
    filter: list = dc_field(default_factory=list)
    minimum_should_match: Optional[str] = None


@dataclass
class RangeQuery(Query):
    field: str = ""
    gte: Any = None
    gt: Any = None
    lte: Any = None
    lt: Any = None
    fmt: Optional[str] = None
    time_zone: Optional[str] = None
    lenient: bool = False           # query_string lenient: bad bound -> none


@dataclass
class ExistsQuery(Query):
    field: str = ""


@dataclass
class IdsQuery(Query):
    values: list = dc_field(default_factory=list)


@dataclass
class PrefixQuery(Query):
    field: str = ""
    value: str = ""


@dataclass
class WildcardQuery(Query):
    field: str = ""
    value: str = ""
    case_insensitive: bool = False  # query_string wildcards normalize
    # through the analyzer chain (lowercase); the plain wildcard query
    # is exact unless case_insensitive is set


@dataclass
class RegexpQuery(Query):
    field: str = ""
    value: str = ""


@dataclass
class FuzzyQuery(Query):
    field: str = ""
    value: str = ""
    fuzziness: str = "AUTO"
    prefix_length: int = 0


@dataclass
class ConstantScoreQuery(Query):
    query: Optional[Query] = None


@dataclass
class DisMaxQuery(Query):
    queries: list = dc_field(default_factory=list)
    tie_breaker: float = 0.0


@dataclass
class KnnQuery(Query):
    field: str = ""
    vector: list = dc_field(default_factory=list)
    k: int = 10
    filter: Optional[Query] = None
    # per-request ANN overrides, e.g. {"nprobe": 16} (method_parameters
    # in the opensearch-knn request shape)
    method_parameters: Optional[dict] = None


@dataclass
class PercolateQuery(Query):
    field: str = "query"
    documents: list = dc_field(default_factory=list)   # candidate docs


@dataclass
class NestedQuery(Query):
    path: str = ""
    query: Optional[Query] = None
    score_mode: str = "avg"
    ignore_unmapped: bool = False


@dataclass
class HasChildQuery(Query):
    """Parents with >= min matching children (modules/parent-join/
    HasChildQueryBuilder.java)."""

    type: str = ""
    query: Optional[Query] = None
    score_mode: str = "none"        # none | sum | max | min | avg
    min_children: int = 1
    max_children: Optional[int] = None


@dataclass
class HasParentQuery(Query):
    """Children whose parent matches (HasParentQueryBuilder.java)."""

    parent_type: str = ""
    query: Optional[Query] = None
    score: bool = False


@dataclass
class ParentIdQuery(Query):
    """Children of one specific parent (ParentIdQueryBuilder.java)."""

    type: str = ""
    id: str = ""


@dataclass
class BoostingQuery(Query):
    positive: Optional[Query] = None
    negative: Optional[Query] = None
    negative_boost: float = 0.5


@dataclass
class TermsSetQuery(Query):
    field: str = ""
    terms: list = dc_field(default_factory=list)
    minimum_should_match_field: str = ""


@dataclass
class DistanceFeatureQuery(Query):
    field: str = ""
    origin: object = None
    pivot: object = None


@dataclass
class FunctionScoreQuery(Query):
    query: Optional[Query] = None
    functions: list = dc_field(default_factory=list)   # raw function dicts
    score_mode: str = "multiply"
    boost_mode: str = "multiply"
    max_boost: Optional[float] = None
    min_score: Optional[float] = None


@dataclass
class MoreLikeThisQuery(Query):
    fields: list = dc_field(default_factory=list)
    like: list = dc_field(default_factory=list)        # texts and {_id} docs
    max_query_terms: int = 25
    min_term_freq: int = 2
    min_doc_freq: int = 5
    minimum_should_match: str = "30%"
    include: bool = False          # include the liked docs in results


@dataclass
class GeoDistanceQuery(Query):
    field: str = ""
    lat: float = 0.0
    lon: float = 0.0
    distance: str = "10km"


@dataclass
class GeoBoundingBoxQuery(Query):
    field: str = ""
    top: float = 0.0
    left: float = 0.0
    bottom: float = 0.0
    right: float = 0.0


@dataclass
class HybridQuery(Query):
    """Independent sub-queries whose scores a search pipeline's
    normalization processor combines (the neural-search plugin's hybrid
    query; executes per sub-query, never as one plan)."""

    queries: list = dc_field(default_factory=list)


@dataclass
class SpanTermQuery(Query):
    """Positional term (ref index/query/SpanTermQueryBuilder.java:48)."""

    field: str = ""
    value: Any = None


@dataclass
class SpanNearQuery(Query):
    """Terms within ``slop`` positions of each other (ref
    SpanNearQueryBuilder.java:51)."""

    clauses: list = dc_field(default_factory=list)
    slop: int = 0
    in_order: bool = True


@dataclass
class SpanFirstQuery(Query):
    """Match near the start of the field (ref
    SpanFirstQueryBuilder.java:47)."""

    match: Optional[Query] = None
    end: int = 0


@dataclass
class SpanOrQuery(Query):
    """Union of span clauses (ref SpanOrQueryBuilder.java:46)."""

    clauses: list = dc_field(default_factory=list)


@dataclass
class IntervalsQuery(Query):
    """Interval rules over one field (ref IntervalQueryBuilder.java:43);
    the rule tree is validated/compiled per shard."""

    field: str = ""
    rule: dict = dc_field(default_factory=dict)


@dataclass
class ScriptScoreQuery(Query):
    query: Optional[Query] = None
    script: dict = dc_field(default_factory=dict)
    min_score: Optional[float] = None


@dataclass
class SimpleQueryStringQuery(Query):
    query: str = ""
    fields: list = dc_field(default_factory=list)
    default_operator: str = "or"


def _field_kv(body: dict, qname: str) -> tuple[str, Any]:
    if len(body) != 1:
        raise ParsingError(f"[{qname}] query must reference exactly one field, got {sorted(body)}")
    return next(iter(body.items()))


def _as_list(v) -> list:
    return v if isinstance(v, list) else [v]


def _boost(body) -> float:
    return float(body.get("boost", 1.0)) if isinstance(body, dict) else 1.0


def _parse_fields_with_boosts(fields: list) -> list[tuple[str, float]]:
    out = []
    for f in fields:
        if "^" in f:
            name, _, b = f.partition("^")
            out.append((name, float(b)))
        else:
            out.append((f, 1.0))
    return out


def parse_query(obj: Optional[dict]) -> Query:
    """Parse one query object ``{"<type>": {...}}`` into a Query tree."""
    if obj is None:
        return MatchAllQuery()
    if not isinstance(obj, dict):
        raise ParsingError(f"malformed query, expected an object but got [{obj}]")
    if not obj:
        return MatchAllQuery()
    if len(obj) != 1:
        raise ParsingError(
            f"malformed query, expected one top-level key but got {sorted(obj)}")
    qname, body = next(iter(obj.items()))
    parser = _PARSERS.get(qname)
    if parser is None:
        raise ParsingError(f"unknown query [{qname}]")
    return parser(body)


def _parse_match_all(body):
    return MatchAllQuery(boost=_boost(body))


def _parse_match_none(body):
    return MatchNoneQuery()


def _parse_term(body):
    field, v = _field_kv(body, "term")
    if isinstance(v, dict):
        return TermQuery(field=field, value=v.get("value"), boost=_boost(v))
    return TermQuery(field=field, value=v)


def _parse_terms(body):
    rest = {k: v for k, v in body.items() if k != "boost"}
    field, vals = _field_kv(rest, "terms")
    if not isinstance(vals, list):
        raise ParsingError("[terms] query requires an array of values")
    return TermsQuery(field=field, values=vals, boost=_boost(body))


def _parse_match(body):
    field, v = _field_kv(body, "match")
    if isinstance(v, dict):
        return MatchQuery(
            field=field, query=v.get("query"),
            operator=str(v.get("operator", "or")).lower(),
            minimum_should_match=(
                None if v.get("minimum_should_match") is None
                else str(v.get("minimum_should_match"))),
            fuzziness=v.get("fuzziness"),
            analyzer=v.get("analyzer"),
            boost=_boost(v))
    return MatchQuery(field=field, query=v)


def _parse_match_phrase(body):
    field, v = _field_kv(body, "match_phrase")
    if isinstance(v, dict):
        return MatchPhraseQuery(field=field, query=v.get("query"),
                                slop=int(v.get("slop", 0)), boost=_boost(v))
    return MatchPhraseQuery(field=field, query=v)


def _parse_multi_match(body):
    typ = str(body.get("type", "best_fields"))
    tie = body.get("tie_breaker")
    return MultiMatchQuery(
        fields=_parse_fields_with_boosts(body.get("fields", [])),
        query=body.get("query"),
        type=typ,
        operator=str(body.get("operator", "or")).lower(),
        tie_breaker=float(tie) if tie is not None else (1.0 if typ == "most_fields" else 0.0),
        minimum_should_match=(
            None if body.get("minimum_should_match") is None
            else str(body.get("minimum_should_match"))),
        analyzer=body.get("analyzer"),
        fuzziness=(None if body.get("fuzziness") is None
                   else str(body.get("fuzziness"))),
        boost=_boost(body))


def _parse_bool(body):
    msm = body.get("minimum_should_match")
    return BoolQuery(
        must=[parse_query(q) for q in _as_list(body.get("must", []))],
        should=[parse_query(q) for q in _as_list(body.get("should", []))],
        must_not=[parse_query(q) for q in _as_list(body.get("must_not", []))],
        filter=[parse_query(q) for q in _as_list(body.get("filter", []))],
        minimum_should_match=None if msm is None else str(msm),
        boost=_boost(body))


def _parse_range(body):
    field, v = _field_kv(body, "range")
    if not isinstance(v, dict):
        raise ParsingError("[range] query requires bounds object")
    known = {"gte", "gt", "lte", "lt", "from", "to", "include_lower",
             "include_upper", "boost", "format", "time_zone", "relation"}
    unknown = set(v) - known
    if unknown:
        raise ParsingError(f"[range] query does not support {sorted(unknown)}")
    gte, gt, lte, lt = v.get("gte"), v.get("gt"), v.get("lte"), v.get("lt")
    # legacy from/to form
    if "from" in v:
        if v.get("include_lower", True):
            gte = v["from"]
        else:
            gt = v["from"]
    if "to" in v:
        if v.get("include_upper", True):
            lte = v["to"]
        else:
            lt = v["to"]
    return RangeQuery(field=field, gte=gte, gt=gt, lte=lte, lt=lt,
                      fmt=v.get("format"), time_zone=v.get("time_zone"),
                      boost=_boost(v))


def _parse_exists(body):
    return ExistsQuery(field=body["field"], boost=_boost(body))


def _parse_ids(body):
    return IdsQuery(values=list(body.get("values", [])), boost=_boost(body))


def _term_like(cls, qname):
    def parse(body):
        field, v = _field_kv(body, qname)
        if isinstance(v, dict):
            return cls(field=field, value=v.get("value"), boost=_boost(v))
        return cls(field=field, value=v)
    return parse


def _parse_fuzzy(body):
    field, v = _field_kv(body, "fuzzy")
    if isinstance(v, dict):
        return FuzzyQuery(field=field, value=str(v.get("value")),
                          fuzziness=str(v.get("fuzziness", "AUTO")),
                          prefix_length=int(v.get("prefix_length", 0)),
                          boost=_boost(v))
    return FuzzyQuery(field=field, value=str(v))


def _parse_constant_score(body):
    return ConstantScoreQuery(query=parse_query(body.get("filter")), boost=_boost(body))


def _parse_dis_max(body):
    return DisMaxQuery(queries=[parse_query(q) for q in body.get("queries", [])],
                       tie_breaker=float(body.get("tie_breaker", 0.0)),
                       boost=_boost(body))


def _parse_knn(body):
    # Accept both the opensearch-knn plugin shape {field: {vector, k}} and a
    # flat {field, query_vector, k} shape.
    if "field" in body and ("query_vector" in body or "vector" in body):
        return KnnQuery(field=body["field"],
                        vector=list(body.get("query_vector") or body.get("vector")),
                        k=int(body.get("k", 10)),
                        filter=parse_query(body["filter"]) if body.get("filter") else None,
                        method_parameters=body.get("method_parameters"),
                        boost=_boost(body))
    field, v = _field_kv({k: v for k, v in body.items() if k != "boost"}, "knn")
    return KnnQuery(field=field, vector=list(v["vector"]), k=int(v.get("k", 10)),
                    filter=parse_query(v["filter"]) if v.get("filter") else None,
                    method_parameters=v.get("method_parameters"),
                    boost=_boost(v))


def parse_geo_point(v) -> tuple[float, float]:
    """(lat, lon) from the accepted geo shapes: {lat, lon}, [lon, lat],
    "lat,lon"."""
    if isinstance(v, dict):
        return float(v["lat"]), float(v["lon"])
    if isinstance(v, (list, tuple)) and len(v) == 2:
        return float(v[1]), float(v[0])            # GeoJSON order
    if isinstance(v, str) and "," in v:
        lat, _, lon = v.partition(",")
        return float(lat), float(lon)
    raise ParsingError(f"malformed geo point [{v!r}]")


_DIST_UNITS = {"mm": 0.001, "cm": 0.01, "m": 1.0, "km": 1000.0,
               "in": 0.0254, "ft": 0.3048, "yd": 0.9144,
               "mi": 1609.344, "nmi": 1852.0, "nauticalmiles": 1852.0,
               "kilometers": 1000.0, "meters": 1.0, "miles": 1609.344}


def parse_distance_m(v) -> float:
    """Distance expression -> meters ("10km", "5mi", bare number=m)."""
    if isinstance(v, (int, float)):
        return float(v)
    s = str(v).strip().lower()
    for unit in sorted(_DIST_UNITS, key=len, reverse=True):
        if s.endswith(unit):
            return float(s[: -len(unit)]) * _DIST_UNITS[unit]
    try:
        return float(s)
    except ValueError:
        raise ParsingError(f"failed to parse distance [{v}]") from None


def _parse_percolate(body):
    docs = body.get("documents")
    if docs is None and body.get("document") is not None:
        docs = [body["document"]]
    if not docs:
        raise ParsingError(
            "[percolate] requires [document] or [documents]")
    if not all(isinstance(d, dict) for d in docs):
        raise ParsingError(
            "[percolate] documents must be JSON objects")
    return PercolateQuery(field=str(body.get("field", "query")),
                          documents=list(docs), boost=_boost(body))


def _parse_match_phrase_prefix(body):
    field, v = _field_kv(body, "match_phrase_prefix")
    if isinstance(v, dict):
        return MatchPhrasePrefixQuery(
            field=field, query=v.get("query"),
            slop=int(v.get("slop", 0)),
            max_expansions=int(v.get("max_expansions", 50)),
            boost=_boost(v))
    return MatchPhrasePrefixQuery(field=field, query=v)


def _parse_match_bool_prefix(body):
    field, v = _field_kv(body, "match_bool_prefix")
    if isinstance(v, dict):
        return MatchBoolPrefixQuery(
            field=field, query=v.get("query"),
            operator=str(v.get("operator", "or")).lower(),
            max_expansions=int(v.get("max_expansions", 50)),
            minimum_should_match=v.get("minimum_should_match"),
            analyzer=v.get("analyzer"),
            fuzziness=(None if v.get("fuzziness") is None
                       else str(v.get("fuzziness"))),
            boost=_boost(v))
    return MatchBoolPrefixQuery(field=field, query=v)


def _parse_wrapper(body):
    """wrapper: {query: <base64 of a JSON query>} — decodes and parses
    inline (WrapperQueryBuilder)."""
    import base64
    import json as _json

    raw = body.get("query")
    if raw is None:
        raise ParsingError("[wrapper] requires [query]")
    try:
        inner = _json.loads(base64.b64decode(raw))
    except Exception as e:  # noqa: BLE001 — any malformed payload is a 400
        raise ParsingError(f"[wrapper] cannot decode query: {e}") from None
    return parse_query(inner)


def _parse_geo_polygon(body):
    field = next((k for k in body if k not in ("boost", "_name",
                                               "validation_method")), None)
    if field is None or not isinstance(body[field], dict):
        raise ParsingError("[geo_polygon] requires a field with [points]")
    pts = body[field].get("points")
    if not pts or len(pts) < 3:
        raise ParsingError("[geo_polygon] requires at least 3 [points]")
    points = []
    for p in pts:
        try:
            if isinstance(p, dict):
                points.append((float(p["lat"]), float(p["lon"])))
            elif isinstance(p, (list, tuple)):
                points.append((float(p[1]), float(p[0])))   # [lon, lat]
            elif isinstance(p, str) and "," in p:
                lat, _, lon = p.partition(",")
                points.append((float(lat), float(lon)))
            else:
                raise ParsingError(
                    f"[geo_polygon] malformed point {p!r} (lat/lon "
                    "object, [lon, lat] array, or 'lat,lon' string; "
                    "geohash points are not supported)")
        except ParsingError:
            raise
        except (KeyError, ValueError, TypeError, IndexError) as e:
            raise ParsingError(
                f"[geo_polygon] malformed point {p!r}: {e}") from None
    return GeoPolygonQuery(field=field, points=points, boost=_boost(body))


def _parse_rank_feature(body):
    field = body.get("field")
    if not field:
        raise ParsingError("[rank_feature] requires [field]")
    return RankFeatureQuery(field=str(field),
                            saturation=body.get("saturation"),
                            log=body.get("log"),
                            sigmoid=body.get("sigmoid"),
                            boost=_boost(body))


def _parse_has_child(body):
    if not body.get("type") or body.get("query") is None:
        raise ParsingError("[has_child] requires [type] and [query]")
    mx = body.get("max_children")
    return HasChildQuery(type=str(body["type"]),
                         query=parse_query(body["query"]),
                         score_mode=str(body.get("score_mode", "none")),
                         min_children=int(body.get("min_children", 1)),
                         max_children=None if mx is None else int(mx),
                         boost=_boost(body))


def _parse_has_parent(body):
    if not body.get("parent_type") or body.get("query") is None:
        raise ParsingError("[has_parent] requires [parent_type] and "
                           "[query]")
    return HasParentQuery(parent_type=str(body["parent_type"]),
                          query=parse_query(body["query"]),
                          score=bool(body.get("score", False)),
                          boost=_boost(body))


def _parse_parent_id(body):
    if not body.get("type") or body.get("id") is None:
        raise ParsingError("[parent_id] requires [type] and [id]")
    return ParentIdQuery(type=str(body["type"]), id=str(body["id"]),
                         boost=_boost(body))


def _parse_nested(body):
    if not body.get("path") or body.get("query") is None:
        raise ParsingError("[nested] requires [path] and [query]")
    return NestedQuery(path=str(body["path"]),
                       query=parse_query(body["query"]),
                       score_mode=str(body.get("score_mode", "avg")),
                       ignore_unmapped=bool(body.get("ignore_unmapped",
                                                     False)),
                       boost=_boost(body))


def _parse_boosting(body):
    if body.get("positive") is None or body.get("negative") is None:
        raise ParsingError(
            "[boosting] requires [positive] and [negative] clauses")
    return BoostingQuery(positive=parse_query(body["positive"]),
                         negative=parse_query(body["negative"]),
                         negative_boost=float(
                             body.get("negative_boost", 0.5)),
                         boost=_boost(body))


def _parse_terms_set(body):
    field, v = _field_kv({k: x for k, x in body.items() if k != "boost"},
                         "terms_set")
    msm = v.get("minimum_should_match_field")
    if not msm:
        raise ParsingError(
            "[terms_set] requires [minimum_should_match_field]")
    return TermsSetQuery(field=field, terms=list(v.get("terms") or []),
                         minimum_should_match_field=msm, boost=_boost(v))


def _parse_distance_feature(body):
    for key in ("field", "origin", "pivot"):
        if body.get(key) is None:
            raise ParsingError(f"[distance_feature] requires [{key}]")
    return DistanceFeatureQuery(field=body["field"], origin=body["origin"],
                                pivot=body["pivot"], boost=_boost(body))


_FUNCTION_KEYS = ("weight", "field_value_factor", "random_score",
                  "script_score", "gauss", "exp", "linear")


def _parse_function_score(body):
    functions = list(body.get("functions") or [])
    # single-function shorthand at the top level
    shorthand = {k: body[k] for k in _FUNCTION_KEYS if k in body}
    if shorthand:
        functions.append(shorthand)
    q = parse_query(body.get("query")) if body.get("query") else None
    return FunctionScoreQuery(
        query=q, functions=functions,
        score_mode=str(body.get("score_mode", "multiply")),
        boost_mode=str(body.get("boost_mode", "multiply")),
        max_boost=(float(body["max_boost"])
                   if body.get("max_boost") is not None else None),
        min_score=(float(body["min_score"])
                   if body.get("min_score") is not None else None),
        boost=_boost(body))


def _parse_more_like_this(body):
    like = body.get("like")
    if like is None:
        raise ParsingError("[more_like_this] requires [like]")
    if not isinstance(like, list):
        like = [like]
    return MoreLikeThisQuery(
        fields=list(body.get("fields") or []),
        like=like,
        max_query_terms=int(body.get("max_query_terms", 25)),
        min_term_freq=int(body.get("min_term_freq", 2)),
        min_doc_freq=int(body.get("min_doc_freq", 5)),
        minimum_should_match=str(body.get("minimum_should_match", "30%")),
        include=bool(body.get("include", False)),
        boost=_boost(body))


def _parse_geo_distance(body):
    dist = body.get("distance")
    if dist is None:
        raise ParsingError("[geo_distance] requires [distance]")
    field = next((k for k in body
                  if k not in ("distance", "boost", "distance_type",
                               "validation_method", "_name")), None)
    if field is None:
        raise ParsingError("[geo_distance] requires a field")
    lat, lon = parse_geo_point(body[field])
    parse_distance_m(dist)                  # validate eagerly
    return GeoDistanceQuery(field=field, lat=lat, lon=lon,
                            distance=dist, boost=_boost(body))


def _parse_geo_bounding_box(body):
    field = next((k for k in body
                  if k not in ("boost", "validation_method", "type",
                               "_name")), None)
    if field is None:
        raise ParsingError("[geo_bounding_box] requires a field")
    v = body[field]
    if "top_left" in v and "bottom_right" in v:
        top, left = parse_geo_point(v["top_left"])
        bottom, right = parse_geo_point(v["bottom_right"])
    else:
        top, left = float(v["top"]), float(v["left"])
        bottom, right = float(v["bottom"]), float(v["right"])
    if bottom > top:
        raise ParsingError(
            "[geo_bounding_box] top must be >= bottom")
    return GeoBoundingBoxQuery(field=field, top=top, left=left,
                               bottom=bottom, right=right,
                               boost=_boost(body))


# -- query_string ------------------------------------------------------------


_QS_TOKEN = re.compile(
    r"""\s*(?:
        (?P<lparen>\()|(?P<rparen>\))|
        (?P<and>AND\b|&&)|(?P<or>OR\b|\|\|)|(?P<not>NOT\b|!)|
        (?P<plus>\+)|(?P<minus>-)|
        (?P<quoted>"(?P<qbody>[^"]*)")|
        (?P<range>[\[{][^\]}]+(?:[\]}]))|
        (?P<word>[^\s()\[\]{}"]+)
    )""", re.VERBOSE)


def _qs_tokens(s: str):
    pos = 0
    out = []
    while pos < len(s):
        m = _QS_TOKEN.match(s, pos)
        if m is None or m.end() == pos:
            if s[pos:].strip():
                raise ParsingError(
                    f"query_string: cannot parse "
                    f"[{s[pos:].strip()[:40]}] — unbalanced quote or "
                    "stray bracket?")
            break
        out.append(m)
        pos = m.end()
    return out


class _QsParser:
    """Recursive-descent parser for the practical query_string subset:
    AND/OR/NOT (&&/||/!), +/-, parentheses, field:value, quoted phrases,
    wildcards, [a TO b]/{a TO b} ranges (QueryStringQueryBuilder's
    everyday surface; the exotic tail — fuzzy slop, boost suffixes,
    regex — parses as plain terms)."""

    def __init__(self, tokens, fields, default_operator):
        self.toks = tokens
        self.i = 0
        self.fields = fields
        self.default_and = default_operator == "and"

    def peek(self, name=None):
        if self.i >= len(self.toks):
            return None
        if name is None:
            return self.toks[self.i]
        return self.toks[self.i] if self.toks[self.i].group(name) else None

    def parse(self):
        q = self.or_expr()
        if self.i < len(self.toks):
            raise ParsingError(
                f"query_string: unexpected token "
                f"[{self.toks[self.i].group(0).strip()}]")
        return q or MatchAllQuery()

    def or_expr(self):
        parts = [self.and_expr()]
        while self.peek("or"):
            self.i += 1
            parts.append(self.and_expr())
        parts = [p for p in parts if p is not None]
        if len(parts) <= 1:
            return parts[0] if parts else None
        return BoolQuery(should=parts)

    def and_expr(self):
        must, must_not, should = [], [], []
        explicit_and = False
        while True:
            if self.peek("and"):
                self.i += 1
                explicit_and = True
                continue
            if self.peek("or") or self.peek("rparen") or \
                    self.peek() is None:
                break
            negate = False
            required = False
            if self.peek("not") or self.peek("minus"):
                self.i += 1
                negate = True
            elif self.peek("plus"):
                self.i += 1
                required = True
            clause = self.primary()
            if clause is None:
                break
            if negate:
                must_not.append(clause)
            elif required or self.default_and or explicit_and:
                must.append(clause)
            else:
                should.append(clause)
        if explicit_and or self.default_and:
            must.extend(should)
            should = []
        if not must and not must_not and len(should) == 1:
            return should[0]
        if not must and not must_not and not should:
            return None
        return BoolQuery(must=must, must_not=must_not, should=should)

    def primary(self):
        tok = self.peek()
        if tok is None:
            return None
        if tok.group("lparen"):
            self.i += 1
            inner = self.or_expr()
            if not self.peek("rparen"):
                raise ParsingError("query_string: unbalanced parentheses")
            self.i += 1
            return inner
        if tok.group("quoted") is not None:
            self.i += 1
            return self._text_clause(tok.group("qbody"), phrase=True)
        if tok.group("word"):
            word = tok.group("word")
            self.i += 1
            if word.endswith(":"):          # field: followed by ( or "
                field = word[:-1]
                return self._fielded(field)
            if ":" in word:
                field, _, value = word.partition(":")
                return self._value_clause(field, value)
            return self._text_clause(word, phrase=False)
        if tok.group("range"):
            raise ParsingError(
                "query_string: a range requires a field (field:[a TO b])")
        return None

    def _fielded(self, field):
        tok = self.peek()
        if tok is None:
            raise ParsingError(
                f"query_string: dangling field [{field}:]")
        if tok.group("quoted") is not None:
            self.i += 1
            return MatchPhraseQuery(field=field, query=tok.group("qbody"))
        if tok.group("range"):
            self.i += 1
            return self._range_clause(field, tok.group("range"))
        if tok.group("lparen"):
            self.i += 1
            inner = self.or_expr()
            if not self.peek("rparen"):
                raise ParsingError("query_string: unbalanced parentheses")
            self.i += 1
            return _rewrite_default_field(inner, field)
        if tok.group("word"):
            self.i += 1
            return self._value_clause(field, tok.group("word"))
        raise ParsingError(f"query_string: bad value for [{field}]")

    def _range_clause(self, field, raw):
        inc_lo = raw[0] == "["
        inc_hi = raw[-1] == "]"
        body = raw[1:-1]
        lo, _, hi = body.partition(" TO ")
        if not _:
            raise ParsingError(
                f"query_string: malformed range [{raw}]")
        params = {}
        if lo.strip() not in ("*", ""):
            params["gte" if inc_lo else "gt"] = lo.strip()
        if hi.strip() not in ("*", ""):
            params["lte" if inc_hi else "lt"] = hi.strip()
        return RangeQuery(field=field, **params)

    def _value_clause(self, field, value):
        if "*" in value or "?" in value:
            return WildcardQuery(field=field, value=value,
                                 case_insensitive=True)
        return MatchQuery(field=field, query=value)

    def _text_clause(self, text, phrase):
        if len(self.fields) == 1 and self.fields[0][0] != "*":
            f, fboost = self.fields[0]
            q = (MatchPhraseQuery(field=f, query=text) if phrase
                 else self._value_clause(f, text))
            q.boost = q.boost * fboost
            return q
        return MultiMatchQuery(fields=list(self.fields), query=text,
                               type="phrase" if phrase else "best_fields")


def _rewrite_default_field(q, field):
    """Apply field:(...) grouping: rewrite default-field clauses inside."""
    if isinstance(q, BoolQuery):
        return BoolQuery(
            must=[_rewrite_default_field(c, field) for c in q.must],
            should=[_rewrite_default_field(c, field) for c in q.should],
            must_not=[_rewrite_default_field(c, field)
                      for c in q.must_not],
            filter=[_rewrite_default_field(c, field) for c in q.filter],
            boost=q.boost)
    if isinstance(q, MultiMatchQuery):
        if q.type == "phrase":
            return MatchPhraseQuery(field=field, query=q.query)
        if "*" in q.query or "?" in q.query:
            return WildcardQuery(field=field, value=q.query,
                                 case_insensitive=True)
        return MatchQuery(field=field, query=q.query)
    return q


def _parse_query_string(body):
    text = body.get("query")
    if text is None:
        raise ParsingError("[query_string] requires [query]")
    fields = body.get("fields")
    if not fields:
        df = body.get("default_field", "*")
        fields = [df]
    fields = _parse_fields_with_boosts(fields)   # keep ^boost suffixes
    op = str(body.get("default_operator", "or")).lower()
    q = _QsParser(_qs_tokens(str(text)), fields, op).parse()
    if body.get("lenient"):
        _mark_lenient(q)
    b = _boost(body)
    if b != 1.0:
        q.boost = q.boost * b
    return q


def _mark_lenient(q):
    """lenient=true: type-mismatch clauses match nothing instead of
    erroring (QueryStringQueryParser.setLenient)."""
    if isinstance(q, (MatchQuery, MultiMatchQuery, RangeQuery)):
        q.lenient = True
    elif isinstance(q, BoolQuery):
        for group in (q.must, q.should, q.must_not, q.filter):
            for c in group:
                _mark_lenient(c)


def _parse_hybrid(body):
    qs = body.get("queries")
    if not isinstance(qs, list) or not qs:
        raise ParsingError("[hybrid] query requires a [queries] array")
    if len(qs) > 5:
        raise ParsingError("[hybrid] supports at most 5 sub-queries")
    return HybridQuery(queries=[parse_query(q) for q in qs],
                       boost=_boost(body))


def _parse_script_score(body):
    ms = body.get("min_score")
    return ScriptScoreQuery(query=parse_query(body.get("query")),
                            script=body.get("script", {}),
                            min_score=float(ms) if ms is not None else None,
                            boost=_boost(body))


def _parse_span_term(body):
    field, v = _field_kv(body, "span_term")
    if isinstance(v, dict):
        return SpanTermQuery(field=field, value=v.get("value"),
                             boost=float(v.get("boost", 1.0)))
    return SpanTermQuery(field=field, value=v)


def _parse_span_near(body):
    clauses = [parse_query(c) for c in body.get("clauses") or []]
    if not clauses:
        raise ParsingError("[span_near] requires [clauses]")
    return SpanNearQuery(clauses=clauses,
                         slop=int(body.get("slop", 0)),
                         in_order=bool(body.get("in_order", True)),
                         boost=_boost(body))


def _parse_span_first(body):
    if "match" not in body or "end" not in body:
        raise ParsingError("[span_first] requires [match] and [end]")
    return SpanFirstQuery(match=parse_query(body["match"]),
                          end=int(body["end"]), boost=_boost(body))


def _parse_span_or(body):
    clauses = [parse_query(c) for c in body.get("clauses") or []]
    if not clauses:
        raise ParsingError("[span_or] requires [clauses]")
    return SpanOrQuery(clauses=clauses, boost=_boost(body))


def _parse_intervals(body):
    field, rule = _field_kv(body, "intervals")
    if not isinstance(rule, dict) or len(rule) == 0:
        raise ParsingError(f"[intervals] on [{field}] requires a rule")
    return IntervalsQuery(field=field, rule=rule)


def _parse_simple_query_string(body):
    return SimpleQueryStringQuery(
        query=str(body.get("query", "")),
        fields=_parse_fields_with_boosts(body.get("fields", ["*"])),
        default_operator=str(body.get("default_operator", "or")).lower(),
        boost=_boost(body))


_PARSERS = {
    "match_all": _parse_match_all,
    "match_none": _parse_match_none,
    "term": _parse_term,
    "terms": _parse_terms,
    "match": _parse_match,
    "match_phrase": _parse_match_phrase,
    "multi_match": _parse_multi_match,
    "bool": _parse_bool,
    "range": _parse_range,
    "exists": _parse_exists,
    "ids": _parse_ids,
    "has_child": _parse_has_child,
    "has_parent": _parse_has_parent,
    "parent_id": _parse_parent_id,
    "match_phrase_prefix": _parse_match_phrase_prefix,
    "match_bool_prefix": _parse_match_bool_prefix,
    "wrapper": _parse_wrapper,
    "geo_polygon": _parse_geo_polygon,
    "rank_feature": _parse_rank_feature,
    "prefix": _term_like(PrefixQuery, "prefix"),
    "wildcard": _term_like(WildcardQuery, "wildcard"),
    "regexp": _term_like(RegexpQuery, "regexp"),
    "fuzzy": _parse_fuzzy,
    "constant_score": _parse_constant_score,
    "dis_max": _parse_dis_max,
    "knn": _parse_knn,
    "script_score": _parse_script_score,
    "hybrid": _parse_hybrid,
    "boosting": _parse_boosting,
    "nested": _parse_nested,
    "percolate": _parse_percolate,
    "terms_set": _parse_terms_set,
    "distance_feature": _parse_distance_feature,
    "function_score": _parse_function_score,
    "more_like_this": _parse_more_like_this,
    "geo_distance": _parse_geo_distance,
    "geo_bounding_box": _parse_geo_bounding_box,
    "query_string": _parse_query_string,
    "simple_query_string": _parse_simple_query_string,
    "span_term": _parse_span_term,
    "span_near": _parse_span_near,
    "span_first": _parse_span_first,
    "span_or": _parse_span_or,
    "intervals": _parse_intervals,
}
