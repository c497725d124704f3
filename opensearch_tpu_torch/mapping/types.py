"""Field types: how a JSON value becomes index terms + doc-value columns and
how query-time literals are converted for comparison.

Analog of the reference's MappedFieldType hierarchy
(index/mapper/MappedFieldType.java and the ~30 concrete mappers in
index/mapper/).  The TPU twist: every field type declares which *columnar*
representation its doc values take (int64 / float64 / ordinal), because
filters, sorts and aggregations execute as dense vectorized ops over those
columns on device, not via per-doc iterators.

Doc-value column kinds:
- ``long``    -> int64 column (longs, dates as epoch millis, booleans as 0/1, ips)
- ``double``  -> float64 column
- ``ordinal`` -> int32 ordinal column + per-segment sorted term dict (keywords)
- ``none``    -> no column (text fields: inverted index only, like Lucene
                 text fields without fielddata)
"""

from __future__ import annotations

import datetime as _dt
import ipaddress
import math
from typing import Any, Optional

from opensearch_tpu_torch.common.errors import IllegalArgumentError, MapperParsingError


def parse_date_millis(value: Any) -> int:
    """Parse a date literal to epoch millis.

    Supports epoch_millis (int), ISO-8601 date/date-time (the reference's
    default ``strict_date_optional_time||epoch_millis`` format,
    index/mapper/DateFieldMapper.java), and date-only strings.
    """
    if isinstance(value, bool):
        raise MapperParsingError(f"cannot parse date from boolean [{value}]")
    if isinstance(value, (int, float)):
        return int(value)
    s = str(value).strip()
    if s.isdigit() or (s.startswith("-") and s[1:].isdigit()):
        return int(s)
    txt = s.replace("Z", "+00:00")
    try:
        if "T" in txt or " " in txt:
            dt = _dt.datetime.fromisoformat(txt)
        else:
            dt = _dt.datetime.fromisoformat(txt + "T00:00:00")
    except ValueError as e:
        raise MapperParsingError(f"failed to parse date field [{value}]") from e
    if dt.tzinfo is None:
        dt = dt.replace(tzinfo=_dt.timezone.utc)
    return int(dt.timestamp() * 1000)


def format_date_millis(millis: int) -> str:
    dt = _dt.datetime.fromtimestamp(millis / 1000.0, tz=_dt.timezone.utc)
    return dt.strftime("%Y-%m-%dT%H:%M:%S.") + f"{dt.microsecond // 1000:03d}Z"


def parse_ip_long(value: Any) -> int:
    """IPs are stored as a single int64 doc value with an
    order-preserving encoding: every v4 address sits in the negative
    range (``int(addr) - 2^32``), every v6 address in the non-negative
    one, so v4 < ``::`` < the whole v6 space and each family keeps its
    natural order.  The 128-bit v6 form is monotone-compressed: values
    below 2^49 (the low v6 space, including v4-mapped ``::ffff:0:0/96``
    literals) keep full precision; higher v6 addresses keep their top
    62 bits (range comparisons there are coarse — exact term matches
    ride the inverted index, which keeps the canonical string)."""
    addr = ipaddress.ip_address(str(value))
    if addr.version == 4:
        return int(addr) - (1 << 32)
    v = int(addr)
    if v < (1 << 49):
        return v
    return (1 << 49) + (v >> 66)


_LONG_RANGE = {
    "long": (-(2**63), 2**63 - 1),
    "integer": (-(2**31), 2**31 - 1),
    "short": (-(2**15), 2**15 - 1),
    "byte": (-128, 127),
}


class FieldType:
    """Base field type.  Subclasses override the class attrs + converters."""

    type_name = "base"
    dv_kind = "none"  # long | double | ordinal | none
    indexed = True  # produces inverted-index terms

    def __init__(self, name: str, params: Optional[dict] = None):
        self.name = name
        self.params = params or {}
        self.boost = float(self.params.get("boost", 1.0))
        self.doc_values_enabled = bool(self.params.get("doc_values", True))
        self.index_enabled = bool(self.params.get("index", True))
        self.store = bool(self.params.get("store", False))

    # --- indexing --------------------------------------------------------

    def index_terms(self, value: Any, analyzers) -> list[tuple[str, int]]:
        """Value -> [(term, position)] for the inverted index."""
        raise NotImplementedError

    def doc_value(self, value: Any):
        """Value -> column scalar (int for long-kind, float for double-kind,
        str for ordinal-kind)."""
        return None

    # --- query time ------------------------------------------------------

    def term_for_query(self, value: Any) -> str:
        """Literal in a term query -> indexed term string."""
        return str(value)

    def range_bound(self, value: Any):
        """Literal in a range query -> comparable column scalar."""
        raise IllegalArgumentError(f"field [{self.name}] of type [{self.type_name}] does not support range queries")

    def to_mapping(self) -> dict:
        return {"type": self.type_name, **{k: v for k, v in self.params.items()}}


class TextFieldType(FieldType):
    type_name = "text"
    dv_kind = "none"

    def __init__(self, name, params=None):
        super().__init__(name, params)
        self.analyzer_name = self.params.get("analyzer", "standard")
        self.search_analyzer_name = self.params.get("search_analyzer", self.analyzer_name)

    def index_terms(self, value, analyzers):
        if value is None:
            return []
        analyzer = analyzers.get(self.analyzer_name)
        return [(t.term, t.position) for t in analyzer.analyze(str(value))]

    def search_terms(self, value, analyzers) -> list[str]:
        analyzer = analyzers.get(self.search_analyzer_name)
        return analyzer.terms(str(value))


class KeywordFieldType(FieldType):
    type_name = "keyword"
    dv_kind = "ordinal"

    def __init__(self, name, params=None):
        super().__init__(name, params)
        self.ignore_above = int(self.params.get("ignore_above", 2**31 - 1))

    def index_terms(self, value, analyzers):
        if value is None:
            return []
        s = str(value)
        if len(s) > self.ignore_above:
            return []
        return [(s, 0)]

    def doc_value(self, value):
        if value is None:
            return None
        s = str(value)
        return None if len(s) > self.ignore_above else s

    def range_bound(self, value):
        return str(value)


class _NumericFieldType(FieldType):
    def _coerce(self, value):
        raise NotImplementedError

    def index_terms(self, value, analyzers):
        # Numerics are matched via doc-value columns (the Lucene points
        # analog), not postings; term/terms queries on them compare columns.
        return []

    def doc_value(self, value):
        return None if value is None else self._coerce(value)

    def term_for_query(self, value):
        return self._coerce(value)

    def range_bound(self, value):
        return self._coerce(value)


class LongFieldType(_NumericFieldType):
    type_name = "long"
    dv_kind = "long"

    def _coerce(self, value):
        if isinstance(value, bool):
            raise MapperParsingError(f"cannot coerce boolean to [{self.type_name}] for field [{self.name}]")
        try:
            f = float(value)
        except (TypeError, ValueError) as e:
            raise MapperParsingError(f"failed to parse field [{self.name}] of type [{self.type_name}]: [{value}]") from e
        if math.isnan(f) or math.isinf(f):
            raise MapperParsingError(f"[{self.name}] cannot index [{value}]")
        v = int(f)
        lo, hi = _LONG_RANGE.get(self.type_name, _LONG_RANGE["long"])
        if not (lo <= v <= hi):
            raise MapperParsingError(f"value [{value}] out of range for [{self.type_name}] field [{self.name}]")
        return v


class IntegerFieldType(LongFieldType):
    type_name = "integer"


class ShortFieldType(LongFieldType):
    type_name = "short"


class ByteFieldType(LongFieldType):
    type_name = "byte"


class DoubleFieldType(_NumericFieldType):
    type_name = "double"
    dv_kind = "double"

    def _coerce(self, value):
        if isinstance(value, bool):
            raise MapperParsingError(f"cannot coerce boolean to [{self.type_name}] for field [{self.name}]")
        try:
            return float(value)
        except (TypeError, ValueError) as e:
            raise MapperParsingError(f"failed to parse field [{self.name}] of type [{self.type_name}]: [{value}]") from e


class FloatFieldType(DoubleFieldType):
    type_name = "float"


class HalfFloatFieldType(DoubleFieldType):
    type_name = "half_float"


class ScaledFloatFieldType(_NumericFieldType):
    """reference: modules/mapper-extras ScaledFloatFieldMapper — stored as
    long = round(value * scaling_factor)."""

    type_name = "scaled_float"
    dv_kind = "long"

    def __init__(self, name, params=None):
        super().__init__(name, params)
        self.scaling_factor = float(self.params.get("scaling_factor", 1.0))

    def _coerce(self, value):
        return round(float(value) * self.scaling_factor)


class BooleanFieldType(FieldType):
    type_name = "boolean"
    dv_kind = "long"

    def _coerce(self, value) -> int:
        if isinstance(value, bool):
            return int(value)
        s = str(value).strip().lower()
        if s == "true":
            return 1
        if s in ("false", ""):
            return 0
        raise MapperParsingError(f"failed to parse boolean field [{self.name}]: [{value}]")

    def index_terms(self, value, analyzers):
        if value is None:
            return []
        return [("T" if self._coerce(value) else "F", 0)]

    def doc_value(self, value):
        return None if value is None else self._coerce(value)

    def term_for_query(self, value):
        return "T" if self._coerce(value) else "F"

    def range_bound(self, value):
        return self._coerce(value)


class DateFieldType(FieldType):
    type_name = "date"
    dv_kind = "long"

    def _parse(self, value):
        fmt = str(self.params.get("format", ""))
        if "epoch_second" in fmt and isinstance(value, (int, float)) \
                or "epoch_second" in fmt and str(value).lstrip(
                    "-").isdigit():
            return int(float(value) * 1000)
        return parse_date_millis(value)

    def index_terms(self, value, analyzers):
        return []

    def doc_value(self, value):
        return None if value is None else self._parse(value)

    def term_for_query(self, value):
        return self._parse(value)

    def range_bound(self, value):
        return self._parse(value)


class IpFieldType(FieldType):
    type_name = "ip"
    dv_kind = "long"

    def index_terms(self, value, analyzers):
        if value is None:
            return []
        return [(str(ipaddress.ip_address(str(value))), 0)]

    def doc_value(self, value):
        return None if value is None else parse_ip_long(value)

    def range_bound(self, value):
        # CIDR bounds are handled by the query layer expanding to a range.
        return parse_ip_long(value)


class DenseVectorFieldType(FieldType):
    """k-NN vector field (the out-of-tree opensearch-knn plugin's
    ``knn_vector``; we accept both ``dense_vector`` and ``knn_vector``)."""

    type_name = "dense_vector"
    dv_kind = "vector"
    indexed = False

    def __init__(self, name, params=None):
        super().__init__(name, params)
        self.dims = int(self.params.get("dims") or self.params.get("dimension") or 0)
        if self.dims <= 0:
            raise MapperParsingError(f"dense_vector field [{name}] requires [dims]")
        # space_type may live at the top level (newer knn_vector
        # mappings) or inside [method] (the opensearch-knn plugin's
        # historical shape) — honor both, top level winning
        space = (self.params.get("space_type")
                 or self.params.get("similarity")
                 or (self.params.get("method") or {}).get("space_type")
                 or "l2")
        self.space_type = {"l2_norm": "l2", "dot_product": "innerproduct", "cosine": "cosinesimil"}.get(space, space)
        # ANN method definition (the opensearch-knn plugin's mapping shape:
        # {"name": "ivf"|"ivf_pq", "parameters": {nlist, nprobe, m}});
        # absent -> exact brute force
        method = self.params.get("method")
        if method is not None:
            name = (method.get("name") or "").lower()
            if name not in ("ivf", "ivf_pq", "flat", "exact"):
                raise MapperParsingError(
                    f"unknown knn method [{name}] for field "
                    f"[{self.name}] — supported: ivf, ivf_pq, flat")
            self.method = {"name": name,
                           **(method.get("parameters") or {})}
            if name == "ivf_pq":
                m = int(self.method.get("m", 8))
                if m <= 0 or self.dims % m != 0:
                    raise MapperParsingError(
                        f"ivf_pq [m]=[{m}] must divide [dims]="
                        f"[{self.dims}] for field [{self.name}]")
        else:
            self.method = None

    def index_terms(self, value, analyzers):
        return []

    def doc_value(self, value):
        if value is None:
            return None
        vec = [float(x) for x in value]
        if len(vec) != self.dims:
            raise MapperParsingError(
                f"vector length [{len(vec)}] does not match [dims]=[{self.dims}] for field [{self.name}]"
            )
        return vec


class GeoPointFieldType(FieldType):
    """Stored as two float64 columns (lat, lon); distance filters/aggs are
    vectorized haversine over the columns (reference: GeoPointFieldMapper)."""

    type_name = "geo_point"
    dv_kind = "geo_point"

    def index_terms(self, value, analyzers):
        return []

    def doc_value(self, value):
        if value is None:
            return None
        if isinstance(value, dict):
            return (float(value["lat"]), float(value["lon"]))
        if isinstance(value, str):
            if "," in value:
                lat, lon = value.split(",")
                return (float(lat), float(lon))
            raise MapperParsingError(f"geohash not supported for field [{self.name}]")
        if isinstance(value, (list, tuple)):  # GeoJSON order [lon, lat]
            return (float(value[1]), float(value[0]))
        raise MapperParsingError(f"cannot parse geo_point [{value}]")


class PercolatorFieldType(FieldType):
    """Stores a query for reverse search (the percolator module's
    ``percolator`` field; ref modules/percolator).  The raw query JSON
    lives in _source; parse-time validation rejects malformed queries at
    index time like PercolatorFieldMapper does."""

    type_name = "percolator"
    dv_kind = "none"
    indexed = True     # produces no terms, but index-time validation runs
    allow_multiple = False   # one query per doc (PercolatorFieldMapper)

    def index_terms(self, value, analyzers):
        from opensearch_tpu_torch.search.query_dsl import parse_query
        if value is not None:
            parse_query(value)         # validate eagerly; raises 400
        return []

    def doc_value(self, value):
        return None


class NestedFieldType(FieldType):
    """nested object container (the reference's ObjectMapper nested=true;
    each element of the array is matched as its own unit by the nested
    query — ref index/mapper/ + join/ToParentBlockJoinQuery).  The field
    itself indexes nothing; its child paths carry object-major columns
    (index/segment.py NestedBlock)."""

    type_name = "nested"
    dv_kind = "nested"
    indexed = False

    def index_terms(self, value, analyzers):
        return []

    def doc_value(self, value):
        return None


class JoinFieldType(FieldType):
    """Parent-join field (ref modules/parent-join/
    ParentJoinFieldMapper.java).  A doc's value is either a relation
    name ("question") or {"name": "answer", "parent": "<parent _id>"}.
    The mapper writes two hidden ordinal columns — ``<field>#name``
    (relation) and ``<field>#parent`` (the parent join key) — which
    has_child / has_parent / parent_id join host-side across segments
    (the global-ordinals OrdinalMap role)."""

    type_name = "join"
    dv_kind = "none"
    indexed = False
    allow_multiple = False

    def __init__(self, name, params=None):
        super().__init__(name, params)
        rel = self.params.get("relations") or {}
        # parent -> [children]
        self.relations = {p: (c if isinstance(c, list) else [c])
                          for p, c in rel.items()}

    def parent_of(self, child_type: str):
        for p, cs in self.relations.items():
            if child_type in cs:
                return p
        return None

    def is_relation(self, name: str) -> bool:
        return name in self.relations or self.parent_of(name) is not None

    def index_terms(self, value, analyzers):
        return []


class RankFeatureFieldType(FieldType):
    """Positive per-doc feature for rank_feature queries
    (mapper-extras RankFeatureFieldMapper): a double doc value; values
    must be strictly positive."""

    type_name = "rank_feature"
    dv_kind = "double"
    indexed = False
    allow_multiple = False

    def index_terms(self, value, analyzers):
        return []

    def doc_value(self, value):
        try:
            v = float(value)
        except (TypeError, ValueError) as e:
            raise MapperParsingError(
                f"failed to parse field [{self.name}] of type "
                f"[rank_feature]: [{value}]") from e
        if not math.isfinite(v) or v <= 0:
            raise MapperParsingError(
                f"[rank_feature] field [{self.name}] requires a positive "
                f"finite value, got [{value}]")
        if self.params.get("positive_score_impact") is False:
            # negative-impact features store the reciprocal, like the
            # reference's freq encoding
            v = 1.0 / v
        return v


class CompletionFieldType(FieldType):
    """Prefix completion (suggest/completion/CompletionFieldMapper).
    Inputs live in the segment's SORTED ordinal column, so a prefix is a
    binary-searched ordinal range — the array-native stand-in for the
    reference's FST; weights ride a parallel numeric column."""

    type_name = "completion"
    dv_kind = "ordinal"
    indexed = False

    def doc_value(self, value):
        return str(value)

    def index_terms(self, value, analyzers):
        return []


class ObjectFieldType(FieldType):
    """Explicit ``type: object`` container: no terms/doc-values of its
    own — its sub-fields are mapped flattened as ``parent.child``
    (ObjectMapper)."""

    type_name = "object"
    dv_kind = "none"
    indexed = False

    def index_terms(self, value, analyzers):
        return []


class BinaryFieldType(FieldType):
    """base64 blob: kept in _source, not term-searchable.  A constant
    presence marker is indexed per valued doc so ``exists`` works (the
    reference tracks the same via _field_names — BinaryFieldMapper)."""

    type_name = "binary"
    dv_kind = "none"
    indexed = True          # only the presence marker below

    def index_terms(self, value, analyzers):
        return [] if value is None else [("\x01present", 0)]


class UnsignedLongFieldType(FieldType):
    """64-bit unsigned integer (opensearch's unsigned_long).  Values are
    stored raw in the int64 column; the upper half-range [2^63, 2^64)
    saturates to 2^63-1 (ordering preserved, exact values above 2^63
    are not distinguished — the reference's full-range support would
    need an unsigned column type)."""

    type_name = "unsigned_long"
    dv_kind = "long"
    indexed = True

    _MAX_I64 = (1 << 63) - 1

    def index_terms(self, value, analyzers):
        return []

    def _clamp(self, value) -> int:
        v = int(value)
        if not (0 <= v < (1 << 64)):
            raise IllegalArgumentError(
                f"Value [{value}] is out of range for an unsigned long")
        return min(v, self._MAX_I64)

    def doc_value(self, value):
        return self._clamp(value)

    def term_for_query(self, value):
        return self._clamp(value)

    def range_bound(self, value):
        return self._clamp(value)


class DateNanosFieldType(DateFieldType):
    """date_nanos: stored at millisecond precision in the same int64
    column (the reference keeps nanos; sub-millisecond precision is not
    distinguished here — documented divergence)."""

    type_name = "date_nanos"


FIELD_TYPES = {
    cls.type_name: cls
    for cls in [
        NestedFieldType, PercolatorFieldType,
        TextFieldType, KeywordFieldType, LongFieldType, IntegerFieldType,
        ShortFieldType, ByteFieldType, DoubleFieldType, FloatFieldType,
        HalfFloatFieldType, ScaledFloatFieldType, BooleanFieldType,
        DateFieldType, IpFieldType, DenseVectorFieldType, GeoPointFieldType,
        BinaryFieldType, UnsignedLongFieldType, ObjectFieldType,
        JoinFieldType, CompletionFieldType, RankFeatureFieldType,
        DateNanosFieldType,
    ]
}
FIELD_TYPES["knn_vector"] = DenseVectorFieldType


def build_field_type(name: str, config: dict) -> FieldType:
    type_name = config.get("type")
    if type_name is None:
        raise MapperParsingError(f"no type specified for field [{name}]")
    cls = FIELD_TYPES.get(type_name)
    if cls is None:
        raise MapperParsingError(f"No handler for type [{type_name}] declared on field [{name}]")
    return cls(name, {k: v for k, v in config.items() if k not in ("type", "fields", "properties")})
