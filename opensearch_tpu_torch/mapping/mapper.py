"""DocumentMapper: JSON source -> typed per-field values ready for the
segment writer.

Analog of DocumentMapper/DocumentParser (index/mapper/DocumentMapper.java:247,
DocumentParser.java): walks the JSON tree, resolves dotted paths against the
mapping, applies dynamic mapping for unseen fields, supports multi-fields
(``fields.keyword`` sub-fields) and arrays (multi-valued fields).

Output is a ``ParsedDocument`` holding, per field:
- ``tokens``:  [(term, position)] destined for the inverted index
- ``longs`` / ``doubles`` / ``ordinals``: multi-valued doc-value lists
  (the SortedNumericDocValues / SortedSetDocValues analog — every value
  lands in the column, matching Lucene array-field semantics)
- ``vectors``: dense float vectors (single-valued, like Lucene KnnVectorField)
- ``geo_points``: (lat, lon) pairs

Metadata slots (``_seq_no`` / ``_version`` analog, assigned by the engine):
``seq_no`` and ``version`` fields on ParsedDocument.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field as dc_field
from typing import Any, Optional

from opensearch_tpu_torch.analysis import AnalysisRegistry
from opensearch_tpu_torch.common.errors import (IllegalArgumentError, MapperParsingError, StrictDynamicMappingError)
from opensearch_tpu_torch.mapping.types import (
    FieldType,
    TextFieldType,
    build_field_type,
)

POSITION_GAP = 100  # position increment between array elements (Lucene default)

# Mapping keys that are configuration, not field definitions
# (index/mapper/RootObjectMapper + metadata mappers).
_MAPPING_META_KEYS = frozenset(
    {"dynamic", "_source", "_routing", "_meta", "date_detection",
     "numeric_detection", "dynamic_templates", "_id", "enabled"}
)


@dataclass
class ParsedDocument:
    doc_id: str
    source: dict
    routing: Optional[str] = None
    seq_no: int = -1  # _seq_no metadata slot, assigned by the engine
    version: int = 1  # _version metadata slot, assigned by the engine
    tokens: dict[str, list[tuple[str, int]]] = dc_field(default_factory=dict)
    longs: dict[str, list[int]] = dc_field(default_factory=dict)
    doubles: dict[str, list[float]] = dc_field(default_factory=dict)
    ordinals: dict[str, list[str]] = dc_field(default_factory=dict)
    vectors: dict[str, list[float]] = dc_field(default_factory=dict)
    geo_points: dict[str, list[tuple[float, float]]] = dc_field(default_factory=dict)
    field_lengths: dict[str, int] = dc_field(default_factory=dict)  # for BM25 norms
    # completion field -> [(input, weight)] — weights are PER INPUT
    completions: dict[str, list[tuple[str, int]]] = dc_field(
        default_factory=dict)
    # nested path -> [per-object {child_path: ("num"|"ord", [values])}]
    nested: dict[str, list[dict]] = dc_field(default_factory=dict)


def _dynamic_type_for(value: Any) -> Optional[dict]:
    """Dynamic mapping inference (DocumentParser dynamic templates default)."""
    if isinstance(value, bool):
        return {"type": "boolean"}
    if isinstance(value, int):
        return {"type": "long"}
    if isinstance(value, float):
        return {"type": "float"}
    if isinstance(value, str):
        # Reference default: text with a .keyword sub-field (ignore_above 256).
        return {"type": "text", "fields": {"keyword": {"type": "keyword", "ignore_above": 256}}}
    return None


class DocumentMapper:
    """Holds the field-type lookup for one index and parses documents.

    Thread-safe for concurrent parse + dynamic mapping update (the engine may
    index from several threads, like the reference's write threadpool).
    """

    def __init__(self, mapping: Optional[dict] = None, analysis_settings: Optional[dict] = None):
        self._lock = threading.RLock()
        self.analyzers = AnalysisRegistry(analysis_settings)
        self._fields: dict[str, FieldType] = {}
        self._field_configs: dict[str, dict] = {}
        self.dynamic = "true"  # "true" | "false" | "strict"
        # _source meta-field: enabled=false stops storing source bytes
        # (SourceFieldMapper.enabled) — GET/_source then 404s and hits
        # carry no _source
        self.source_enabled = True
        if mapping:
            self.merge(mapping)

    # --- mapping management ---------------------------------------------

    def merge(self, mapping: dict):
        """Merge a mapping update (PutMappingRequest analog).  Conflicting
        type changes are rejected like MapperService.merge does."""
        with self._lock:
            # Validate everything before mutating any state: a rejected merge
            # must leave the mapper unchanged (MapperService.merge is atomic).
            dynamic = mapping.get("dynamic", self.dynamic)
            if isinstance(dynamic, bool):
                new_dynamic = "true" if dynamic else "false"
            else:
                new_dynamic = str(dynamic).lower()
                if new_dynamic not in ("true", "false", "strict"):
                    raise MapperParsingError(
                        f"dynamic must be one of [true, false, strict], got [{dynamic}]"
                    )
            if "properties" in mapping:
                props = mapping["properties"]
                unknown = [
                    k for k in mapping
                    if k != "properties" and k not in _MAPPING_META_KEYS
                ]
                if unknown:
                    raise MapperParsingError(
                        f"unsupported mapping parameters {sorted(unknown)}"
                    )
            else:
                # Bare field dict shorthand — only valid if every remaining
                # value is itself a field config object.
                props = {k: v for k, v in mapping.items() if k not in _MAPPING_META_KEYS}
                if not all(isinstance(v, dict) for v in props.values()):
                    raise MapperParsingError(
                        "malformed mapping: expected [properties] to be an object of field definitions"
                    )
            if not isinstance(props, dict):
                raise MapperParsingError("malformed mapping: [properties] must be an object")
            # Copy-on-write: build the merged lookup aside and swap it in
            # atomically, so concurrent parse() (which reads _fields without
            # the lock) sees either the old or the new mapping, never a
            # partially-applied one (MapperService.merge is atomic).
            new_fields = dict(self._fields)
            new_configs = dict(self._field_configs)
            self._merge_props("", props, new_fields, new_configs)
            self._fields = new_fields
            self._field_configs = new_configs
            self.dynamic = new_dynamic
            src_meta = mapping.get("_source")
            if isinstance(src_meta, dict) and "enabled" in src_meta:
                self.source_enabled = bool(src_meta["enabled"])

    def _merge_props(self, prefix: str, props: dict,
                     fields: dict, configs: dict):
        for name, config in props.items():
            if not str(name):
                raise IllegalArgumentError(
                    "field name cannot be an empty string")
            path = f"{prefix}{name}"
            if "properties" in config and config.get(
                    "type", "object") == "object":
                # implicit or explicit object container: children map
                # flattened under the dotted path (ObjectMapper)
                self._merge_props(path + ".", config["properties"], fields, configs)
                continue
            if config.get("type") == "nested":
                # the nested container registers AND its children do,
                # under the full dotted path (object-major columns)
                existing = fields.get(path)
                ft = build_field_type(path, config)
                if existing is not None and \
                        existing.type_name != ft.type_name:
                    raise MapperParsingError(
                        f"mapper [{path}] cannot be changed from type "
                        f"[{existing.type_name}] to [nested]")
                fields[path] = ft
                configs[path] = {k: v for k, v in config.items()
                                 if k != "properties"}
                self._merge_props(path + ".",
                                  config.get("properties") or {},
                                  fields, configs)
                continue
            existing = fields.get(path)
            ft = build_field_type(path, config)
            if existing is not None and existing.type_name != ft.type_name:
                raise MapperParsingError(
                    f"mapper [{path}] cannot be changed from type [{existing.type_name}]"
                    f" to [{ft.type_name}]"
                )
            fields[path] = ft
            configs[path] = config
            for sub_name, sub_config in (config.get("fields") or {}).items():
                sub_path = f"{path}.{sub_name}"
                fields[sub_path] = build_field_type(sub_path, sub_config)

    def field_type(self, path: str) -> Optional[FieldType]:
        return self._fields.get(path)

    def field_types(self) -> dict[str, FieldType]:
        with self._lock:
            return dict(self._fields)

    def to_mapping(self) -> dict:
        """Render the current mapping back to JSON (GetMappings analog)."""
        with self._lock:
            root: dict = {}
            for path, config in sorted(self._field_configs.items()):
                parts = path.split(".")
                node = root
                for p in parts[:-1]:
                    node = node.setdefault(p, {}).setdefault("properties", {})
                node[parts[-1]] = dict(config)
            out = {"properties": root}
            if self.dynamic != "true":
                out["dynamic"] = self.dynamic
            return out

    # --- parsing ---------------------------------------------------------

    def parse(self, doc_id: str, source: dict, routing: Optional[str] = None) -> ParsedDocument:
        doc = ParsedDocument(doc_id=doc_id, source=source, routing=routing)
        self._parse_object("", source, doc)
        return doc

    def _parse_object(self, prefix: str, obj: dict, doc: ParsedDocument):
        from opensearch_tpu_torch.mapping.types import NestedFieldType

        for key, value in obj.items():
            path = f"{prefix}{key}"
            ft0 = self._fields.get(path)
            if isinstance(ft0, NestedFieldType):
                self._parse_nested(path, value, doc)
                continue
            if isinstance(value, dict) and ft0 is None:
                self._parse_object(path + ".", value, doc)
                continue
            values = value if isinstance(value, list) else [value]
            # Arrays of objects flatten into the same dotted paths
            # (DocumentParser flattens object arrays; sub-fields accumulate
            # multi-valued data across elements).
            if self._fields.get(path) is None and any(isinstance(v, dict) for v in values):
                for v in values:
                    if isinstance(v, dict):
                        self._parse_object(path + ".", v, doc)
                values = [v for v in values if not isinstance(v, dict)]
                if not values:
                    continue
            ft = self._resolve(path, values)
            if ft is None:
                continue
            # A numeric array IS the single value for vector and geo fields.
            if ft.dv_kind in ("vector", "geo_point") and isinstance(value, list):
                values = [value]
            self._index_values(ft, values, doc)
            # multi-fields share the same raw values
            for sub_path, sub_ft in self._subfields(path):
                self._index_values(sub_ft, values, doc)

    def _parse_nested(self, path: str, value, doc: ParsedDocument):
        """Each element of a nested array becomes ONE object record whose
        child values stay grouped (vs the flattening object-array path
        above — that cross-object mixing is exactly what nested
        prevents).  Child values are stored match-ready: numeric/date/
        boolean as numbers, keyword as terms, text as analyzed terms."""
        if value is None:
            return
        objs = value if isinstance(value, list) else [value]
        records = doc.nested.setdefault(path, [])
        for o in objs:
            if not isinstance(o, dict):
                raise MapperParsingError(
                    f"object mapping for [{path}] tried to parse field "
                    "as object, but found a concrete value")
            record: dict = {}
            self._collect_nested_values(path + ".", o, record)
            records.append(record)

    def _collect_nested_values(self, prefix: str, obj: dict,
                               record: dict):
        for key, v in obj.items():
            child = f"{prefix}{key}"
            if isinstance(v, dict) and self._fields.get(child) is None:
                self._collect_nested_values(child + ".", v, record)
                continue
            ft = self._fields.get(child)
            if ft is None:
                continue           # unmapped nested children are ignored
            values = v if isinstance(v, list) else [v]
            kind, out = None, []
            for item in values:
                if item is None:
                    continue
                if ft.dv_kind in ("long", "double"):
                    dv = ft.doc_value(item)
                    if dv is None:
                        continue
                    kind = "num"
                    out.append(float(dv))
                elif ft.dv_kind == "ordinal":
                    dv = ft.doc_value(item)
                    if dv is None:     # e.g. keyword past ignore_above
                        continue
                    kind = "ord"
                    out.append(str(dv))
                elif hasattr(ft, "search_terms"):      # text: terms only
                    kind = "ord"
                    out.extend(t for t, _p in
                               ft.index_terms(item, self.analyzers))
            if out:
                prev = record.get(child)
                if prev is not None:
                    prev[1].extend(out)
                else:
                    record[child] = (kind, out)

    def _subfields(self, path: str):
        prefix = path + "."
        return [
            (p, ft)
            for p, ft in self._fields.items()
            if p.startswith(prefix)
            and "." not in p[len(prefix):]
            and p not in self._field_configs  # only multi-field children
        ]

    def _resolve(self, path: str, values: list) -> Optional[FieldType]:
        with self._lock:
            ft = self._fields.get(path)
            if ft is not None:
                return ft
            # Strict mode rejects the mere introduction of an unmapped field,
            # even with a null/empty value (DocumentParser strict semantics).
            if self.dynamic == "strict":
                raise StrictDynamicMappingError(path)
            sample = next((v for v in values if v is not None), None)
            if sample is None:
                return None
            if self.dynamic == "false":
                return None
            if isinstance(sample, dict):
                return None  # handled by recursion
            config = _dynamic_type_for(sample)
            if config is None:
                return None
            new_fields = dict(self._fields)
            new_configs = dict(self._field_configs)
            self._merge_props("", _nest(path, config), new_fields, new_configs)
            self._fields = new_fields
            self._field_configs = new_configs
            return self._fields[path]

    def _index_values(self, ft: FieldType, values: list, doc: ParsedDocument):
        if not getattr(ft, "allow_multiple", True) and \
                sum(1 for v in values if v is not None) > 1:
            raise MapperParsingError(
                f"field [{ft.name}] of type [{ft.type_name}] does not "
                "support arrays")
        from opensearch_tpu_torch.mapping.types import (CompletionFieldType,
                                                  JoinFieldType)
        if isinstance(ft, CompletionFieldType):
            # {"input": [...], "weight": n} | "text" | ["a", "b"]:
            # inputs land in the sorted ordinal column (the prefix
            # range), weights stay PER INPUT in a dedicated structure
            # (CompletionFieldMapper.parse keeps weight per entry)
            for v in values:
                if v is None:
                    continue
                if isinstance(v, dict):
                    inputs = v.get("input") or []
                    if isinstance(inputs, str):
                        inputs = [inputs]
                    weight = int(v.get("weight", 1))
                else:
                    inputs, weight = [str(v)], 1
                for text in inputs:
                    doc.ordinals.setdefault(ft.name, []).append(str(text))
                    doc.completions.setdefault(ft.name, []).append(
                        (str(text), weight))
            return
        if isinstance(ft, JoinFieldType):
            # join values land in the hidden #name / #parent ordinal
            # columns (ParentJoinFieldMapper's joinField + parentIdField)
            for v in values:
                if v is None:
                    continue
                if isinstance(v, str):
                    name, parent = v, None
                elif isinstance(v, dict):
                    name, parent = v.get("name"), v.get("parent")
                else:
                    raise MapperParsingError(
                        f"[{ft.name}] join value must be a relation name "
                        "or {name, parent}")
                if not ft.is_relation(name):
                    raise MapperParsingError(
                        f"unknown join name [{name}] for field "
                        f"[{ft.name}]")
                if ft.parent_of(name) is not None and parent is None:
                    raise MapperParsingError(
                        f"[parent] is missing for join field [{ft.name}]")
                doc.ordinals.setdefault(f"{ft.name}#name",
                                        []).append(str(name))
                if parent is not None:
                    doc.ordinals.setdefault(f"{ft.name}#parent",
                                            []).append(str(parent))
            return
        pos_base = 0
        n_tokens = doc.field_lengths.get(ft.name, 0)
        saw_value = any(v is not None for v in values)
        toks = doc.tokens.setdefault(ft.name, [])
        if toks:
            pos_base = toks[-1][1] + POSITION_GAP
        for v in values:
            if v is None:
                continue
            if ft.index_enabled and ft.indexed:
                terms = ft.index_terms(v, self.analyzers)
                for term, pos in terms:
                    toks.append((term, pos_base + pos))
                if terms:
                    pos_base = toks[-1][1] + POSITION_GAP
                if isinstance(ft, TextFieldType):
                    n_tokens += len(terms)
            if ft.doc_values_enabled:
                dv = ft.doc_value(v)
                if dv is None:
                    continue
                kind = ft.dv_kind
                if kind == "long":
                    doc.longs.setdefault(ft.name, []).append(dv)
                elif kind == "double":
                    doc.doubles.setdefault(ft.name, []).append(dv)
                elif kind == "ordinal":
                    doc.ordinals.setdefault(ft.name, []).append(dv)
                elif kind == "vector":
                    if ft.name in doc.vectors:
                        # Lucene KnnVectorField rejects multi-valued vectors
                        raise MapperParsingError(
                            f"[{ft.name}] of type [dense_vector] doesn't "
                            "support indexing multiple values per document"
                        )
                    doc.vectors[ft.name] = dv
                elif kind == "geo_point":
                    doc.geo_points.setdefault(ft.name, []).append(dv)
        if saw_value and ft.index_enabled and not ft.doc_values_enabled \
                and not toks:
            # doc_values disabled and no indexed terms (numeric/date):
            # record a presence marker so `exists` keeps working (the
            # reference indexes points + _field_names for this)
            toks.append(("\x01present", 0))
        if not toks:
            doc.tokens.pop(ft.name, None)
        # field_lengths presence == "this doc has the field" (the norms-entry
        # analog: Lucene writes a norm even for zero-token values, so exists
        # must match them — but a null value writes nothing).
        if isinstance(ft, TextFieldType) and (saw_value or ft.name in doc.field_lengths):
            doc.field_lengths[ft.name] = n_tokens


def _nest(path: str, config: dict) -> dict:
    parts = path.split(".")
    out: dict = {parts[-1]: config}
    for p in reversed(parts[:-1]):
        out = {p: {"properties": out}}
    return out
