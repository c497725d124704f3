"""Fetch phase: build hit objects from winning doc ids (the port of the
JAX package's ``search/fetch.py``, every helper a host copy).

Analog of ``search/fetch/FetchPhase.java``: the ``FetchSourcePhase``
sub-phase (``filter_source``: source include/exclude filtering with
wildcard patterns), the plain highlighter (``collect_query_terms``,
``highlight_field``, ``run_highlight``), ``docvalue_fields`` (read from
the segment's host columns), the ``fields`` API (``fields_option``) and
``explain`` (``explain_hit``: a BM25 breakdown recomputed from the host
postings).  They run per hit of a page, on the host, as in the
reference."""

from __future__ import annotations

import fnmatch
from typing import Any, Optional, Union


def _match_any(path: str, patterns: list[str]) -> bool:
    for p in patterns:
        if fnmatch.fnmatchcase(path, p) or path.startswith(p + "."):
            return True
        # a pattern deeper than the path keeps the ancestor object
        if p.startswith(path + "."):
            return True
    return False


def _filter_tree(obj: Any, prefix: str, includes: Optional[list[str]],
                 excludes: list[str]):
    if not isinstance(obj, dict):
        return obj
    out = {}
    for k, v in obj.items():
        path = f"{prefix}{k}"
        if excludes and any(fnmatch.fnmatchcase(path, p)
                            or path.startswith(p + ".") for p in excludes):
            continue
        if includes is not None and not _match_any(path, includes):
            continue
        if isinstance(v, dict):
            sub_includes = includes
            if includes is not None and any(
                    fnmatch.fnmatchcase(path, p) or path.startswith(p + ".")
                    for p in includes):
                sub_includes = None  # whole subtree included
            v = _filter_tree(v, path + ".", sub_includes, excludes)
        out[k] = v
    return out


def filter_source(source: dict, spec: Union[bool, str, list, dict, None]):
    """Apply a ``_source`` request option.  Returns None when `_source`
    is disabled for the response."""
    if spec is None or spec is True:
        return source
    if spec is False:
        return None
    if isinstance(spec, str):
        spec = [spec]
    if isinstance(spec, list):
        return _filter_tree(source, "", [str(s) for s in spec], [])
    includes = spec.get("includes") or spec.get("include")
    excludes = spec.get("excludes") or spec.get("exclude") or []
    if isinstance(includes, str):
        includes = [includes]
    if isinstance(excludes, str):
        excludes = [excludes]
    return _filter_tree(source, "",
                        None if not includes else list(includes),
                        list(excludes))


# ---------------------------------------------------------------------------
# Fetch sub-phases: highlight / explain / docvalue_fields / fields
# (ref search/fetch/FetchPhase.java + search/fetch/subphase/)
# ---------------------------------------------------------------------------


def collect_query_terms(q, mapper) -> dict:
    """Walk the parsed query tree collecting the analyzed terms (and
    wildcard/prefix patterns) per field — what the highlighter marks
    (HighlightPhase's extracted-terms step)."""
    from opensearch_tpu_torch.search import query_dsl as dsl

    out: dict[str, dict] = {}

    def bucket(field):
        return out.setdefault(field, {"terms": set(), "patterns": []})

    def walk(node):
        if node is None:
            return
        if isinstance(node, (dsl.MatchQuery, dsl.MatchPhraseQuery)):
            ft = mapper.field_type(node.field)
            if ft is not None and hasattr(ft, "search_terms"):
                bucket(node.field)["terms"].update(
                    ft.search_terms(str(node.query), mapper.analyzers))
            else:
                bucket(node.field)["terms"].add(str(node.query))
        elif isinstance(node, dsl.TermQuery):
            bucket(node.field)["terms"].add(str(node.value).lower())
        elif isinstance(node, dsl.TermsQuery):
            bucket(node.field)["terms"].update(
                str(v).lower() for v in node.values)
        elif isinstance(node, (dsl.PrefixQuery,)):
            bucket(node.field)["patterns"].append(
                str(node.value).lower() + "*")
        elif isinstance(node, dsl.WildcardQuery):
            bucket(node.field)["patterns"].append(str(node.value).lower())
        elif isinstance(node, dsl.FuzzyQuery):
            bucket(node.field)["terms"].add(str(node.value).lower())
        elif isinstance(node, dsl.MultiMatchQuery):
            for field, _b in node.fields:
                ft = mapper.field_type(field)
                if ft is not None and hasattr(ft, "search_terms"):
                    bucket(field)["terms"].update(
                        ft.search_terms(str(node.query), mapper.analyzers))
        elif isinstance(node, dsl.BoolQuery):
            for c in (*node.must, *node.should, *node.filter):
                walk(c)                    # must_not terms don't highlight
        elif isinstance(node, dsl.DisMaxQuery):
            for c in node.queries:
                walk(c)
        elif isinstance(node, dsl.ConstantScoreQuery):
            walk(node.query)
        elif isinstance(node, dsl.BoostingQuery):
            walk(node.positive)
        elif isinstance(node, (dsl.ScriptScoreQuery,
                               dsl.FunctionScoreQuery)):
            walk(node.query)
        elif isinstance(node, dsl.HybridQuery):
            for c in node.queries:
                walk(c)
    walk(q)
    return out


def _fragment_spans(marks: list, text_len: int, fragment_size: int,
                    n_fragments: int) -> list:
    """Greedy fragmenter: one window per run of nearby matches."""
    spans = []
    for start, end in marks:
        if spans and start - spans[-1][1] <= fragment_size // 2:
            spans[-1][1] = end
        else:
            spans.append([start, end])
        if len(spans) > n_fragments * 4:
            break
    out = []
    for start, end in spans[: n_fragments]:
        pad = max((fragment_size - (end - start)) // 2, 0)
        lo = max(0, start - pad)
        hi = min(text_len, end + pad)
        out.append((lo, hi))
    return out


def highlight_field(text: str, ft, mapper, terms: set, patterns: list,
                    spec: dict) -> list:
    """Plain-highlighter analog: analyze the stored text (tokens carry
    offsets), mark tokens whose analyzed term matches, emit tagged
    fragments."""
    import fnmatch as _fn

    analyzer = mapper.analyzers.get(
        getattr(ft, "analyzer_name", "standard"))
    pre = (spec.get("pre_tags") or ["<em>"])[0]
    post = (spec.get("post_tags") or ["</em>"])[0]
    fragment_size = int(spec.get("fragment_size", 100))
    n_fragments = int(spec.get("number_of_fragments", 5))
    marks = []
    for tok in analyzer.analyze(text):
        hit = tok.term in terms or any(
            _fn.fnmatchcase(tok.term, p) for p in patterns)
        if hit:
            marks.append((tok.start_offset, tok.end_offset))
    if not marks:
        return []
    if n_fragments == 0:                   # whole-field highlighting
        spans = [(0, len(text))]
    else:
        spans = _fragment_spans(marks, len(text), fragment_size,
                                n_fragments)
    frags = []
    for lo, hi in spans:
        inside = [(s, e) for s, e in marks if s >= lo and e <= hi]
        buf = []
        pos = lo
        for s, e in inside:
            buf.append(text[pos:s])
            buf.append(pre + text[s:e] + post)
            pos = e
        buf.append(text[pos:hi])
        frags.append("".join(buf))
    return frags


def run_highlight(body_highlight: dict, source: dict, query, mapper):
    """The per-hit highlight sub-phase; returns {field: [fragments]}."""
    per_field = collect_query_terms(query, mapper)
    global_spec = {k: v for k, v in body_highlight.items()
                   if k != "fields"}
    out = {}
    fields_spec = body_highlight.get("fields") or {}
    if isinstance(fields_spec, list):      # accept the array form
        merged = {}
        for entry in fields_spec:
            merged.update(entry)
        fields_spec = merged
    for field, spec in fields_spec.items():
        spec = {**global_spec, **(spec or {})}
        ft = mapper.field_type(field)
        info = per_field.get(field)
        require_match = spec.get("require_field_match", True)
        if info is None and require_match:
            continue
        if info is None:
            # require_field_match:false highlights with terms from ANY
            # field in the query
            info = {"terms": set(), "patterns": []}
            for other in per_field.values():
                info["terms"] |= other["terms"]
                info["patterns"] += other["patterns"]
        value = source.get(field)
        if value is None:
            continue
        values = value if isinstance(value, list) else [value]
        frags = []
        for v in values:
            frags.extend(highlight_field(str(v), ft, mapper,
                                         info["terms"],
                                         info["patterns"], spec))
        if frags:
            out[field] = frags
    return out


def docvalue_fields(specs: list, seg, local: int, mapper) -> dict:
    """Per-hit doc-values read straight from the columns
    (DocValueFieldsPhase)."""
    from opensearch_tpu_torch.mapping.types import format_date_millis

    out = {}
    for spec in specs or []:
        if isinstance(spec, dict):
            field = spec.get("field")
            fmt = spec.get("format")
        else:
            field, fmt = str(spec), None
        ft = mapper.field_type(field)
        if ft is None:
            continue
        vals = []
        ndv = seg.numeric_dv.get(field)
        odv = seg.ordinal_dv.get(field)
        if ndv is not None and len(ndv.value_docs):
            import numpy as np
            sel = ndv.values[ndv.value_docs == local]
            for v in sel.tolist():
                if ft.type_name == "date" and fmt != "epoch_millis":
                    vals.append(format_date_millis(int(v)))
                elif ft.dv_kind == "long":
                    vals.append(int(v))
                else:
                    vals.append(float(v))
        elif odv is not None and len(odv.value_docs):
            sel = odv.ords[odv.value_docs == local]
            vals = [odv.ord_terms[int(o)] for o in sel.tolist()]
        if vals:
            out[field] = vals
    return out


def fields_option(specs: list, source: dict) -> dict:
    """The modern ``fields`` API: flattened leaf values (arrays) matched
    by name or wildcard from the source (FieldFetchPhase analog)."""
    import fnmatch as _fn

    flat: dict[str, list] = {}

    def walk(obj, path):
        if isinstance(obj, dict):
            for k, v in obj.items():
                walk(v, f"{path}.{k}" if path else k)
        elif isinstance(obj, list):
            for v in obj:
                walk(v, path)
        else:
            flat.setdefault(path, []).append(obj)

    walk(source, "")
    out = {}
    for spec in specs or []:
        pattern = spec.get("field") if isinstance(spec, dict) else str(spec)
        if not pattern:
            continue                   # malformed entry: no field named
        for path, vals in flat.items():
            if _fn.fnmatchcase(path, pattern):
                out.setdefault(path, []).extend(vals)
    return out


def explain_hit(score, query, seg, local: int, ctx) -> dict:
    """Per-hit score explanation (ExplainPhase).  Term-bag queries get a
    real BM25 breakdown recomputed host-side from the postings; other
    query shapes get a one-level summary (value + query description)."""
    import math

    from opensearch_tpu_torch.search import query_dsl as dsl

    def bm25_details(field, terms, boost):
        pf = seg.postings.get(field)
        details = []
        if pf is None:
            return details
        stats = ctx.field_stats(field)
        n_docs = max(stats.doc_count, 1)
        avgdl = stats.avgdl
        dl = float(pf.doc_lens[local]) if local < len(pf.doc_lens) else 0.0
        for t in terms:
            tid = pf.term_id(t)
            if tid < 0:
                continue
            lo, hi = int(pf.offsets[tid]), int(pf.offsets[tid + 1])
            entry = None
            import numpy as np
            rows = pf.doc_ids[lo:hi]
            idx = np.searchsorted(rows, local)
            if idx < len(rows) and rows[idx] == local:
                entry = float(pf.tfs[lo + idx])
            if entry is None:
                continue
            df = ctx.df(field, t)
            idf = math.log(1.0 + (n_docs - df + 0.5) / (df + 0.5))
            k1, b = 1.2, 0.75
            norm = k1 * (1.0 - b + b * dl / avgdl)
            contrib = boost * idf * entry / (entry + norm)
            details.append({
                "value": contrib,
                "description": f"weight({field}:{t} in {local})",
                "details": [
                    {"value": boost, "description": "boost", "details": []},
                    {"value": idf,
                     "description": f"idf, n={df}, N={n_docs}",
                     "details": []},
                    {"value": entry / (entry + norm),
                     "description": f"tf, freq={entry}, dl={dl}, "
                                    f"avgdl={avgdl:.2f}", "details": []},
                ]})
        return details

    details = []
    if isinstance(query, dsl.MatchQuery):
        ft = ctx.field_type(query.field)
        terms = (ft.search_terms(str(query.query), ctx.mapper.analyzers)
                 if ft is not None and hasattr(ft, "search_terms")
                 else [str(query.query)])
        details = bm25_details(query.field, terms, query.boost)
    elif isinstance(query, dsl.TermQuery):
        details = bm25_details(query.field, [str(query.value).lower()],
                               query.boost)
    elif isinstance(query, dsl.BoolQuery):
        for c in (*query.must, *query.should):
            sub = explain_hit(None, c, seg, local, ctx)
            if sub["details"] or sub["value"] is not None:
                details.append(sub)
    value = score if score is not None else sum(
        d["value"] for d in details if d.get("value") is not None)
    return {"value": value,
            "description": f"{type(query).__name__}, sum of:",
            "details": details}
