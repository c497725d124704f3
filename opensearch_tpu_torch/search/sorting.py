"""Result order on the searcher's device: field ``sort`` with
``search_after``, score order over every matched row, and ``collapse``
(the port of the JAX package's ``search/executor.py`` ``_field_sorted``,
``_sort_key_columns``, ``_rows_from_views``, ``scan_rows`` and
``_collapsed``' ranking).

The reference reads every segment's scores and mask back, builds one
dict per matched doc and sorts them with a comparator on the host.
Here the host never builds an object per matched row:

- ``matched_rows`` takes the matched rows of a request as flat positions
  into the searcher's segments laid end to end, so their order is
  (segment, local) ascending;
- ``field_order`` gathers each clause's key at those rows from a key
  column of the whole searcher (``key_column``, cached on the searcher:
  ``minv`` for ``asc`` or ``maxv`` for ``desc`` with missing docs at
  ``missing_sentinel``; adopted into the residency ledger under kind
  ``sort_keys``, so it counts against the device budget; a keyword's
  ``min_ord`` / ``max_ord`` as its rank
  in the sorted union of the segments' terms, ``KeywordRanks``, since
  each segment's dictionary is its own), or the f32 score widened to
  float64, or the local doc id; drops the rows at or before a
  ``search_after`` probe with a mask; then orders the rest with a chain
  of stable sorts, last clause first.  That is the comparator's order,
  ties falling to (segment, local) ascending whatever the direction;
- ``score_order`` is (score desc, segment, local), one stable sort;
- ``collapse`` keeps each key's first row in result order (the first of
  each run of a stable sort of the rows' key ids), then the ``k`` first;
- ``OrderedRows.take`` reads back only the rows a page needs, in one
  copy.

Keys compare as values: float keys are sorted with -0.0 turned into
0.0 (a sort may order by bit pattern), int64 keys are never negated to
reverse them (``descending=True``).  A keyword ``None`` sorts first only
under ``missing: "_first"``, whatever the direction (``cmp_values``).

The parsing and comparison helpers (``parse_sort``, ``missing_sentinel``,
``cmp_values``, ``sort_comparator``, ``sort_value``) and ``slice_filter``
(``search/contexts.py``) are host copies of the reference's; the
comparator is the plain version of the device order, and the REST
layer's multi-index merge uses it.
"""

from __future__ import annotations

import bisect
import threading
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from opensearch_tpu_torch.common.device_ledger import device_ledger
from opensearch_tpu_torch.common.errors import IllegalArgumentError
from opensearch_tpu_torch.index.segment import (LONG_MISSING_MAX,
                                                LONG_MISSING_MIN)

_I64_MIN, _I64_MAX = -2**63, 2**63 - 1
_NANOS_PER_MILLI = 1_000_000
_SLICE_HASH = 2654435761


# -- host copies of the reference's helpers ------------------------------------

def parse_sort(spec) -> Optional[list[dict]]:
    """Normalize the request ``sort`` into [{field, order, missing}].
    Returns None for the plain score-sorted path."""
    if spec is None:
        return None
    if not isinstance(spec, list):
        spec = [spec]
    out = []
    for s in spec:
        if isinstance(s, str):
            field, order = s, ("desc" if s == "_score" else "asc")
            out.append({"field": field, "order": order, "missing": "_last"})
        elif isinstance(s, dict):
            if len(s) != 1:
                raise IllegalArgumentError(f"malformed sort clause {s}")
            field, opts = next(iter(s.items()))
            if isinstance(opts, str):
                out.append({"field": field, "order": opts, "missing": "_last"})
            else:
                out.append({"field": field,
                            "order": opts.get("order",
                                              "desc" if field == "_score"
                                              else "asc"),
                            "missing": opts.get("missing", "_last")})
        else:
            raise IllegalArgumentError(f"malformed sort clause {s}")
    if len(out) == 1 and out[0]["field"] == "_score" and \
            out[0]["order"] == "desc":
        return None
    return out


def missing_sentinel(kind, order, missing):
    if missing not in ("_last", "_first"):
        return int(missing) if kind == "long" else float(missing)
    last = missing == "_last"
    if kind == "long":
        big, small = LONG_MISSING_MAX, LONG_MISSING_MIN
    else:
        big, small = np.inf, -np.inf
    if order == "asc":
        return big if last else small
    return small if last else big


def cmp_values(a, b, order: str, missing: str) -> int:
    if a is None or b is None:
        if a is None and b is None:
            return 0
        none_first = (missing == "_first")
        if a is None:
            return -1 if none_first else 1
        return 1 if none_first else -1
    if a == b:
        return 0
    lt = a < b
    if order == "desc":
        lt = not lt
    return -1 if lt else 1


def sort_comparator(specs):
    def cmp(r1, r2):
        for i, spec in enumerate(specs):
            c = cmp_values(r1["sort"][i], r2["sort"][i], spec["order"],
                           spec["missing"])
            if c:
                return c
        if r1["seg"] != r2["seg"]:
            return -1 if r1["seg"] < r2["seg"] else 1
        return -1 if r1["local"] < r2["local"] else (
            0 if r1["local"] == r2["local"] else 1)
    return cmp


def sort_value(v):
    if v is None:
        return None
    if isinstance(v, (np.integer,)):
        return int(v)
    if isinstance(v, (np.floating,)):
        return float(v)
    return v


def slice_filter(slice_spec: Optional[dict]):
    """Row predicate for ``{"id": i, "max": n}`` — deterministic disjoint
    partition of (seg, local) pairs (SliceBuilder's doc-hash strategy)."""
    if slice_spec is None:
        return None
    sid = int(slice_spec.get("id", 0))
    smax = int(slice_spec.get("max", 1))
    if smax < 2:
        raise IllegalArgumentError("[slice] max must be >= 2")
    if not (0 <= sid < smax):
        raise IllegalArgumentError(
            f"slice id [{sid}] must be in [0, {smax})")

    def pred(seg_i: int, local: int) -> bool:
        return (seg_i * _SLICE_HASH + local) % smax == sid
    pred.sid, pred.smax = sid, smax
    return pred


# -- read-backs ----------------------------------------------------------------
# counted on the searcher's ``read_back_bytes``: each copy to the host, and
# 8 bytes for each count a selection reads (``torch.nonzero``, a boolean
# index)

def to_host(searcher, t: torch.Tensor) -> np.ndarray:
    out = t.cpu().numpy()
    searcher.read_back_bytes += out.nbytes
    return out


def _select(searcher, t: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    searcher.read_back_bytes += 8
    return t[mask]


# -- keys ----------------------------------------------------------------------

class KeywordRanks:
    """A keyword field's terms over every segment of a searcher, sorted in
    Python ``str`` order (code points), and per segment an int32 table
    on the searcher's device from the segment's ordinals to ranks in
    that union (None where the segment has no column)."""

    def __init__(self, segments, field: str, device):
        dicts = [seg.ordinal_dv.get(field) for seg in segments]
        self.terms = sorted(set().union(
            *(d.ord_terms for d in dicts if d is not None)))
        index = {t: i for i, t in enumerate(self.terms)}
        self.tables = [
            None if d is None or not d.ord_terms else torch.tensor(
                [index[t] for t in d.ord_terms], dtype=torch.int32,
                device=device)
            for d in dicts]

    def probe(self, value: str) -> tuple:
        """(rank of the first term >= ``value``, whether it equals it)."""
        lo = bisect.bisect_left(self.terms, value)
        return lo, lo < len(self.terms) and self.terms[lo] == value


def keyword_ranks(searcher, field: str) -> KeywordRanks:
    return searcher._sort_cache.get_or_make(
        ("ranks", field),
        lambda: KeywordRanks(searcher.segments, field, searcher.device))


@dataclass(frozen=True)
class Clause:
    """One sort clause resolved against the mapping: ``kind`` is
    ``score``, ``doc``, ``long``, ``double`` or ``keyword``."""
    field: str
    order: str
    missing: object
    kind: str
    nanos: bool = False

    @property
    def desc(self) -> bool:
        return self.order == "desc"

    @property
    def none_first(self) -> bool:
        return self.missing == "_first"


def resolve_clauses(ctx, specs) -> list:
    """The clauses of parsed ``specs``; an unmapped field or one without
    sortable doc values raises, as the reference does once a segment has
    a matched row."""
    out = []
    for spec in specs:
        field, order, missing = spec["field"], spec["order"], spec["missing"]
        if field in ("_score", "_doc"):
            out.append(Clause(field, order, missing, field[1:]))
            continue
        ft = ctx.field_type(field)
        if ft is None:
            raise IllegalArgumentError(
                f"No mapping found for [{field}] in order to sort on")
        kind = {"long": "long", "double": "double",
                "ordinal": "keyword"}.get(ft.dv_kind)
        if kind is None:
            raise IllegalArgumentError(
                f"sorting on field [{field}] of type [{ft.type_name}] is "
                "not supported")
        out.append(Clause(field, order, missing, kind,
                          nanos=ft.type_name == "date_nanos"))
    return out


def _keyword_none(clause: Clause, n_terms: int) -> int:
    """The key of a doc without the keyword: before every rank (-1) when
    it comes first in the clause's direction, else after (``n_terms``)."""
    return -1 if clause.none_first != clause.desc else n_terms


_sort_group_lock = threading.Lock()


def key_column(searcher, clause: Clause) -> torch.Tensor:
    """The clause's key of every doc of the searcher's segments laid end
    to end (int64, or float64 for ``double``), built once per searcher
    and adopted into the searcher's ``sort_keys`` ledger group (counted
    against the device budget, never evicted: the searcher's cache owns
    it; ``key_column_dropped`` forgets it)."""
    key = ("sort", clause.field, clause.kind, clause.order,
           repr(clause.missing))

    def make():
        col = _build_key_column(searcher, clause)
        device_ledger().adopt(_sort_group(searcher), col, kind="sort_keys",
                              field=clause.field, name=repr(key))
        return col

    return searcher._sort_cache.get_or_make(key, make)


def _sort_group(searcher):
    """The searcher's ledger group of sort key columns (closed with the
    searcher)."""
    with _sort_group_lock:
        group = searcher._sort_group
        if group is None:
            led = device_ledger()
            group = searcher._sort_group = led.open_group(
                index=searcher.index_name, shard=searcher.shard_id,
                segment="sort_keys")
            led.tether(searcher, group)
            group.sealed = True
        return group


def key_column_dropped(searcher_ref, key, _value) -> None:
    """The searcher's sort cache dropped ``key``: a key column leaves the
    ledger with it."""
    searcher = searcher_ref()
    if searcher is not None and key[0] == "sort" and \
            searcher._sort_group is not None:
        device_ledger().drop(searcher._sort_group, kind="sort_keys",
                             field=key[1], name=repr(key))


def _build_key_column(searcher, clause: Clause) -> torch.Tensor:
    dev = searcher.device
    parts = []
    if clause.kind == "keyword":
        ranks = keyword_ranks(searcher, clause.field)
        none = _keyword_none(clause, len(ranks.terms))
        for seg, table in zip(searcher.segments, ranks.tables):
            col = seg.device(dev).ordinal.get(clause.field)
            n = seg.n_docs
            if col is None or table is None:
                parts.append(torch.full((n,), none, dtype=torch.int64,
                                        device=dev))
                continue
            ords = col["max_ord" if clause.desc else "min_ord"][:n]
            ok = col["exists"][:n] & (ords >= 0)
            parts.append(torch.where(ok, table[ords.clamp(min=0)].long(),
                                     none))
        return torch.cat(parts)
    dtype = torch.int64 if clause.kind == "long" else torch.float64
    sentinel = missing_sentinel(clause.kind, clause.order, clause.missing)
    for seg in searcher.segments:
        col = seg.device(dev).numeric.get(clause.field)
        n = seg.n_docs
        fill = torch.full((n,), sentinel, dtype=dtype, device=dev)
        if col is None:
            parts.append(fill)
        else:
            vals = col["maxv" if clause.desc else "minv"][:n]
            parts.append(torch.where(col["exists"][:n], vals.to(dtype),
                                     fill))
    return torch.cat(parts)


def collapse_column(searcher, field: str, kind: str) -> tuple:
    """(key, exists) of every doc of the searcher's segments end to end:
    a numeric field's ``minv`` whatever the sort order, or a keyword's
    ``min_ord`` rank (``exists`` False where the doc has no value)."""
    return searcher._sort_cache.get_or_make(
        ("collapse", field, kind),
        lambda: _build_collapse_column(searcher, field, kind))


def _build_collapse_column(searcher, field: str, kind: str) -> tuple:
    dev = searcher.device
    keys, present = [], []
    ranks = keyword_ranks(searcher, field) if kind == "keyword" else None
    dtype = torch.float64 if kind == "double" else torch.int64
    for si, seg in enumerate(searcher.segments):
        dseg = seg.device(dev)
        n = seg.n_docs
        col = (dseg.ordinal if kind == "keyword" else dseg.numeric).get(field)
        table = ranks.tables[si] if ranks is not None else None
        if col is None or (ranks is not None and table is None):
            keys.append(torch.zeros(n, dtype=dtype, device=dev))
            present.append(torch.zeros(n, dtype=torch.bool, device=dev))
        elif kind == "keyword":
            ords = col["min_ord"][:n]
            present.append(col["exists"][:n] & (ords >= 0))
            keys.append(table[ords.clamp(min=0)].long())
        else:
            present.append(col["exists"][:n])
            keys.append(col["minv"][:n].to(dtype))
    return torch.cat(keys), torch.cat(present)


def _value_order_key(t: torch.Tensor) -> torch.Tensor:
    """``t`` as a sort key: floats with -0.0 as 0.0, so the two tie."""
    if t.is_floating_point():
        return torch.where(t == 0, torch.zeros_like(t), t)
    return t


# -- the rows of a request -----------------------------------------------------

def segment_starts(searcher) -> tuple:
    """(host list, device int64 tensor) of each segment's first flat
    position: the searcher's segments laid end to end."""
    def make():
        starts = np.zeros(len(searcher.segments), dtype=np.int64)
        if len(starts) > 1:
            starts[1:] = np.cumsum([s.n_docs for s in searcher.segments])[:-1]
        return starts, torch.from_numpy(starts).to(searcher.device)
    return searcher._sort_cache.get_or_make(("starts",), make)


def split_flat(starts_t: torch.Tensor, flat: torch.Tensor) -> tuple:
    """(segment, local) of flat positions, on the device."""
    seg = torch.searchsorted(starts_t, flat, right=True) - 1
    return seg, flat - starts_t[seg]


def matched_rows(searcher, views, slice_spec=None) -> torch.Tensor:
    """Flat positions (int64, ascending) of the matched rows of ``views``
    (``(seg, dseg, scores, matched)`` of the searcher's first segments,
    in order); with ``slice_spec`` only the slice's rows."""
    dev = searcher.device
    pred = slice_filter(slice_spec)
    if not views:
        return torch.zeros(0, dtype=torch.int64, device=dev)
    mask = torch.cat([matched[: seg.n_docs]
                      for seg, _d, _s, matched in views])
    searcher.read_back_bytes += 8
    flat = torch.nonzero(mask).squeeze(1)
    if pred is not None and flat.numel():
        seg, local = split_flat(segment_starts(searcher)[1], flat)
        flat = _select(searcher, flat,
                       (seg * _SLICE_HASH + local) % pred.smax == pred.sid)
    return flat


def _scores_at(views, flat: torch.Tensor) -> torch.Tensor:
    return torch.cat([scores[: seg.n_docs]
                      for seg, _d, scores, _m in views])[flat]


class OrderedRows:
    """Rows of a request in result order, on the searcher's device.

    ``flat`` [M] the rows' flat positions; with field order ``clauses``
    and ``values`` (each clause's key at each row, as the response shows
    it: keyword ranks, numeric keys with their sentinels), with score
    order ``scores`` (f32).  ``total`` is the matched count, before
    ``search_after``."""

    def __init__(self, searcher, flat, total: int, clauses=None, values=(),
                 terms=(), scores=None):
        self.searcher = searcher
        self.starts = segment_starts(searcher)[0]
        self.flat = flat
        self.total = int(total)
        self.clauses = clauses
        self.values = list(values)
        self.terms = list(terms)
        self.scores = scores

    def __len__(self) -> int:
        return int(self.flat.numel())

    def take(self, k: Optional[int] = None, positions=None,
             extra=()) -> tuple:
        """(rows, extra columns on the host) of the first ``k`` rows, or
        of the rows at ``positions`` (a device tensor), in one copy.
        ``extra``: int64 or float64 device tensors over all M rows, read
        at the same rows."""
        idx = slice(0, k) if positions is None else positions
        cols = [self.flat[idx]]
        if self.scores is not None:
            cols.append(self.scores[idx].double())
        cols += [v[idx] for v in self.values]
        cols += [x[idx] for x in extra]
        n = int(cols[0].numel())
        if n == 0:
            return [], [np.zeros(0)] * len(extra)
        host = to_host(self.searcher, torch.stack([
            c.view(torch.int64) if c.is_floating_point() else c.long()
            for c in cols]))
        flat = host[0]
        seg = np.searchsorted(self.starts, flat, side="right") - 1
        local = flat - self.starts[seg]
        rows = []
        if self.scores is not None:
            for i, score in enumerate(host[1].view(np.float64).tolist()):
                rows.append({"seg": int(seg[i]), "local": int(local[i]),
                             "score": score})
        else:
            rendered = [self._render(clause, col, terms)
                        for clause, col, terms in zip(
                            self.clauses, host[1: 1 + len(self.values)],
                            self.terms)]
            for i in range(n):
                rows.append({"seg": int(seg[i]), "local": int(local[i]),
                             "score": None,
                             "sort": [vals[i] for vals in rendered]})
        return rows, list(host[len(host) - len(extra):]) if extra else []

    @staticmethod
    def _render(clause: Clause, col: np.ndarray, terms) -> list:
        """A clause's sort values as the response shows them."""
        if clause.kind == "keyword":
            n = len(terms)
            return [terms[r] if 0 <= r < n else None for r in col.tolist()]
        if clause.kind in ("double", "score"):
            return col.view(np.float64).tolist()
        vals = col.tolist()
        if clause.nanos:
            # date_nanos sort keys render in nanos (the reference's
            # resolution-aware sort serialization)
            vals = [v * _NANOS_PER_MILLI for v in vals]
        return vals


def _compare(clause: Clause, col: torch.Tensor, probe, ranks) -> tuple:
    """(after, equal) of each row against one ``search_after`` value, in
    the clause's direction; either may be a Python bool."""
    if clause.kind == "keyword":
        n = len(ranks.terms)
        none_rows = (col < 0) | (col >= n)
    else:
        none_rows = None
    if probe is None:
        # cmp_values: a value is after None only when None comes first
        if none_rows is None:
            return clause.none_first, False
        return ~none_rows & clause.none_first, none_rows
    if clause.kind == "keyword":
        lo, exact = ranks.probe(probe)
        if clause.desc:
            after = col < lo
        else:
            after = col > lo if exact else col >= lo
        after = (after & ~none_rows) | (none_rows & (not clause.none_first))
        equal = (col == lo) & ~none_rows if exact else False
        return after, equal
    if isinstance(probe, float) and not col.is_floating_point():
        col = col.double()            # numpy's int64-to-float comparison
    elif isinstance(probe, int) and not col.is_floating_point() and \
            not _I64_MIN <= probe <= _I64_MAX:
        above = probe > _I64_MAX      # beyond every int64 key
        return (not above) if not clause.desc else above, False
    after = col < probe if clause.desc else col > probe
    return after, col == probe


def _after_mask(clauses, values, probe, ranks_of) -> torch.Tensor:
    """Rows strictly after the ``search_after`` probe in the comparator's
    order; the probe's (segment, local) is (2**31 - 1, 2**31 - 1), so a row
    equal to it on every key is at or before it and is dropped."""
    after = torch.zeros(values[0].shape, dtype=torch.bool,
                        device=values[0].device)
    equal = torch.ones_like(after)
    for clause, col, p in zip(clauses, values, probe):
        a, e = _compare(clause, col, p, ranks_of.get(clause.field))
        after = after | (equal & a)
        equal = equal & e
    return after


@dataclass
class RowKeys:
    """Each clause's key at the rows ``flat`` of a request (a device
    tensor per clause, in the rows' (segment, local) order)."""
    flat: torch.Tensor
    clauses: list
    values: list
    ranks_of: dict


def row_keys(searcher, views, flat: torch.Tensor, specs) -> RowKeys:
    """The keys of the parsed sort ``specs`` at the rows ``flat`` of
    ``views``: gathers from the searcher's key columns (``key_column``),
    the scores widened to float64, or the local ids."""
    if flat.numel() == 0:
        return RowKeys(flat, [], [], {})
    clauses = resolve_clauses(searcher.ctx, specs)
    ranks_of = {c.field: keyword_ranks(searcher, c.field)
                for c in clauses if c.kind == "keyword"}
    values = []
    for clause in clauses:
        if clause.kind == "score":
            values.append(_scores_at(views, flat).double())
        elif clause.kind == "doc":
            values.append(split_flat(segment_starts(searcher)[1], flat)[1])
        else:
            values.append(key_column(searcher, clause)[flat])
    return RowKeys(flat, clauses, values, ranks_of)


def order_keys(searcher, keys: RowKeys, search_after=None) -> OrderedRows:
    """The rows of ``keys`` in the clauses' order, those at or before
    ``search_after`` (already coerced to the columns' space) dropped: a
    mask, then a chain of stable sorts, last clause first."""
    flat, values, total = keys.flat, keys.values, int(keys.flat.numel())
    if total == 0:
        return OrderedRows(searcher, flat, 0, clauses=[], values=[])
    if search_after is not None:
        keep = _after_mask(keys.clauses, values, search_after,
                           keys.ranks_of)
        flat = _select(searcher, flat, keep)
        values = [_select(searcher, v, keep) for v in values]
    perm = torch.arange(flat.numel(), device=flat.device)
    for clause, col in reversed(list(zip(keys.clauses, values))):
        _, o = torch.sort(_value_order_key(col)[perm], stable=True,
                          descending=clause.desc)
        perm = perm[o]
    terms = [keys.ranks_of[c.field].terms if c.kind == "keyword" else ()
             for c in keys.clauses]
    return OrderedRows(searcher, flat[perm], total, clauses=keys.clauses,
                       values=[v[perm] for v in values], terms=terms)


def field_order(searcher, views, flat: torch.Tensor, specs,
                search_after=None) -> OrderedRows:
    """The rows ``flat`` of ``views`` ordered by the parsed sort ``specs``,
    those at or before ``search_after`` dropped (``row_keys``, then
    ``order_keys``)."""
    return order_keys(searcher, row_keys(searcher, views, flat, specs),
                      search_after)


def score_order(searcher, views, flat: torch.Tensor) -> OrderedRows:
    """The rows ``flat`` of ``views`` by (score desc, segment, local)."""
    scores = _scores_at(views, flat)
    _, o = torch.sort(_value_order_key(scores), stable=True,
                      descending=True)
    return OrderedRows(searcher, flat[o], flat.numel(), scores=scores[o])


def collapse(searcher, ordered: OrderedRows, field: str, ft,
             k: int) -> list:
    """The first row of each distinct value of ``field`` in ``ordered``'s
    order, the ``k`` first of them, each with ``fields: {field: [key]}``
    (a numeric field's ``minv``, a keyword's ``min_ord`` term; docs
    without a value collapse together under None).  Like the reference,
    which checks ``k`` after keeping a row, a ``k`` of 0 keeps one row
    (the response's ``max_score`` reads it)."""
    m = len(ordered)
    if m == 0:
        return []
    k = max(k, 1)
    kind = {"long": "long", "double": "double",
            "ordinal": "keyword"}[ft.dv_kind]
    keys, present = collapse_column(searcher, field, kind)
    keys, present = keys[ordered.flat], present[ordered.flat]
    if kind == "keyword":
        ids = torch.where(present, keys,
                          len(keyword_ranks(searcher, field).terms))
    else:
        uniq, inverse = torch.unique(_value_order_key(keys),
                                     return_inverse=True)
        ids = torch.where(present, inverse, uniq.numel())
    # a stable sort groups each key's rows, in result order: the first
    # of each run is the key's first row
    order = torch.sort(ids, stable=True).indices
    run = ids[order]
    first = torch.ones(m, dtype=torch.bool, device=ids.device)
    first[1:] = run[1:] != run[:-1]
    kept = torch.sort(_select(searcher, order, first)).values[:k]
    rows, (key, has) = ordered.take(positions=kept,
                                    extra=(keys, present.long()))
    has = has.tolist()
    if kind == "keyword":
        terms = keyword_ranks(searcher, field).terms
        values = [terms[r] if h else None
                  for r, h in zip(key.tolist(), has)]
    else:
        values = [v if h else None for v, h in zip(
            (key.view(np.float64) if kind == "double" else key).tolist(),
            has)]
    return [{**row, "fields": {field: [value]}}
            for row, value in zip(rows, values)]
