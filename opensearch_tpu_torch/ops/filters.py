"""Filter masks over doc-value columns and postings, on torch tensors (the
port of the JAX package's ``ops/filters.py``).

A filter is a dense boolean mask [n_pad] computed in one vectorized pass
over the column's expanded values (``values`` / ``value_docs`` of the
multi-valued CSR, ``index/segment.py``).  Multi-valued semantics match
SortedNumericDocValues: a doc matches if ANY of its values matches.  The
scatter-any is an int32 ``index_add_`` of the per-value predicate, then
``> 0``: integer sums do not depend on the order the device adds them in,
so the mask is exact on the CPU and on CUDA, the padded entries (which
point at the dead slot ``n_docs``) included.

``range_mask``, ``term_mask`` and ``terms_mask`` are torch ops on any
device, their own plain versions (the reference's are XLA ops too, not
Pallas kernels).  The reference's ``postings_mask`` is
``postings_mask_plain`` here (its gather and scatter); the plans read
K2's dense entry in counts-only mode instead (``search/plan.py``
``PostingsMaskPlan``, ``ops/bm25.py`` ``term_bag_dense_auto``: one
launch over every segment of a request on CUDA, every doc with a count
above 0).
"""

from __future__ import annotations

import torch

from opensearch_tpu_torch.common import torchenv  # noqa: F401
from opensearch_tpu_torch.ops import bm25 as bm25_ops


def scatter_any(ok, value_docs, n_pad: int):
    """``zeros(n_pad, bool).at[value_docs].max(ok)``."""
    hits = torch.zeros(n_pad, dtype=torch.int32, device=ok.device)
    hits.index_add_(0, value_docs.long(), ok.to(torch.int32))
    return hits > 0


def range_mask(values, value_docs, lo, hi, *, include_lo: bool,
               include_hi: bool, n_pad: int):
    """Docs with any value in the interval.  ``lo`` / ``hi`` are scalars
    of the column's kind (-inf / +inf, or the int64 extremes, when
    open)."""
    ok_lo = values >= lo if include_lo else values > lo
    ok_hi = values <= hi if include_hi else values < hi
    return scatter_any(ok_lo & ok_hi, value_docs, n_pad)


def term_mask(values, value_docs, value, *, n_pad: int):
    """Docs with any value equal to ``value`` (term filter over a numeric
    or ordinal column)."""
    return scatter_any(values == value, value_docs, n_pad)


def terms_mask(values, value_docs, query_values, *, n_pad: int):
    """Docs with any value in ``query_values`` [Q] (terms filter).  O(V*Q)
    compare, as in the reference: fine for the typical small Q."""
    ok = (values[:, None] == query_values[None, :]).any(dim=1)
    return scatter_any(ok, value_docs, n_pad)


def postings_mask_plain(offsets, doc_ids, tfs, term_ids, term_active, *,
                        n_pad: int, budget: int):
    """The reference's ``postings_mask``: its CSR gather of
    the terms' rows into ``budget`` lanes, then a scatter-any."""
    d, _tf, _slot, valid = bm25_ops.gather_postings(
        offsets, doc_ids, tfs, term_ids, term_active, budget=budget,
        pad_doc=n_pad - 1)
    return scatter_any(valid, d, n_pad)
