"""K2's dense (per-slot) entry, held on the CPU: ``ops/cuda_bm25.py``
``term_bag_dense_cuda`` makes one launch per row layout over a table of
every segment of a request (``csrc/bm25.cu`` ``term_bag_dense_kernel``):
a block per (segment, ``FOLD_TILE_DOCS`` docs), each adding the bag's
slots from the table in slot order into its tile and writing the tile
once at the segment's offset of one output arena.

- A numpy model of the table-form kernel, which reads nothing but the
  launch table ``dense_launches`` builds (and the rows its pointers name),
  equals the plain versions (``ops/bm25.py`` ``term_bag_dense``) byte for
  byte over mixed segments in one call (f32 segments with n_pad below
  and above one tile, one without the field, one with every slot
  inactive, int8 and int16 quantized ones), in each mode (scores;
  scores and counts; counts only), and through them the JAX package's
  ``impact_score_count`` / ``match_count`` / ``postings_mask`` and
  quantized ops.  The launch table's layout is checked word by word.
- The executor's pre-pass calls the dense entry once per term-bag leaf
  over every segment it evaluates (also where the rest of the plan runs
  segment by segment: ``track_total_hits: false``, the k-NN filter, the
  ``filter`` aggregations), and no per-request column enters the
  searcher's prepare cache.

- A numpy model of the fold (per tile, per slot in slot order, the row's
  sub-range of the tile found by a lower bound, ``w * (idf * imp)``
  added in float32 from 0.0) equals the plain versions byte for byte
  (``impact_scores_plain``, ``impact_score_count_plain``,
  ``match_count_plain`` and their quantized twins), at the kernel's tile
  and at a tile of 16 docs (many tiles, rows crossing tile bounds).
- The plain per-slot versions equal the JAX package's
  ``impact_score_count`` / ``match_count`` and its quantized ops, on the
  f32, int8 and int16 layouts.
- The wrappers refuse CPU tensors (a CUDA tensor gets the kernel or an
  exception; the dispatchers take the plain version for CPU tensors
  only), and the replaced per-slot route is gone from the port.
"""

import json
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opensearch_tpu.ops import bm25 as jbm25
from opensearch_tpu.ops import filters as jfilters
from opensearch_tpu.ops import quantized as jquant
from opensearch_tpu_torch.index.codec import unpack_doc_ids
from opensearch_tpu_torch.ops import bm25 as tbm25
from opensearch_tpu_torch.ops import cuda_bm25
from opensearch_tpu_torch.ops import quantized as tquant
from opensearch_tpu_torch.testing.parity import bm25_mismatch
from test_torch_ops import CASES, both, case_bag, csr_case
from test_torch_quantized import quant_case

ROOT = pathlib.Path(__file__).resolve().parents[1]


def fold_model(offsets, docs, imps, tids, active, idfs, weights, n_pad,
               tile):
    """The fold kernel's arithmetic in numpy: ``(scores f32 [n_pad],
    counts i32 [n_pad])`` built tile by tile, each slot's part of a tile
    found by a lower bound over its doc-ascending row, slots added in
    slot order from 0.0."""
    scores = np.empty(n_pad, np.float32)
    counts = np.empty(n_pad, np.int32)
    for b in range(-(-n_pad // tile)):
        doc0 = b * tile
        acc = np.zeros(tile, np.float32)
        cnt = np.zeros(tile, np.int32)
        for j in range(len(tids)):
            if not active[j]:
                continue
            start, end = int(offsets[tids[j]]), int(offsets[tids[j] + 1])
            row = docs[start:end]
            lo = start + int(np.searchsorted(row, doc0, "left"))
            hi = start + int(np.searchsorted(row, doc0 + tile, "left"))
            d = docs[lo:hi] - doc0
            contrib = np.float32(weights[j]) * (np.float32(idfs[j])
                                                * imps[lo:hi])
            acc[d] = acc[d] + contrib.astype(np.float32)
            cnt[d] += 1
        n = min(tile, n_pad - doc0)
        scores[doc0: doc0 + n] = acc[:n]
        counts[doc0: doc0 + n] = cnt[:n]
    return scores, counts


@pytest.mark.parametrize("tile", [16, cuda_bm25.FOLD_TILE_DOCS])
@pytest.mark.parametrize("case", CASES)
def test_fold_model_equals_the_plain_f32_versions(case, tile):
    c = csr_case(*case)
    names = ("offsets", "doc_ids", "impacts", "tids", "active", "idfs",
             "weights")
    _j, t = both(c, *names)
    kw = dict(n_pad=c["n_pad"], budget=c["budget"])
    s_m, c_m = fold_model(c["offsets"], c["doc_ids"], c["impacts"],
                          c["tids"], c["active"], c["idfs"], c["weights"],
                          c["n_pad"], tile)
    s_p, c_p = tbm25.impact_score_count_plain(*t, **kw, scored=True)
    assert s_m.tobytes() == s_p.numpy().tobytes()
    assert c_m.tobytes() == c_p.numpy().tobytes()
    assert s_m.tobytes() == tbm25.impact_scores_plain(
        *t, **kw).numpy().tobytes()
    _jm, tm = both(c, "offsets", "doc_ids", "tfs", "tids", "active")
    assert c_m.tobytes() == tbm25.match_count_plain(
        *tm, **kw).numpy().tobytes()


@pytest.mark.parametrize("tile", [16, cuda_bm25.FOLD_TILE_DOCS])
@pytest.mark.parametrize("dtype,seed", [("int8", 3), ("int16", 33)])
def test_fold_model_equals_the_plain_quantized_versions(dtype, seed, tile,
                                                        monkeypatch):
    dseg, q, qt, tids, active, idfs, weights, budget = quant_case(
        seed, dtype, monkeypatch)
    offsets = dseg.postings["body"]["offsets"]
    host_off = np.asarray(qt._offsets)
    docs = unpack_doc_ids(qt.packed, qt.base, host_off, qt.width)
    np.testing.assert_array_equal(docs, dseg.seg.postings["body"].doc_ids)
    s_m, c_m = fold_model(host_off, docs, qt.dequantized(), tids, active,
                          idfs, weights, dseg.n_pad, tile)
    args = (offsets, q["packed"], q["base"], q["qvals"], q["scales"],
            q["exact_vals"], q["exact_offsets"], torch.from_numpy(tids),
            torch.from_numpy(active), torch.from_numpy(idfs),
            torch.from_numpy(weights))
    kw = dict(width=qt.width, n_pad=dseg.n_pad, budget=budget)
    s_p, c_p = tquant.quantized_impact_score_count_plain(*args, **kw,
                                                         scored=True)
    assert s_m.tobytes() == s_p.numpy().tobytes()
    assert c_m.tobytes() == c_p.numpy().tobytes()
    assert s_m.tobytes() == tquant.quantized_impact_scores_plain(
        *args, **kw).numpy().tobytes()
    assert bool((c_m >= 2).any())         # slot order matters here


@pytest.mark.parametrize("case", CASES)
def test_plain_f32_versions_equal_the_reference(case):
    c = csr_case(*case)
    names = ("offsets", "doc_ids", "impacts", "tids", "active", "idfs",
             "weights")
    j, t = both(c, *names)
    kw = dict(n_pad=c["n_pad"], budget=c["budget"])
    for scored in (True, False):
        rs, rc = jbm25.impact_score_count(*j, **kw, scored=scored)
        gs, gc = tbm25.impact_score_count_plain(*t, **kw, scored=scored)
        assert np.asarray(rs).tobytes() == gs.numpy().tobytes()
        assert np.asarray(rc).tobytes() == gc.numpy().tobytes()
    jm, tm = both(c, "offsets", "doc_ids", "tfs", "tids", "active")
    assert np.asarray(jbm25.match_count(*jm, **kw)).tobytes() == \
        tbm25.match_count_plain(*tm, **kw).numpy().tobytes()


@pytest.mark.parametrize("dtype,seed", [("int8", 5), ("int16", 7)])
def test_plain_quantized_versions_equal_the_reference(dtype, seed,
                                                      monkeypatch):
    dseg, q, qt, tids, active, idfs, weights, budget = quant_case(
        seed, dtype, monkeypatch)
    offsets = dseg.postings["body"]["offsets"]
    names = ("qvals", "scales", "exact_vals", "exact_offsets")
    t_args = (offsets, q["packed"], q["base"], *(q[n] for n in names),
              torch.from_numpy(tids), torch.from_numpy(active),
              torch.from_numpy(idfs), torch.from_numpy(weights))
    j_args = (jnp.asarray(offsets.numpy()),
              jnp.asarray(q["packed"].numpy().view(np.uint32)),
              jnp.asarray(q["base"].numpy()),
              *(jnp.asarray(q[n].numpy()) for n in names),
              jnp.asarray(tids), jnp.asarray(active), jnp.asarray(idfs),
              jnp.asarray(weights))
    kw = dict(width=qt.width, n_pad=dseg.n_pad, budget=budget)
    for scored in (True, False):
        gs, gc = tquant.quantized_impact_score_count_plain(
            *t_args, **kw, scored=scored)
        rs, rc = jquant.quantized_impact_score_count(*j_args, **kw,
                                                     scored=scored)
        assert gs.numpy().tobytes() == np.asarray(rs).tobytes()
        assert gc.numpy().tobytes() == np.asarray(rc).tobytes()


def test_dense_wrappers_refuse_cpu_tensors(monkeypatch):
    c = csr_case(17, 300, 40, 5, 1)
    before = cuda_bm25.dense_f32.launches
    for scores, counts in ((True, True), (True, False), (False, True)):
        with pytest.raises(ValueError, match="CUDA"):
            cuda_bm25.term_bag_dense_cuda([case_bag(c, scores)],
                                          scores=scores, counts=counts)
    assert cuda_bm25.dense_f32.launches == before
    bag = quant_bag(*quant_case(3, "int8", monkeypatch))
    before = cuda_bm25.dense_quantized.launches
    with pytest.raises(ValueError, match="CUDA"):
        cuda_bm25.term_bag_dense_cuda([bag], scores=True, counts=False)
    assert cuda_bm25.dense_quantized.launches == before


def test_replaced_route_is_gone_from_the_port():
    """The per-slot route the fold replaced is deleted: no file of the
    port (sources, kernels, the sweeps) and not ``chip_smoke.py`` names
    its kernel, its C entries or the macro that built them."""
    names = ("term_bag_slot_kernel", "slot_launch", "BM25_SLOT_ROUTE")
    files = [ROOT / "chip_smoke.py"] + sorted(
        p for p in (ROOT / "opensearch_tpu_torch").rglob("*")
        if p.suffix in (".py", ".cu", ".cuh"))
    assert len(files) > 20
    offenders = [f"{p.relative_to(ROOT)}: {name}" for p in files
                 for name in names if name in p.read_text()]
    assert not offenders, offenders
    assert "BM25_SLOT_ROUTE" not in cuda_bm25.defines()


# -- the table form (one launch per request and row layout) ----------------

def quant_bag(dseg, q, qt, tids, active, idfs, weights, budget):
    """A ``quant_case`` as the dense entry's quantized bag (what
    ``TermBagPlan.dense_bag`` makes on the quantized lowering)."""
    host_off = np.asarray(qt._offsets)
    rows = np.stack([host_off[tids], host_off[tids + 1]],
                    axis=1).astype(np.int64)
    e0, e1 = qt.exact_offsets[tids], qt.exact_offsets[tids + 1]
    quant = tbm25.QuantizedBag(
        q["qvals"], q["scales"], q["exact_vals"], q["exact_offsets"],
        q["packed"], q["base"], int(qt.width),
        qt.base[tids].astype(np.int64), qt.scales[tids],
        np.where(e1 > e0, e0, -1).astype(np.int64))
    return tbm25.DenseBag(dseg.postings["body"]["offsets"], None, None,
                          dseg.n_pad, tids, active, idfs, weights, rows,
                          budget, quant)


def absent_bag(n_pad: int, scores: bool) -> tbm25.DenseBag:
    """A segment without the field: ``build_arrays``' stand-in postings
    (``executor._dummy_for``) and a bag of no active slot."""
    from opensearch_tpu_torch.search.executor import _dummy_for

    class _Seg:
        device = torch.device("cpu")
    dseg = _Seg()
    dseg.n_pad = n_pad
    p = _dummy_for("postings", "body", dseg, None)
    zeros = np.zeros(2, np.float32)
    return tbm25.DenseBag(p["offsets"], p["doc_ids"],
                          torch.zeros(8) if scores else None, n_pad,
                          np.zeros(2, np.int32), np.zeros(2, bool), zeros,
                          zeros, np.zeros((2, 2), np.int64), 8)


def _f32(word) -> np.float32:
    return np.array([word & 0xFFFFFFFF], np.uint32).view(np.float32)[0]


def _i32(word) -> int:
    return int(np.array([word & 0xFFFFFFFF], np.uint32).view(np.int32)[0])


def run_dense_table(table, n_seg, n_slots, n_blocks, q_bytes, memory,
                    out_s, out_c, tile):
    """``term_bag_dense_kernel`` in numpy: every block of the work list
    reads its segment's entry and its slots' words from ``table`` alone
    (``memory`` maps the row pointers to host arrays), finds each slot's
    part of its tile by a lower bound over the row, adds ``w * (idf *
    imp)`` in float32 from 0.0 in slot order, counts the matched slots,
    and writes the tile at the segment's output offset."""
    u = [int(w) & (2 ** 64 - 1) for w in table.tolist()]
    seg_words = cuda_bm25.QSEG_WORDS if q_bytes else cuda_bm25.SEG_WORDS
    slot_words = cuda_bm25.QSLOT_WORDS if q_bytes else 2
    slot0 = n_seg * seg_words
    work = slot0 + slot_words * n_slots
    assert len(u) == work + n_blocks          # no counters in this table
    for wk in u[work:]:
        seg, t = wk >> 32, wk & 0xFFFFFFFF
        e = u[seg * seg_words: (seg + 1) * seg_words]
        doc0 = t * tile
        docs = min(tile, e[3] - doc0)
        acc = np.zeros(tile, np.float32)
        cnt = np.zeros(tile, np.int32)
        for j in range(e[8]):
            sl = u[slot0 + (e[7] + j) * slot_words:
                   slot0 + (e[7] + j + 1) * slot_words]
            start, end = sl[0] & 0xFFFFFFFF, sl[0] >> 32
            idf, w = _f32(sl[1]), _f32(sl[1] >> 32)
            p = np.arange(start, end, dtype=np.int64)
            if q_bytes:
                packed = memory[e[0]].view(np.uint32).astype(np.uint64)
                width = e[12]
                bit = (p & 31) * width
                at = (p >> 5) * width + (bit >> 5)
                pair = packed[at] | (packed[at + 1] << np.uint64(32))
                delta = (pair >> (bit & 31).astype(np.uint64)) \
                    & np.uint64((1 << width) - 1)
                row = _i32(sl[2]) + delta.astype(np.int64)
                if sl[3] >> 32:
                    imp = memory[e[11]][_i32(sl[3]) - start + p]
                else:
                    imp = memory[e[1]][p].astype(np.float32) \
                        * _f32(sl[2] >> 32)
            else:
                row = memory[e[0]][p]
                imp = memory[e[1]][p] if e[1] else None
            lo = int(np.searchsorted(row, doc0, "left"))
            hi = int(np.searchsorted(row, doc0 + tile, "left"))
            d = row[lo:hi] - doc0
            if out_s is not None:
                acc[d] = acc[d] + w * (idf * imp[lo:hi])
            cnt[d] += 1
        at = e[6] + doc0
        if out_s is not None:
            out_s[at: at + docs] = acc[:docs]
        if out_c is not None:
            out_c[at: at + docs] = cnt[:docs]


def model_dense(bags, scores, counts, tile):
    """The dense call in numpy: ``dense_launches``' tables, each run by
    ``run_dense_table``; each bag's views of the arenas."""
    memory = {}
    for b in bags:
        arrays = ((b.quant.packed, b.quant.qvals, b.quant.exact_vals)
                  if b.quant is not None else (b.doc_ids, b.impacts))
        for a in arrays:
            if a is not None:
                memory[a.data_ptr()] = a.numpy()
    offsets, launches = cuda_bm25.dense_launches(bags, scores)
    out_s = np.full(offsets[-1], np.nan, np.float32) if scores else None
    out_c = np.full(offsets[-1], -1, np.int32) if counts else None
    for idx, table, n_blocks, n_slots, q_bytes in launches:
        run_dense_table(table, len(idx), n_slots, n_blocks, q_bytes, memory,
                        out_s, out_c, tile)
    return [(None if out_s is None else out_s[a:b],
             None if out_c is None else out_c[a:b])
            for a, b in zip(offsets[:-1], offsets[1:])]


def mixed_bags(monkeypatch, scores):
    """f32 segments (n_pad 128 to 4,096: below and above one tile), one
    without the field, one whose slots are all inactive, and an int8 and
    an int16 quantized one (their slots scored: quantized bags are never
    counts only), with each f32 bag's ``csr_case``."""
    cases = [csr_case(*case) for case in CASES]
    cases.append(csr_case(23, 700, 30, 4, 4))          # every slot inactive
    f32 = [case_bag(c, scores) for c in cases]
    quant = []
    if scores:
        for dtype, seed in (("int8", 3), ("int16", 33)):
            quant.append(quant_bag(*quant_case(seed, dtype, monkeypatch)))
    bags = [f32[0], absent_bag(512, scores), *quant[:1], *f32[1:],
            *quant[1:]]
    return bags, list(zip(f32, cases))


@pytest.mark.parametrize("tile", [16, cuda_bm25.FOLD_TILE_DOCS])
@pytest.mark.parametrize("mode", ["scores", "scores+counts", "counts"])
def test_table_model_equals_the_plain_versions(mode, tile, monkeypatch):
    scores, counts = mode != "counts", mode != "scores"
    bags, f32 = mixed_bags(monkeypatch, scores)
    monkeypatch.setattr(cuda_bm25, "FOLD_TILE_DOCS", tile)
    got = model_dense(bags, scores, counts, tile)
    want = tbm25.term_bag_dense(bags, scores=scores, counts=counts)
    assert len(got) == len(want) == len(bags)
    for (gs, gc), (ws, wc), bag in zip(got, want, bags):
        for g, w in ((gs, ws), (gc, wc)):
            assert (g is None) == (w is None)
            if g is not None:
                assert g.tobytes() == w.numpy().tobytes()
        if gc is not None and not np.asarray(bag.active).any():
            assert not gc.any()
        if gs is not None and not np.asarray(bag.active).any():
            assert not gs.any()
    assert any(q.quant is not None for q in bags) == scores
    # through the plain versions, the JAX package's ops
    for (gs, gc), bag in zip(got, bags):
        if bag.quant is None or not counts:
            continue
        # the quantized ones: quantized_impact_score_count
        q = bag.quant
        j_args = (jnp.asarray(bag.offsets.numpy()),
                  jnp.asarray(q.packed.numpy().view(np.uint32)),
                  jnp.asarray(q.base.numpy()), jnp.asarray(q.qvals.numpy()),
                  jnp.asarray(q.scales.numpy()),
                  jnp.asarray(q.exact_vals.numpy()),
                  jnp.asarray(q.exact_offsets.numpy()),
                  jnp.asarray(bag.term_ids), jnp.asarray(bag.active),
                  jnp.asarray(bag.idfs), jnp.asarray(bag.weights))
        rs, rc = jquant.quantized_impact_score_count(
            *j_args, width=q.width, n_pad=bag.n_pad, budget=bag.budget,
            scored=True)
        assert gs.tobytes() == np.asarray(rs).tobytes()
        assert gc.tobytes() == np.asarray(rc).tobytes()
    for bag, c in f32:
        (gs, gc), = model_dense([bag], scores, counts, tile)
        kw = dict(n_pad=c["n_pad"], budget=c["budget"])
        if scores:
            j, _t = both(c, "offsets", "doc_ids", "impacts", "tids",
                         "active", "idfs", "weights")
            rs, rc = jbm25.impact_score_count(*j, **kw, scored=True)
            assert gs.tobytes() == np.asarray(rs).tobytes()
        if counts:
            jm, _t = both(c, "offsets", "doc_ids", "tfs", "tids", "active")
            rc = jbm25.match_count(*jm, **kw)
            assert gc.tobytes() == np.asarray(rc).tobytes()
            assert ((gc > 0) == np.asarray(jfilters.postings_mask(
                *jm, **kw))).all()


def test_dense_launch_table_layout(monkeypatch):
    """``dense_launches``: one table per row layout present (f32, then
    int8 and int16 in order of first appearance), each segment's entry
    {row pointers, -, n_pad, first tile, tiles, output offset, first
    slot, slots}, the active slots' words in slot order, the work list
    ``segment << 32 | tile`` over ``FOLD_TILE_DOCS`` tiles, no
    counters; the arena offsets every segment's n_pad end to end."""
    bags, _pairs = mixed_bags(monkeypatch, True)
    offsets, launches = cuda_bm25.dense_launches(bags, True)
    n_pads = [b.n_pad for b in bags]
    assert offsets.tolist() == np.concatenate(
        [[0], np.cumsum(n_pads)]).tolist()
    layouts = [None if b.quant is None else b.quant.qvals.dtype
               for b in bags]
    assert [q for _i, _t, _b, _s, q in launches] == [0, 1, 2]
    assert sorted(i for idx, *_r in launches for i in idx) == \
        list(range(len(bags)))
    tile = cuda_bm25.FOLD_TILE_DOCS
    for idx, table, n_blocks, n_slots, q_bytes in launches:
        assert len({layouts[i] for i in idx}) == 1
        seg_words = cuda_bm25.QSEG_WORDS if q_bytes else cuda_bm25.SEG_WORDS
        slot_words = cuda_bm25.QSLOT_WORDS if q_bytes else 2
        n_seg = len(idx)
        head = table[: n_seg * seg_words].reshape(n_seg, seg_words)
        tiles = [max(1, -(-n_pads[i] // tile)) for i in idx]
        assert n_blocks == sum(tiles)
        assert n_slots == sum(int(np.asarray(bags[i].active).sum())
                              for i in idx)
        assert len(table) == n_seg * seg_words + slot_words * n_slots \
            + n_blocks
        first, slot = 0, 0
        for r, i in enumerate(idx):
            b = bags[i]
            rows = ((b.quant.packed, b.quant.qvals) if b.quant is not None
                    else (b.doc_ids, b.impacts))
            assert head[r, 0] == rows[0].data_ptr()
            assert head[r, 1] == rows[1].data_ptr()
            assert head[r, 3] == b.n_pad and head[r, 6] == offsets[i]
            assert (head[r, 4], head[r, 5]) == (first, tiles[r])
            assert (head[r, 7], head[r, 8]) == (slot, int(
                np.asarray(b.active).sum()))
            if b.quant is not None:
                assert head[r, 11] == b.quant.exact_vals.data_ptr()
                assert head[r, 12] == b.quant.width
            words = table[n_seg * seg_words + slot_words * slot:
                          n_seg * seg_words + slot_words * (slot + head[r, 8])]
            words = words.reshape(-1, slot_words)
            act = np.flatnonzero(b.active)
            assert (words[:, 0] == b.rows[act, 0]
                    | (b.rows[act, 1] << 32)).all()
            assert [_f32(int(w)) for w in words[:, 1]] == \
                list(b.idfs[act])
            work = table[n_seg * seg_words + slot_words * n_slots
                         + first: n_seg * seg_words + slot_words * n_slots
                         + first + tiles[r]]
            assert work.tolist() == [(r << 32) | t for t in range(tiles[r])]
            first += tiles[r]
            slot += head[r, 8]
    _o, counts_only = cuda_bm25.dense_launches(bags[:2], False)
    assert (counts_only[0][1][1: 2 * cuda_bm25.SEG_WORDS:
                               cuda_bm25.SEG_WORDS] == 0).all()


def test_prepass_launches_each_leaf_once_over_every_segment(monkeypatch):
    """A ``bool`` of a scored ``match``, a ``should`` term bag in ``and``
    form, a ``term`` filter bag and a ``terms`` filter (``PostingsMask``)
    under ``constant_score``: the searcher calls the dense entry once per
    leaf, each time over every segment it evaluates, in ``search``,
    ``count`` and an aggregations request; answers equal the JAX
    package's; no column of those calls enters the prepare cache."""
    from opensearch_tpu.index.segment import SegmentWriter as JaxWriter
    from opensearch_tpu.mapping.mapper import DocumentMapper as JaxMapper
    from opensearch_tpu.search.executor import ShardSearcher as JaxSearcher
    from opensearch_tpu_torch.index.segment import (segment_arrays,
                                                    segment_from_arrays)
    from opensearch_tpu_torch.mapping.mapper import DocumentMapper
    from opensearch_tpu_torch.search import plan as tplan
    from opensearch_tpu_torch.search.executor import ShardSearcher
    from test_torch_filters import MAPPING, build, filter_docs

    monkeypatch.setattr(jbm25, "HOST_SCORING", False)
    jsegs = build(JaxWriter(), JaxMapper(MAPPING), filter_docs(4, 200))
    jax_s = JaxSearcher(jsegs, JaxMapper(MAPPING))
    port_s = ShardSearcher([segment_from_arrays(*segment_arrays(s))
                            for s in jsegs], DocumentMapper(MAPPING),
                           device="cpu")
    calls = []
    real = tbm25.term_bag_dense_auto

    def recording(bags, **mode):
        out = real(bags, **mode)
        calls.append((len(bags), mode, out))
        return out

    monkeypatch.setattr(tbm25, "term_bag_dense_auto", recording)
    body = {"query": {"bool": {
        "must": [{"match": {"body": "w1 w2"}}],
        "should": [{"match": {"body": {"query": "w3 w0",
                                       "operator": "and"}}}],
        "filter": [{"term": {"tag": "g1"}},
                   {"constant_score": {"filter": {
                       "terms": {"tag": ["g1", "g2"]}}}}]}},
        "size": 5}
    n_seg = len(port_s.segments)
    got = port_s.search(dict(body))
    assert [c[0] for c in calls] == [n_seg] * 4
    assert [c[1] for c in calls] == [
        dict(scores=True, counts=False), dict(scores=True, counts=True),
        dict(scores=False, counts=True), dict(scores=False, counts=True)]
    want = jax_s.search(dict(body))
    assert got["hits"]["hits"] and not bm25_mismatch(got, want)
    calls.clear()
    assert port_s.count(body["query"]) == jax_s.count(body["query"])
    assert len(calls) == 4
    calls.clear()
    port_s.search({**body, "aggs": {"t": {"terms": {"field": "tag"}}}})
    assert [c[0] for c in calls] == [n_seg] * 4
    views = {id(t) for _n, _m, out in calls for pair in out for t in pair
             if t is not None}
    ptrs = {t.untyped_storage().data_ptr() for _n, _m, out in calls
            for pair in out for t in pair if t is not None}

    def tensors(x):
        if isinstance(x, torch.Tensor):
            yield x
        elif isinstance(x, (tuple, list)):
            for y in x:
                yield from tensors(y)
        elif isinstance(x, dict):
            for y in x.values():
                yield from tensors(y)

    cached = list(tensors(port_s._prep_cache.values()))
    assert cached and views
    assert not any(id(t) in views or t.untyped_storage().data_ptr() in ptrs
                   for t in cached)
    assert tplan.TermBagPlan(field="body").dense_leaves((), ()) == (
        (tplan.TermBagPlan(field="body"), (), ()),)


def test_segment_by_segment_routes_launch_each_leaf_once(monkeypatch):
    """The routes that evaluate a plan segment by segment take their
    term-bag leaves from one dense call over every segment too:
    ``track_total_hits: false`` (one call per leaf, then a plan top-k a
    segment), the k-NN filter (one call over the segments with the
    vector field) and the ``filter`` / ``filters`` aggregations' masks
    (one call per filter); answers equal the JAX package's."""
    from opensearch_tpu.index.segment import SegmentWriter as JaxWriter
    from opensearch_tpu.mapping.mapper import DocumentMapper as JaxMapper
    from opensearch_tpu.search.executor import ShardSearcher as JaxSearcher
    from opensearch_tpu_torch.index.segment import (segment_arrays,
                                                    segment_from_arrays)
    from opensearch_tpu_torch.mapping.mapper import DocumentMapper
    from opensearch_tpu_torch.search.executor import ShardSearcher
    from opensearch_tpu_torch.testing.parity import knn_mismatch
    from test_torch_filters import MAPPING, build, filter_docs

    monkeypatch.setattr(jbm25, "HOST_SCORING", False)
    jsegs = build(JaxWriter(), JaxMapper(MAPPING), filter_docs(9, 200))
    jax_s = JaxSearcher(jsegs, JaxMapper(MAPPING))
    port_s = ShardSearcher([segment_from_arrays(*segment_arrays(s))
                            for s in jsegs], DocumentMapper(MAPPING),
                           device="cpu")
    calls = []
    real = tbm25.term_bag_dense_auto
    monkeypatch.setattr(tbm25, "term_bag_dense_auto",
                        lambda bags, **mode: (calls.append(len(bags)),
                                              real(bags, **mode))[1])
    n_seg = len(port_s.segments)
    bool_q = {"bool": {"must": [{"match": {"body": "w1 w2"}}],
                       "filter": [{"term": {"tag": "g1"}}]}}
    got = port_s.search({"query": bool_q, "size": 5,
                         "track_total_hits": False})
    assert calls == [n_seg, n_seg]
    want = jax_s.search({"query": bool_q, "size": 5,
                         "track_total_hits": False})
    assert got["hits"]["hits"] and not bm25_mismatch(got, want)
    calls.clear()
    knn = {"knn": {"vec": {"vector": [0.1, -0.2, 0.3, 0.0], "k": 7,
                           "filter": {"match": {"body": "w1 w0"}}}}}
    got = port_s.search({"query": knn, "size": 7})
    assert calls == [n_seg]
    want = jax_s.search({"query": knn, "size": 7})
    assert got["hits"]["hits"] and not knn_mismatch(got, want)
    calls.clear()
    aggs = {"f": {"filter": {"match": {"body": "w2"}}},
            "fs": {"filters": {"filters": {
                "a": {"term": {"tag": "g2"}},
                "b": {"terms": {"tag": ["g1", "g3"]}}}}}}
    got = port_s.search({"size": 0, "aggs": aggs})
    assert calls == [n_seg] * 3
    want = jax_s.search({"size": 0, "aggs": aggs})
    assert got["aggregations"] == json.loads(json.dumps(
        want["aggregations"]))


def test_replaced_dense_kernel_builds_only_into_the_sweep():
    """The per-segment dense kernel the table form replaced is compiled
    only under ``-DBM25_OLD_FOLD`` (``testing/k2_sweep.py``'s library):
    the product's defines lack the flag, every line of ``bm25.cu`` that
    names it or its entries sits inside an ``#ifdef BM25_OLD_FOLD`` block,
    and no port module but the sweep names its entries."""
    assert "BM25_OLD_FOLD" not in cuda_bm25.defines()
    src = (ROOT / "opensearch_tpu_torch" / "csrc" / "bm25.cu").read_text()
    inside, seen = False, 0
    for line in src.splitlines():
        if line.startswith("#ifdef BM25_OLD_FOLD"):
            inside = True
        elif line.startswith("#endif  // BM25_OLD_FOLD"):
            inside = False
        elif any(n in line for n in ("term_bag_fold_kernel<",
                                     "fold_launch(", "term_bag_launch(",
                                     "term_bag_quantized_launch(")):
            assert inside or line.startswith("//"), line
            seen += 1
    assert seen >= 4 and not inside
    names = ("term_bag_launch", "term_bag_quantized_launch", "BM25_OLD_FOLD")
    offenders = [str(p.relative_to(ROOT)) for p in
                 (ROOT / "opensearch_tpu_torch").rglob("*.py")
                 if p.name != "k2_sweep.py"
                 and any(n in p.read_text() for n in names)]
    assert not offenders, offenders
