"""The batched search path of the PyTorch port (on the CPU, through K3's
plain twin) against the JAX package's: ``batch_impact_union_topk``,
``ShardSearcher.msearch``, K3's launch table, the continuous batcher and
the engine's threadpool, and the searcher's cache lock.

Every comparison of scores is byte for byte.  The JAX side runs its
device lowering (``HOST_SCORING = False``), as ``tests/test_impacts.py``
does.
"""

import json
import sys
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opensearch_tpu.ops import bm25 as jbm25
from opensearch_tpu.search import batch as jbatch
from opensearch_tpu.search.executor import ShardSearcher as JaxSearcher
from opensearch_tpu_torch.common.cache import BoundedCache
from opensearch_tpu_torch.index.segment import (SegmentWriter, pad_bucket,
                                                segment_arrays,
                                                segment_from_arrays)
from opensearch_tpu_torch.mapping.mapper import DocumentMapper
from opensearch_tpu_torch.ops import bm25 as tbm25
from opensearch_tpu_torch.ops import cuda_bm25
from opensearch_tpu_torch.search import batch as tbatch
from opensearch_tpu_torch.search import engine as engine_mod
from opensearch_tpu_torch.search import executor as texec
from opensearch_tpu_torch.search.executor import ShardSearcher
from opensearch_tpu_torch.testing import k3_sweep
from opensearch_tpu_torch.testing.parity import bm25_mismatch
from test_torch_ops import bag_corpus
from test_torch_search import (MAPPING, SEG_SIZES, build, json_docs,
                               quantized_size_searchers)


@pytest.fixture(scope="module")
def bag_searchers():
    return bag_corpus()


def bind_of(jax_s, terms, required=1, weights=None):
    """A term bag's bindings on the JAX searcher's statistics (the port's
    are the same: both carry the same segments)."""
    ctx = jax_s.ctx
    stats = ctx.field_stats("body")
    idfs = np.asarray([jbm25.idf(ctx.df("body", t), stats.doc_count)
                       for t in terms], np.float32)
    w = np.ones(len(terms), np.float32) if weights is None else \
        np.asarray(weights, np.float32)
    return {"terms": tuple(terms), "idfs": idfs, "weights": w,
            "avgdl": stats.avgdl, "required": required}


# (binds, need_counts): an OR batch (scores > 0 is the match mask), the
# same batch with counts, and batches that need counts: AND and
# minimum_should_match, a term named twice in one query (both count for
# AND), a negative weight, a term absent from one segment
BATCHES = {
    "or": ([(["w0", "w1"], 1, None), (["w3"], 1, None),
            (["w1", "w5", "w2"], 1, None)], False),
    "or-counted": ([(["w0", "w1"], 1, None), (["w3"], 1, None),
                    (["w1", "w5", "w2"], 1, None)], True),
    "and-msm": ([(["w0", "w2"], 2, None),
                 (["w0", "w1", "w4", "w5"], 2, None),
                 (["w6"], 1, None)], True),
    "duplicate": ([(["w0", "w0", "w3"], 3, None), (["w3", "w3"], 2, None),
                   (["w1", "w1"], 1, None)], True),
    "negative": ([(["w0", "w1", "w2"], 1, [1.0, -0.5, 1.0]),
                  (["w2"], 1, [-1.0])], True),
    "absent": ([(["w39", "w0"], 1, None), (["nope"], 1, None)], True),
}


def port_group(port_s, binds):
    group = tbatch.BatchGroup("body", 10)
    for i, b in enumerate(binds):
        group.add(i, b)
    return group


def batch_binds(jax_s, name):
    return [bind_of(jax_s, t, r, w) for t, r, w in BATCHES[name][0]]


@pytest.mark.parametrize("k", ["1", "10", "n_pad"])
@pytest.mark.parametrize("name", list(BATCHES))
def test_plain_twin_matches_jax_batch_impact_union_topk(name, k,
                                                        bag_searchers):
    """The port's ``batch_impact_union_topk`` against the reference's, on
    the same union and query-slot arrays of every segment (deleted docs,
    padding rows, duplicate terms, a negative weight): vals, idx, totals
    and maxes equal, float32 byte for byte."""
    jax_s, port_s = bag_searchers
    binds = batch_binds(jax_s, name)
    need_counts = BATCHES[name][1]
    prep = port_group(port_s, binds)._prepare(port_s)
    assert prep["segs"]
    if not need_counts:
        assert not prep["need_counts"]
    req = prep["required"]
    assert np.isinf(req[len(binds):]).all()          # padding rows
    for seg in prep["segs"]:
        n_pad = seg.live.shape[0]
        kk = {"1": 1, "10": 10, "n_pad": n_pad}[k]
        kw = dict(n_pad=n_pad, budget=seg.budget, k=kk,
                  need_counts=need_counts)
        host = (seg.offsets.numpy(), seg.doc_ids.numpy(),
                seg.impacts.numpy(), seg.live.numpy(), seg.union_tids,
                seg.union_active, seg.union_idfs, seg.qslots,
                seg.qweights, seg.qact, req)
        ref = jbatch.batch_impact_union_topk(
            *(jnp.asarray(a) for a in host), **kw)
        got = tbatch.batch_impact_union_topk(
            *(torch.from_numpy(np.ascontiguousarray(a)) for a in host),
            **kw)
        rv, ri, rt, rm = (np.asarray(x) for x in ref)
        gv, gi, gt, gm = (x.numpy() for x in got)
        assert gv.shape == rv.shape == (req.shape[0], kk)
        assert gv.tobytes() == rv.tobytes()
        assert gi.astype(np.int64).tolist() == ri.astype(np.int64).tolist()
        assert gt.tolist() == rt.tolist()
        assert gm.tobytes() == rm.astype(np.float32).tobytes()
        assert rt[: len(binds)].sum() > 0 or name == "absent"


@pytest.mark.parametrize("name", list(BATCHES))
def test_plain_twin_equals_the_sequential_topk_per_query(name,
                                                         bag_searchers):
    """Each (query, segment) row of the batched plain version equals the
    sequential plain top-k of that query alone (K2's twin), byte for
    byte: batched and sequential scores agree."""
    jax_s, port_s = bag_searchers
    binds = batch_binds(jax_s, name)
    from test_torch_ops import port_bag_inputs

    for k in (1, 10, 200):
        prep = port_group(port_s, binds)._prepare(port_s)
        got = tbatch.batch_term_bag_topk_segments(
            prep["segs"], prep["required"], n_queries=len(binds), k=k,
            need_counts=prep["need_counts"]).numpy()
        n_seg = len(prep["segs"])
        for q, bind in enumerate(binds):
            inputs = port_bag_inputs(port_s, bind)
            ref = tbm25.term_bag_topk_segments(
                [inputs[int(s)] for s in prep["order"]], k=k).numpy()
            rows = slice(q * n_seg, (q + 1) * n_seg)
            for what, a, b in zip(("vals", "ids", "totals", "maxes"),
                                  (got[0][rows], got[1][rows],
                                   got[2][rows], got[3][rows]), ref):
                assert a.tobytes() == b.tobytes(), (name, k, q, what)


def test_auto_takes_the_plain_twin_on_cpu_and_the_wrapper_refuses_it(
        bag_searchers):
    jax_s, port_s = bag_searchers
    binds = batch_binds(jax_s, "and-msm")
    prep = port_group(port_s, binds)._prepare(port_s)
    assert prep["table"] is None             # no table on the CPU
    kw = dict(n_queries=len(binds), k=10, need_counts=True)
    a = tbatch.batch_term_bag_topk_auto(prep["segs"], prep["required"], **kw)
    b = tbatch.batch_term_bag_topk_segments(prep["segs"], prep["required"],
                                            **kw)
    assert a.packed.device.type == "cpu"
    assert all(x.tobytes() == y.tobytes()
               for x, y in zip(a.numpy(), b.numpy()))
    with pytest.raises(ValueError, match="CUDA"):
        cuda_bm25.batch_term_bag_topk_cuda(prep["segs"], prep["required"],
                                           **kw)
    for k in (0, cuda_bm25.K_MAX + 1):
        with pytest.raises(ValueError, match="k must be"):
            cuda_bm25.batch_term_bag_topk_cuda(
                prep["segs"], prep["required"], **{**kw, "k": k})
    assert cuda_bm25.batch_term_bag_topk_cuda.launches == 0


# -- the replaced route's table (testing/k3_sweep.py, the chip's yardstick) --

def test_batch_table_has_one_entry_per_query_and_segment():
    """The table of the route K3 replaced (``k3_sweep.batch_table``) is
    K2's ``launch_table`` with one entry per (query, segment),
    segment-major, entry (s, q) writing row q * S + s: the
    segment's pointers and n_pad, the query's present slots in term order
    (its union slot's range and idf, its own weight; a duplicate term is
    two slots), its required count, ``fast`` = not need_counts; then the
    work list and the zeroed counters."""
    T = cuda_bm25.TILE_DOCS
    W = cuda_bm25.SEG_WORDS

    def seg(n_pad, rows, idfs, qslots, qweights, qact):
        return tbm25.BatchSegment(
            torch.zeros(4, dtype=torch.int32),
            torch.zeros(8, dtype=torch.int32), torch.zeros(8),
            torch.ones(n_pad, dtype=torch.bool), None, None,
            np.asarray(idfs, np.float32), np.asarray(rows, np.int64),
            np.asarray(qslots, np.int32), np.asarray(qweights, np.float32),
            np.asarray(qact, np.float32), 0)

    pad = [[0, 0]] * 6                         # the padding rows of q_pad 8
    segs = [seg(2 * T + 8, [[0, 10], [10, 40]], [1.5, 0.25],
                [[1, 0], [1, 0]] + pad, [[2.0, -1.0], [0.5, 0]] + pad,
                [[1, 1], [1, 0]] + pad),
            seg(64, [[5, 9]], [3.0], [[0, 0], [0, 0]] + pad,
                [[0, 0], [1.0, 1.0]] + pad, [[0, 0], [1, 1]] + pad)]
    required = np.array([1, 2] + [np.inf] * 6, np.float32)
    table, n_blocks, n_slots = k3_sweep.batch_table(
        segs, required, n_queries=2, need_counts=True)
    assert (n_blocks, n_slots) == (8, 5)
    head = table[:4 * W].reshape(4, W)
    ptrs = [[s.doc_ids.data_ptr(), s.impacts.data_ptr(), s.live.data_ptr()]
            for s in segs]
    assert head[:, 0:3].tolist() == [ptrs[0], ptrs[0], ptrs[1], ptrs[1]]
    assert head[:, 3].tolist() == [2 * T + 8, 2 * T + 8, 64, 64]
    assert head[:, 4].tolist() == [0, 3, 6, 7]          # first tile
    assert head[:, 5].tolist() == [3, 3, 1, 1]          # tiles
    assert head[:, 6].tolist() == [0, 2, 1, 3]          # row q * S + s
    assert head[:, 7].tolist() == [0, 2, 3, 3]          # first slot
    assert head[:, 8].tolist() == [2, 1, 0, 2]          # slots
    assert head[:, 9].tolist() == [1, 2, 1, 2]          # required
    assert head[:, 10].tolist() == [0, 0, 0, 0]         # counts on
    pair = table[4 * W: 4 * W + 10].reshape(5, 2).view(np.uint64)
    lo = np.uint64(0xFFFFFFFF)
    assert (pair[:, 0] & lo).tolist() == [10, 0, 10, 5, 5]
    assert (pair[:, 0] >> np.uint64(32)).tolist() == [40, 10, 40, 9, 9]
    assert (pair[:, 1] & lo).astype(np.uint32).view(np.float32).tolist() \
        == [0.25, 1.5, 0.25, 3.0, 3.0]
    assert (pair[:, 1] >> np.uint64(32)).astype(np.uint32).view(
        np.float32).tolist() == [2.0, -1.0, 0.5, 1.0, 1.0]
    work = table[4 * W + 10: 4 * W + 18]
    assert (work >> 32).tolist() == [0, 0, 0, 1, 1, 1, 2, 3]
    assert (work & 0xFFFFFFFF).tolist() == [0, 1, 2, 0, 1, 2, 0, 0]
    assert table.shape[0] == 4 * W + 18 + 6 and not table[-6:].any()
    fast, _nb, _ns = k3_sweep.batch_table(segs, required, n_queries=2,
                                          need_counts=False)
    assert fast[:4 * W].reshape(4, W)[:, 10].tolist() == [1, 1, 1, 1]


@pytest.mark.parametrize("name", list(BATCHES))
def test_batch_table_entries_equal_the_sequential_tables(name,
                                                         bag_searchers):
    """Each (query, segment) entry of the replaced route's table
    (``k3_sweep.batch_table``) holds what K2's table of
    that query alone holds on that segment (``segments_table`` of the
    sequential ``topk_input``): the same pointers, n_pad, tiles, slots
    (posting range, idf and weight bits, in the same order) and required
    count.  The union's idf (the last query's) equals each query's, so
    the one kernel adds the same numbers in the same order on both
    paths."""
    jax_s, port_s = bag_searchers
    binds = batch_binds(jax_s, name)
    from test_torch_ops import port_bag_inputs

    prep = port_group(port_s, binds)._prepare(port_s)
    segs, n_q = prep["segs"], len(binds)
    table, _n_blocks, n_slots = k3_sweep.batch_table(
        segs, prep["required"], n_queries=n_q,
        need_counts=prep["need_counts"])
    W, S = cuda_bm25.SEG_WORDS, len(segs)
    head = table[: S * n_q * W].reshape(S * n_q, W)
    pairs = table[S * n_q * W: S * n_q * W + 2 * n_slots].reshape(-1, 2)
    for q, bind in enumerate(binds):
        inputs = port_bag_inputs(port_s, bind)
        for s, seg_order in enumerate(prep["order"]):
            seq, _b, n = cuda_bm25.segments_table([inputs[seg_order]])
            e = s * n_q + q
            cols = [0, 1, 2, 3, 5, 8, 9]
            assert head[e, cols].tolist() == seq[:W][cols].tolist(), \
                (name, q, s)
            assert head[e, 6] == q * S + s
            assert head[e, 10] == int(not prep["need_counts"])
            first = head[e, 7]
            assert pairs[first: first + n].tolist() == \
                seq[W: W + 2 * n].reshape(-1, 2).tolist(), (name, q, s)


# -- K3's launch table and its work split -----------------------------------

def hand_segments():
    """Two hand-built ``BatchSegment``s: union rows and idfs, and two
    queries' slots (a duplicate slot, a negative weight, a query absent
    from the second segment) in q_pad 8."""
    T = cuda_bm25.TILE_DOCS

    def seg(n_pad, rows, idfs, qslots, qweights, qact):
        return tbm25.BatchSegment(
            torch.zeros(4, dtype=torch.int32),
            torch.zeros(8, dtype=torch.int32), torch.zeros(8),
            torch.ones(n_pad, dtype=torch.bool), None, None,
            np.asarray(idfs, np.float32), np.asarray(rows, np.int64),
            np.asarray(qslots, np.int32), np.asarray(qweights, np.float32),
            np.asarray(qact, np.float32), 0)

    pad = [[0, 0]] * 6
    return [seg(2 * T + 8, [[0, 10], [10, 40], [40, 41]], [1.5, 0.25, 9.0],
                [[1, 0], [1, 0]] + pad, [[2.0, -1.0], [0.5, 0]] + pad,
                [[1, 1], [1, 0]] + pad),
            seg(64, [[5, 9]], [3.0], [[0, 0], [0, 0]] + pad,
                [[0, 0], [1.0, 1.0]] + pad, [[0, 0], [1, 1]] + pad)]


def read_union_table(t: cuda_bm25.UnionTable) -> dict:
    """The sections of K3's table, decoded as ``union_topk.cu`` reads
    them."""
    at = t.offsets()
    w = t.table
    S, C, Q = t.n_seg, t.n_chunks, t.n_q
    lo = np.uint64(0xFFFFFFFF)
    hi = np.uint64(32)

    def halves(x):
        x = np.asarray(x).view(np.uint64)
        return (x & lo).astype(np.int64), (x >> hi).astype(np.int64)

    def f32(x):
        return np.asarray(x, np.int64).astype(np.uint32).view(np.float32)

    cs = w[at["cs"]: at["qs"]].reshape(C, S, 2)
    terms = w[at["term"]: at["slot"]].reshape(-1, 2)
    slot_term, slot_w = halves(w[at["slot"]:])
    qs_off, qs_n = halves(w[at["qs"]: at["req"]].reshape(Q, S))
    return {"seg": w[at["seg"]: at["chunk"]].reshape(S, 6),
            "chunks": w[at["chunk"]: at["cs"]].reshape(C, 2),
            "cs_terms": halves(cs[..., 0]), "cs_slots": halves(cs[..., 1]),
            "qs": (qs_off, qs_n), "req": w[at["req"]: at["counters"]],
            "counters": w[at["counters"]: at["term"]],
            "term_rows": halves(terms[:, 0]),
            "term_idf": f32(halves(terms[:, 1])[0]),
            "slot_term": slot_term, "slot_w": f32(slot_w)}


def union_rows(t: cuda_bm25.UnionTable, segments, n_queries):
    """Per (query, segment), from the table: the query's slots as (posting
    range, idf bits, weight bits) in order, and its required count."""
    d = read_union_table(t)
    out = {}
    for c, (q0, nq) in enumerate(d["chunks"]):
        for s in range(len(segments)):
            t0, _nt = d["cs_terms"][0][c, s], d["cs_terms"][1][c, s]
            s0 = d["cs_slots"][0][c, s]
            for q in range(q0, q0 + nq):
                off, n = d["qs"][0][q, s], d["qs"][1][q, s]
                rows = []
                for j in range(s0 + off, s0 + off + n):
                    term = t0 + d["slot_term"][j]
                    rows.append((int(d["term_rows"][0][term]),
                                 int(d["term_rows"][1][term]),
                                 d["term_idf"][term].tobytes(),
                                 d["slot_w"][j].tobytes()))
                out[(q, s)] = (rows, int(d["req"][q]))
    return out


def expected_rows(segments, required, n_queries):
    """The same, from the ``BatchSegment`` fields."""
    out = {}
    for s, seg in enumerate(segments):
        for q in range(n_queries):
            act = seg.qact[q] > 0
            rows = [(int(seg.union_rows[u, 0]), int(seg.union_rows[u, 1]),
                     seg.union_idfs[u].tobytes(), w.tobytes())
                    for u, w in zip(seg.qslots[q][act], seg.qweights[q][act])]
            out[(q, s)] = (rows, int(required[q]))
    return out


def test_union_table_layout_holds_every_query_slot_and_union_row():
    """K3's table on hand-built segments: each segment's pointers, n_pad,
    blocks and span; one chunk; per (chunk, segment) the union slots its
    queries name, in slot order, each its posting range and idf; each
    query's slots in term order (a duplicate term is two slots naming one
    term), each its weight; its required count; zeroed counters."""
    segs = hand_segments()
    required = np.array([1, 2] + [np.inf] * 6, np.float32)
    t = cuda_bm25.union_table(segs, required, n_queries=2, k=10,
                              need_counts=True)
    d = read_union_table(t)
    # D: the widest power of two a block's range (1,025 docs) needs
    D, B = 2048, cuda_bm25.BLOCKS_PER_SEGMENT
    assert (t.n_seg, t.n_chunks, t.n_q, t.kp, t.cand, t.docs) == \
        (2, 1, 2, 16, 64, D)
    assert t.blocks == d["seg"][:, 4].max()
    assert d["seg"][:, :3].tolist() == [
        [s.doc_ids.data_ptr(), s.impacts.data_ptr(), s.live.data_ptr()]
        for s in segs]
    n_pads = [2 * cuda_bm25.TILE_DOCS + 8, 64]
    for (n_pad, blocks, span), want in zip(d["seg"][:, 3:6], n_pads):
        assert n_pad == want and span % D == 0
        assert blocks == -(-n_pad // span) <= B
        assert (blocks - 1) * span < n_pad
        assert span // D <= cuda_bm25.MAX_SUBTILES
    assert d["chunks"].tolist() == [[0, 2]]
    # segment 0: the queries name union slots 1 and 0 (slot 2 no query
    # names); segment 1: slot 0, twice by query 1
    assert d["cs_terms"][1][0].tolist() == [2, 1]
    assert d["term_rows"][0].tolist() == [0, 10, 5]
    assert d["term_rows"][1].tolist() == [10, 40, 9]
    assert d["term_idf"].tolist() == [1.5, 0.25, 3.0]
    assert d["cs_slots"][1][0].tolist() == [3, 2]
    assert d["slot_term"].tolist() == [1, 0, 1, 0, 0]
    assert d["slot_w"].tolist() == [2.0, -1.0, 0.5, 1.0, 1.0]
    assert d["qs"][0].tolist() == [[0, 0], [2, 0]]
    assert d["qs"][1].tolist() == [[2, 0], [1, 2]]
    assert d["req"].tolist() == [1, 2]
    assert not d["counters"].any() and d["counters"].shape[0] == (2 + 8) // 2
    assert union_rows(t, segs, 2) == expected_rows(segs, required, 2)
    assert t.t_cap == 2 and t.q_cap == 2 and t.s_cap == 3
    assert t.sub_cap == max(span // D for span in d["seg"][:, 5])
    # the posting buffer takes the shared memory left, in steps of 8
    caps = (t.t_cap, t.q_cap, t.s_cap, t.sub_cap, t.docs, t.cand)
    assert t.raw_cap % 8 == 0
    assert cuda_bm25.union_smem_bytes(*caps, t.raw_cap, True) \
        <= cuda_bm25.UNION_SMEM \
        < cuda_bm25.union_smem_bytes(*caps, t.raw_cap + 8, True)


def many_binds(jax_s, n, seed=5):
    """``n`` OR bags of 1-4 terms of the bag corpus, some repeating a
    term."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        terms = [f"w{int(x)}" for x in rng.integers(0, 20, int(
            rng.integers(1, 5)))]
        out.append(bind_of(jax_s, terms))
    return out


@pytest.mark.parametrize("name", list(BATCHES) + ["many"])
def test_union_table_rows_equal_the_batch_segment_fields(name,
                                                         bag_searchers):
    """On real batches (and one of 70 queries, which takes two chunks:
    64 + 6 at k = 10, cut by CHUNK_QUERIES, and two smaller ones at k =
    K_MAX, cut by shared memory), every (query, segment)'s slots in the
    table are its present terms in term order with their union rows,
    idfs and weights, and its required count."""
    jax_s, port_s = bag_searchers
    binds = (many_binds(jax_s, 70) if name == "many"
             else batch_binds(jax_s, name))
    prep = port_group(port_s, binds)._prepare(port_s)
    segs, n_q = prep["segs"], len(binds)
    for k in (10, cuda_bm25.K_MAX):
        t = cuda_bm25.union_table(segs, prep["required"], n_queries=n_q,
                                  k=k, need_counts=prep["need_counts"])
        assert union_rows(t, segs, n_q) == expected_rows(
            segs, prep["required"], n_q)
        chunks = read_union_table(t)["chunks"]
        assert chunks[0, 0] == 0 and (chunks.sum(axis=1)[:-1]
                                      == chunks[1:, 0]).all()
        assert chunks[:, 1].sum() == n_q
        assert cuda_bm25.union_smem_bytes(
            t.t_cap, t.q_cap, t.s_cap, t.sub_cap, t.docs, t.cand,
            t.raw_cap, t.need_counts) <= cuda_bm25.UNION_SMEM
        if name == "many":              # cut by count, then by memory
            assert t.n_chunks == 2
            assert t.q_cap == 64 if k == 10 else t.q_cap < 64


# A numpy emulation of union_topk_kernel, reading the same table: query
# chunks, doc ranges, bounds found as the kernel finds them, sub-tiles
# staged from them, pass bits against the thresholds as they stood at each
# sub-tile's start, candidate buffers per (query, selecting warp) and
# their flushes, each block's post and the last block's merge.

K3_WARPS = 16        # union_topk.cu's kWarps
K3_SAMPLE = 16       # union_topk.cu's kSample


def _orderable(s):
    b = np.where(s == 0, np.float32(0), s).astype(np.float32).view(np.uint32)
    return np.where(b & 0x80000000, ~b, b | 0x80000000).astype(np.uint64)


def _keys(scores, docs):
    return (_orderable(scores) << np.uint64(32)) | (
        np.uint64(0xFFFFFFFF) - docs.astype(np.uint64))


def _key_score(key):
    o = np.uint32(int(key) >> 32)
    return (o & np.uint32(0x7FFFFFFF) if o & np.uint32(0x80000000)
            else ~o).view(np.float32)


class _Cands:
    """A candidate buffer as the kernel's ``Cands`` keeps it: a round
    offers one key a lane; a round that could overflow the buffer flushes
    it first (sort, keep kp, the threshold the kp-th key once kp are
    kept)."""

    def __init__(self, cap, kp):
        self.buf, self.thr, self.cap, self.kp = [], np.uint64(0), cap, kp

    def flush(self):
        self.buf = sorted(self.buf, reverse=True)[: self.kp]
        if len(self.buf) == self.kp:
            self.thr = self.buf[-1]

    def offer(self, keys):
        if not any(x > self.thr for x in keys):
            return
        if len(self.buf) > self.cap - 32:
            self.flush()
        self.buf += [x for x in keys if x > self.thr]


def kernel_bounds(col, lo, hi, d_begin, docs, nb):
    """Bounds of one row's range [lo, hi) as the kernel finds them: the
    first posting of each sub-tile i < nb, from a pass over every 16th doc
    id (each bound bracketed within 16 postings) and a search in each
    bracket."""
    shift = docs.bit_length() - 1
    n = -(-(hi - lo) // K3_SAMPLE)
    bnd = [lo + (n - 1) * K3_SAMPLE + 1 if n else lo] * nb
    for f in range(n):
        pp = lo + f * K3_SAMPLE
        prev = d_begin - 1 if f == 0 else int(col[pp - K3_SAMPLE])
        a = -1 if prev < d_begin else (prev - d_begin) >> shift
        b = (int(col[pp]) - d_begin) >> shift
        for i in range(a + 1, b + 1):
            bnd[i] = pp if f == 0 else pp - K3_SAMPLE + 1
    return [x + int(np.searchsorted(col[x: min(x + K3_SAMPLE, hi)],
                                    d_begin + i * docs))
            for i, x in enumerate(bnd)]


def _scoring_cols(nq, D):
    """The threads a query's group takes in the kernel's scoring: its 512
    threads split into groups of ``cols``; a lane owns the docs col + u *
    cols, and a warp 32 neighbouring columns."""
    groups = 1
    while groups * 2 <= min(nq, K3_WARPS):
        groups *= 2
    groups = min(max(groups, 512 // D), min(K3_WARPS, 512 * 16 // D))
    return 512 // groups


def _warp_floors(sc, hit, nq, D, kp):
    """Per doc of a sub-tile, the floor its scoring warp sets while a
    query has no threshold: the kp-th best of the warp's lanes' best
    matched scores (-inf where fewer than kp lanes matched)."""
    cols = _scoring_cols(nq, D)
    top = np.where(hit, sc, -np.inf).reshape(D // cols, cols).max(axis=0)
    kth = np.sort(top.reshape(cols // 32, 32), axis=1)[:, ::-1][:, kp - 1]
    return np.tile(np.repeat(kth, 32), D // cols).astype(np.float32)


def emulate_union_topk(segments, t: cuda_bm25.UnionTable, k: int):
    d = read_union_table(t)
    S, Q, D = t.n_seg, t.n_q, t.docs
    words = D // 32
    fast = not t.need_counts
    vals = np.full((Q * S, k), -np.inf, np.float32)
    ids = np.full((Q * S, k), -1, np.int32)
    totals = np.zeros(Q * S, np.int32)
    maxes = np.full(Q * S, -np.inf, np.float32)
    for c, (q0, nq) in enumerate(d["chunks"]):
        parts = K3_WARPS // nq if nq < K3_WARPS else 1
        for s, seg in enumerate(segments):
            col = seg.doc_ids.numpy()
            imp = seg.impacts.numpy()
            live = seg.live.numpy()
            n_pad, blocks, span = (int(x) for x in d["seg"][s, 3:6])
            t0, nt = d["cs_terms"][0][c, s], d["cs_terms"][1][c, s]
            s0 = d["cs_slots"][0][c, s]
            starts = d["term_rows"][0][t0: t0 + nt]
            ends = d["term_rows"][1][t0: t0 + nt]
            idf = d["term_idf"][t0: t0 + nt]
            qslot = [[(d["slot_term"][j], d["slot_w"][j]) for j in range(
                s0 + d["qs"][0][q0 + q, s],
                s0 + d["qs"][0][q0 + q, s] + d["qs"][1][q0 + q, s])]
                for q in range(nq)]
            req = [d["req"][q0 + q] for q in range(nq)]
            posted = {q: [] for q in range(nq)}
            for r in range(blocks):
                d_begin, d_end = r * span, min(n_pad, (r + 1) * span)
                # each row's range in the block, then every sub-tile's
                # bound in it, the kernel's way (and checked exact)
                lo = [a + int(np.searchsorted(col[a:b], d_begin))
                      for a, b in zip(starts, ends)]
                hi = [a + int(np.searchsorted(col[a:b], d_end))
                      for a, b in zip(starts, ends)]
                subs = list(range(d_begin, d_end, D))
                bnd = [kernel_bounds(col, a, b, d_begin, D, len(subs) + 1)
                       for a, b in zip(lo, hi)]
                assert bnd == [[a + int(np.searchsorted(col[a:b], x))
                                for x in subs] + [b]
                               for a, b in zip(lo, hi)]
                cands = [[_Cands(t.cand, t.kp) for _ in range(parts)]
                         for _ in range(nq)]
                for i_sub, sub in enumerate(subs):
                    sub_end = min(sub + D, d_end)
                    dense = np.zeros((nt, D), np.float32)
                    pres = np.zeros((nt, D), np.int32)
                    for i in range(nt):
                        take = np.arange(bnd[i][i_sub], bnd[i][i_sub + 1])
                        assert ((col[take] >= sub)
                                & (col[take] < sub_end)).all()
                        dense[i, col[take] - sub] = idf[i] * imp[take]
                        pres[i, col[take] - sub] = 1
                    lv = np.zeros(D, bool)
                    lv[: sub_end - sub] = live[sub:sub_end]
                    for q in range(nq):
                        n_post = sum(bnd[term][i_sub + 1] - bnd[term][i_sub]
                                     for term, _w in qslot[q])
                        if n_post == 0 and (fast or req[q] > 0):
                            continue
                        # the best threshold's score at the sub-tile's start
                        best = max(cs.thr for cs in cands[q])
                        thr_f = _key_score(best) if best else -np.inf
                        sc = np.zeros(D, np.float32)
                        cnt = np.zeros(D, np.int32)
                        for term, w in qslot[q]:
                            sc = sc + w * dense[term]
                            cnt += pres[term]
                        hit = lv & ((sc > 0) if fast else cnt >= req[q])
                        row = (q0 + q) * S + s
                        totals[row] += hit.sum()
                        if hit.any():
                            maxes[row] = max(maxes[row], sc[hit].max())
                        passed = hit & (sc > thr_f)
                        if thr_f == -np.inf and t.kp <= 32:
                            passed &= sc >= _warp_floors(sc, hit, nq, D,
                                                         t.kp)
                        keys = np.where(passed,
                                        _keys(sc, sub + np.arange(D)),
                                        np.uint64(0))
                        if _scoring_cols(nq, D) == 32:
                            # the query's warp offers as it scores: round
                            # r, each lane its r-th passing doc (lane l
                            # owns docs l + 32 u)
                            own = keys.reshape(D // 32, 32).T
                            lanes = [x[x > 0] for x in own]
                            for r in range(max(len(x) for x in lanes)):
                                cands[q][0].offer([
                                    x[r] if r < len(x) else np.uint64(0)
                                    for x in lanes])
                            continue
                        # selecting warp `part` offers every parts-th
                        # word with a pass bit, a word a round
                        for part in range(parts):
                            for w in range(part, words, parts):
                                if passed[32 * w: 32 * w + 32].any():
                                    cands[q][part].offer(
                                        keys[32 * w: 32 * w + 32])
                for q in range(nq):        # the block's post
                    for cs in cands[q]:
                        cs.flush()
                    half = 1               # a tree of pairwise merges
                    while half < parts:
                        for p in range(0, parts - half, 2 * half):
                            mine, other = cands[q][p], cands[q][p + half]
                            for i0 in range(0, len(other.buf), 32):
                                mine.offer(other.buf[i0: i0 + 32])
                            mine.flush()
                        half *= 2
                    best = cands[q][0].buf
                    posted[q] += best + [np.uint64(0)] * (t.kp - len(best))
            for q in range(nq):              # the last block's merge
                merged = _Cands(t.cand, t.kp)
                for i0 in range(0, len(posted[q]), 32):
                    merged.offer(posted[q][i0: i0 + 32])
                merged.flush()
                row = (q0 + q) * S + s
                top = np.asarray(merged.buf[:k], np.uint64)
                top = top[top > 0]
                o = (top >> np.uint64(32)).astype(np.uint32)
                vals[row, : len(top)] = np.where(
                    o & 0x80000000, o & 0x7FFFFFFF, ~o).astype(
                    np.uint32).view(np.float32)
                ids[row, : len(top)] = (0xFFFFFFFF - (top & np.uint64(
                    0xFFFFFFFF))).astype(np.int32)
    return vals, ids, totals, maxes


def tied_segments(seed: int = 4):
    """Two ``BatchSegment``s whose impacts take two values, so most
    matched docs tie on score with docs of other sub-tiles and blocks:
    the strict float compare against a threshold and the lower-id rule
    decide the top-k.  Three union terms; queries {0}, {1, 2}, {0, 1},
    {2, 2}."""
    rng = np.random.default_rng(seed)
    out = []
    for n_pad in (512, 200):
        rows = [np.sort(rng.choice(n_pad - 1, int(rng.integers(
            n_pad // 8, n_pad // 2)), replace=False)) for _ in range(3)]
        offsets = np.concatenate([[0], np.cumsum([len(x) for x in rows])])
        pad = [[0, 0]] * 4
        out.append(tbm25.BatchSegment(
            torch.from_numpy(offsets.astype(np.int32)),
            torch.from_numpy(np.concatenate(rows).astype(np.int32)),
            torch.from_numpy(rng.choice(np.float32([0.5, 1.0]),
                                        int(offsets[-1]))),
            torch.from_numpy(rng.random(n_pad) > 0.1),
            np.asarray([0, 1, 2] + [0] * 5, np.int32), np.arange(8) < 3,
            np.asarray([1.5, 1.5, 0.75] + [0] * 5, np.float32),
            np.asarray([[offsets[i], offsets[i + 1]] for i in range(3)]
                       + [[0, 0]] * 5, np.int64),
            np.asarray([[0, 0], [1, 2], [0, 1], [2, 2]] + pad, np.int32),
            np.asarray([[1, 0], [1, 1], [1, 1], [1, 1]] + pad, np.float32),
            np.asarray([[1, 0], [1, 1], [1, 1], [1, 1]] + pad, np.float32),
            pad_bucket(int(offsets[-1]))))
    return out


@pytest.mark.parametrize("split", ["default", "sub-tiles", "chunks"])
@pytest.mark.parametrize("name", list(BATCHES) + ["many", "tied",
                                                  "tied-counted"])
def test_union_topk_emulation_equals_the_plain_twin(name, split,
                                                    bag_searchers,
                                                    monkeypatch):
    """The kernel's work split, emulated in numpy from its launch table,
    is byte-equal to ``batch_term_bag_topk_segments`` (vals, ids, totals,
    maxes) at k = 1, 10 and K_MAX: with the default sizes (one block a
    segment here), with 32-doc sub-tiles and 3 blocks a segment (several
    sub-tiles and blocks, so bounds, thresholds, flushes and the merge
    all run), and with chunks of 2 queries; on real batches and on
    segments where most scores tie across sub-tiles."""
    if split == "sub-tiles":
        monkeypatch.setattr(cuda_bm25, "SUBTILE_DOCS", 32)
        monkeypatch.setattr(cuda_bm25, "BLOCKS_PER_SEGMENT", 3)
    if split == "chunks":
        monkeypatch.setattr(cuda_bm25, "CHUNK_QUERIES", 2)
        monkeypatch.setattr(cuda_bm25, "SUBTILE_DOCS", 64)
    jax_s, port_s = bag_searchers
    if name.startswith("tied"):
        segs, n_q = tied_segments(), 4
        required = np.asarray([1, 1, 2, 1] + [np.inf] * 4, np.float32)
        need_counts = name == "tied-counted"
    else:
        binds = (many_binds(jax_s, 70) if name == "many"
                 else batch_binds(jax_s, name))
        prep = port_group(port_s, binds)._prepare(port_s)
        segs, n_q = prep["segs"], len(binds)
        required, need_counts = prep["required"], prep["need_counts"]
    for k in (1, 10, cuda_bm25.K_MAX):
        t = cuda_bm25.union_table(segs, required, n_queries=n_q,
                                  k=k, need_counts=need_counts)
        if split == "sub-tiles":
            assert (t.docs, t.blocks) == (32, 3)
        if split == "chunks":
            assert t.n_chunks == -(-n_q // 2)
        got = emulate_union_topk(segs, t, k)
        ref = tbatch.batch_term_bag_topk_segments(
            segs, required, n_queries=n_q, k=k,
            need_counts=need_counts).numpy()
        for what, a, b in zip(("vals", "ids", "totals", "maxes"), got, ref):
            assert a.tobytes() == b.tobytes(), (name, split, k, what)
        assert ref[2].sum() > 0 or name == "absent"
        if name.startswith("tied") and k > 1:   # ties decide the page
            assert (ref[0][:, :-1] == ref[0][:, 1:]).any()


def test_bags_beyond_the_union_term_limit_stay_in_their_batch(
        pair, monkeypatch):
    """A bag of more terms than K3 stages (``UNION_MAX_TERMS``) stays in
    its (field, size) group, as the reference's ``batchable`` has no such
    limit: the group serves it through K2's top-k over the f32 lowering,
    and msearch answers as the reference's msearch and as ``search``."""
    _seed, jax_s, port_s = pair
    monkeypatch.setattr(tbatch, "UNION_MAX_TERMS", 2)
    bodies = [{"query": {"match": {"body": "w1 w2 w3"}}, "size": 5},
              {"query": {"match": {"body": "w1 w1"}}, "size": 5}]
    groups, fallback = tbatch.plan_batches(port_s, bodies)
    assert fallback == [] and len(groups) == 1
    assert groups[0].positions == [1]
    assert [pos for pos, _bind in groups[0].wide] == [0]
    got, ref = port_s.msearch(bodies), jax_s.msearch(bodies)
    for body, g, r in zip(bodies, got, ref):
        assert bm25_mismatch(g, r) is None, (body, bm25_mismatch(g, r))
        assert strip_took(g) == strip_took(port_s.search(body))


def test_wide_bags_keep_the_f32_lowering_on_quantized_segments(
        monkeypatch):
    """On a segment the port quantizes, a bag beyond ``UNION_MAX_TERMS``
    in msearch keeps the batched path's f32 lowering (its f32 columns
    staged on demand), as the reference's msearch does, and answers as
    the reference's msearch, alone and beside a narrow bag."""
    jax_s, port_s, docs = quantized_size_searchers(monkeypatch)
    monkeypatch.setattr(tbatch, "UNION_MAX_TERMS", 2)
    dseg = port_s.segments[0].device("cpu")
    assert dseg.quantized_mode and set(dseg.postings["body"]) == {"offsets"}
    wide = {"query": {"match": {"body": "w1 w1 nope"}}, "size": 5}
    for bodies in ([wide], [wide, {"query": {"match": {"body": "w1"}},
                                   "size": 5}]):
        got, ref = port_s.msearch(bodies), jax_s.msearch(bodies)
        for g, r in zip(got, ref):
            assert bm25_mismatch(g, r) is None
            assert g["hits"]["total"]["value"] == len(docs)
        assert "doc_ids" in dseg.postings["body"]


def test_union_table_refuses_a_query_it_cannot_stage(bag_searchers,
                                                     monkeypatch):
    """When one query's terms do not fit a block's shared memory even at
    32-doc sub-tiles of one sub-tile a block, the table is refused (the
    batched path never builds one: ``BatchGroup`` serves a bag beyond
    ``UNION_MAX_TERMS`` through K2)."""
    jax_s, port_s = bag_searchers
    prep = port_group(port_s, batch_binds(jax_s, "or"))._prepare(port_s)
    monkeypatch.setattr(cuda_bm25, "UNION_SMEM", 600)
    with pytest.raises(ValueError, match="terms"):
        cuda_bm25.union_table(prep["segs"], prep["required"], n_queries=3,
                              k=10, need_counts=False)

def test_launch_counters_count_every_launch_across_threads():
    """Wrappers launch from many threads (the engine's pool, batcher
    leaders): ``cuda_build.count`` loses no increment."""
    from opensearch_tpu_torch.ops import cuda_build

    def wrapper():
        pass

    wrapper.launches = 0
    wrapper.sorted_route_segments = 0

    def hammer(i):
        for _ in range(2000):
            cuda_build.count(wrapper)
            cuda_build.count(wrapper, 2, attr="sorted_route_segments")
        return True

    assert all(run_concurrent(hammer, 12, switch_s=1e-6))
    assert wrapper.launches == 12 * 2000
    assert wrapper.sorted_route_segments == 12 * 2000 * 2


# -- msearch -----------------------------------------------------------------

@pytest.fixture(params=[3, 17, 92])
def pair(request, monkeypatch):
    """(seed, JAX searcher, port searcher) over the same state, with
    deletes applied (``tests/test_torch_search.py``'s corpus)."""
    from opensearch_tpu.index.segment import SegmentWriter as JaxWriter
    from opensearch_tpu.mapping.mapper import DocumentMapper as JaxMapper

    monkeypatch.setattr(jbm25, "HOST_SCORING", False)
    seed = request.param
    docs = json_docs(seed, sum(SEG_SIZES))
    jsegs = build(JaxWriter(), JaxMapper(MAPPING), docs)
    rng = np.random.default_rng(seed + 1)
    for seg in jsegs:
        seg.apply_deletes(rng.choice(seg.n_docs, size=7, replace=False))
    tsegs = [segment_from_arrays(*segment_arrays(s)) for s in jsegs]
    return (seed, JaxSearcher(jsegs, JaxMapper(MAPPING)),
            ShardSearcher(tsegs, DocumentMapper(MAPPING), device="cpu"))


def msearch_bodies(seed):
    rng = np.random.default_rng(seed + 7)
    w = [f"w{int(x)}" for x in rng.integers(0, 14, size=12)]
    batched = [
        {"query": {"match": {"body": f"{w[0]} {w[1]} {w[2]}"}}, "size": 7},
        {"query": {"match": {"body": f"{w[3]} {w[4]}"}}, "size": 7},
        {"query": {"match": {"body": {"query": f"{w[5]} {w[6]}",
                                      "operator": "and"}}}, "size": 7},
        {"query": {"match": {"body": f"{w[7]} {w[7]} {w[8]}"}},
         "size": 7},
        {"query": {"match": {"body": {
            "query": f"{w[0]} {w[9]} {w[10]} {w[11]}",
            "minimum_should_match": 2}}}, "size": 7},
        {"query": {"match": {"body": "w1"}}},
        {"query": {"term": {"tag": "blue"}}, "size": 30},
        {"query": {"match": {"body": "w2 w3"}}, "size": 256},
        {"query": {"match": {"body": "zzz"}}, "size": 5},
    ]
    fallback = [
        {"query": {"bool": {"must": [{"match": {"body": w[0]}}],
                            "filter": [{"term": {"tag": "red"}}]}}},
        {"query": {"match": {"body": f"{w[1]} {w[2]}"}}, "size": 5,
         "min_score": 1.0},
        {"query": {"match": {"body": f"{w[3]} w0"}}, "from": 2, "size": 4},
        {"query": {"match": {"body": "w0 w1"}}, "size": 5,
         "track_total_hits": False},
        {"query": {"match": {"body": "w0 w4"}}, "size": 300},
        {"query": {"match_all": {}}, "size": 3},
    ]
    return batched, fallback


def strip_took(resp):
    resp = json.loads(json.dumps(resp))
    resp.pop("took", None)
    return resp


def test_msearch_matches_reference_msearch_and_sequential_search(
        pair, monkeypatch):
    """Port ``msearch`` against the reference's ``msearch`` and against
    the port's own ``search``, body by body, with batched and fallback
    bodies interleaved: hits, scores and totals byte for byte; the
    batchable bodies run as groups (one plain-twin call each), the rest
    through ``search``."""
    seed, jax_s, port_s = pair
    batched, fallback = msearch_bodies(seed)
    bodies = [b for pair_ in zip(batched, fallback + [None] * 3)
              for b in pair_ if b is not None]
    calls = []
    real = tbatch.batch_term_bag_topk_auto

    def spy(segments, required, **kw):
        calls.append((len(segments), kw["n_queries"], kw["k"]))
        return real(segments, required, **kw)

    monkeypatch.setattr(tbatch, "batch_term_bag_topk_auto", spy)
    got = port_s.msearch(bodies)
    ref = jax_s.msearch(bodies)
    assert len(got) == len(ref) == len(bodies)
    for body, g, r in zip(bodies, got, ref):
        assert bm25_mismatch(g, r) is None, (body, bm25_mismatch(g, r))
        if body.get("track_total_hits") is not False:
            assert strip_took(g) == strip_took(port_s.search(body)), body
    # groups by (field, size): size 7 (five bodies), 10, 30, 256; the
    # size-5 group's term exists nowhere, so it launches nothing
    assert sorted(c[1:] for c in calls) == [(1, 10), (1, 30), (1, 256),
                                            (5, 7)]
    assert sum(1 for g in got if g["hits"]["hits"]) >= len(bodies) - 2


def test_msearch_forms_one_group_per_field_and_size(pair):
    """Every batchable body of one (field, size) joins one group, however
    many distinct terms the group holds; the answers equal sequential
    search."""
    _seed, _jax_s, port_s = pair
    bodies = [{"query": {"match": {"body": f"w{i} w{i + 1} x{i}"}},
               "size": 6} for i in range(40)]
    bodies.append({"query": {"match": {"body": "w2"}}, "size": 4})
    groups, fallback = tbatch.plan_batches(port_s, bodies)
    assert fallback == []
    assert [(g.k, g.positions) for g in groups] == [(6, list(range(40))),
                                                    (4, [40])]
    for body, resp in zip(bodies, port_s.msearch(bodies)):
        assert strip_took(resp) == strip_took(port_s.search(body))


def test_msearch_scores_a_quantized_size_segment_in_f32_like_the_reference(
        monkeypatch):
    """The reference's batch path keeps the f32 lowering on a segment of
    QUANTIZED_MIN_DOCS docs; the port's batch path does too (its
    sequential path scores that segment's quantized tables, as the
    reference's does)."""
    jax_s, port_s, docs = quantized_size_searchers(monkeypatch)
    bodies = [{"query": {"match": {"body": "w1"}}, "size": 5},
              {"query": {"match": {"body": "w1 nope"}}, "size": 5}]
    got, ref = port_s.msearch(bodies), jax_s.msearch(bodies)
    for g, r in zip(got, ref):
        assert bm25_mismatch(g, r) is None
        assert g["hits"]["total"]["value"] == len(docs)
    assert bm25_mismatch(port_s.search(bodies[0]),
                         jax_s.search(bodies[0])) is None


# -- the continuous batcher and the engine ----------------------------------

class _Svc:
    """Minimal service shim: a bare ShardSearcher behind the engine, so
    the service-scoped backends reduce to the batcher (no mesh)."""

    @staticmethod
    def _use_mesh(body):
        return False


def run_concurrent(fn, n, switch_s=0.0002):
    """Run ``fn(i)`` on n threads released together; results in index
    order, the first worker error re-raised.  A short GIL switch interval
    (``switch_s``) makes the threads interleave."""
    results = [None] * n
    errors = [None] * n
    barrier = threading.Barrier(n)

    def worker(i):
        try:
            barrier.wait()
            results[i] = fn(i)
        except BaseException as e:  # noqa: BLE001 — re-raised below
            errors[i] = e

    interval0 = sys.getswitchinterval()
    sys.setswitchinterval(switch_s)
    try:
        threads = [threading.Thread(target=worker, args=(i,), daemon=True)
                   for i in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval0)
    for e in errors:
        if e is not None:
            raise e
    return results


@pytest.fixture
def engine(monkeypatch):
    monkeypatch.setattr(engine_mod, "BATCHER_ENABLED", True)
    monkeypatch.setattr(engine_mod, "BATCHER_WINDOW_MS", 250.0)
    monkeypatch.setattr(engine_mod, "BATCHER_MAX_BATCH", 64)
    return engine_mod.query_engine()


@pytest.fixture
def port_searcher():
    mapper = DocumentMapper(MAPPING)
    segs = build(SegmentWriter(), mapper, json_docs(5, sum(SEG_SIZES)))
    segs[0].apply_deletes([2, 9, 40])
    return ShardSearcher(segs, mapper, device="cpu")


@pytest.mark.parametrize("same", [True, False],
                         ids=["identical", "differing"])
def test_concurrent_searches_coalesce_byte_identical(same, engine,
                                                     port_searcher):
    """Concurrent single searches of one (field, size) share group runs;
    each caller gets exactly its own sequential response, whether the
    members carry the same terms or different ones."""
    bodies = [{"query": {"match": {"body": "w0 w2" if same else
                                   f"w{i % 5} w{(i + 3) % 7}"}},
               "size": 4} for i in range(8)]
    refs = [strip_took(port_searcher.search(b)) for b in bodies]
    b0 = engine.batcher.stats()
    for _attempt in range(8):
        results = run_concurrent(lambda i: engine.execute(
            port_searcher, dict(bodies[i]), service=_Svc()), 8)
        for got, ref in zip(results, refs):
            assert strip_took(got) == ref
        if engine.batcher.stats()["batched"] > b0["batched"]:
            break
    b1 = engine.batcher.stats()
    batched = b1["batched"] - b0["batched"]
    dispatches = b1["dispatches"] - b0["dispatches"]
    assert batched >= 2 and dispatches >= 1
    assert batched / dispatches >= 2          # realized occupancy > 1
    assert b1["window_waits"] > b0["window_waits"]


def test_serial_traffic_never_waits(engine, port_searcher, monkeypatch):
    """No concurrent batchable traffic -> no window wait: serial requests
    take the sequential path with no added latency."""
    monkeypatch.setattr(engine_mod, "BATCHER_WINDOW_MS", 5000.0)
    body = {"query": {"match": {"body": "w1"}}, "size": 3}
    port_searcher.search(body)                 # compiled: batchable now
    w0 = engine.batcher.stats()["window_waits"]
    t0 = time.monotonic()
    for _ in range(3):
        engine.execute(port_searcher, dict(body), service=_Svc())
    assert time.monotonic() - t0 < 4.0
    assert engine.batcher.stats()["window_waits"] == w0


def test_non_batchable_and_disabled_bypass(engine, port_searcher,
                                           monkeypatch):
    """A body the batcher cannot serve bypasses it (counted); with the
    batcher off, or without a service, it is not consulted at all."""
    bodies = [{"query": {"match": {"body": "w1"}}, "size": 3,
               "min_score": 0.5},
              {"query": {"bool": {"must": [{"match": {"body": "w1"}}]}}},
              {"query": {"match": {"body": "w1 w7"}}, "size": 3}]  # unseen
    for body in bodies:
        y0 = engine.batcher.stats()["bypass"]
        r1 = engine.execute(port_searcher, dict(body), service=_Svc())
        assert engine.batcher.stats()["bypass"] == y0 + 1
        monkeypatch.setattr(engine_mod, "BATCHER_ENABLED", False)
        r2 = engine.execute(port_searcher, dict(body), service=_Svc())
        r3 = engine.execute(port_searcher, dict(body))
        monkeypatch.setattr(engine_mod, "BATCHER_ENABLED", True)
        assert engine.batcher.stats()["bypass"] == y0 + 1
        assert strip_took(r1) == strip_took(r2) == strip_took(r3) == \
            strip_took(port_searcher.search(body))


def test_engine_raises_for_unported_backends(engine, port_searcher):
    from opensearch_tpu_torch.common.errors import NotYetPortedError

    class MeshSvc(_Svc):
        @staticmethod
        def _use_mesh(body):
            return True

    body = {"query": {"match": {"body": "w1"}}}
    with pytest.raises(NotYetPortedError):
        engine.execute(port_searcher, body, service=MeshSvc())
    # aggregation partials are served now, past the batcher
    aggs = dict(body, aggs={"n": {"value_count": {"field": "tag"}}})
    resp = engine.execute(port_searcher, aggs, agg_partials=True,
                          service=_Svc())
    assert resp["aggregation_partials"]["n"]["t"] == "metric"
    assert "aggregations" not in resp


@pytest.mark.parametrize("enabled", [True, False])
def test_msearch_byte_identity_batcher_on_off(enabled, engine,
                                              port_searcher, monkeypatch):
    """msearch: batched groups and the threadpool-fanned fallback both
    return exactly the sequential per-body responses."""
    monkeypatch.setattr(engine_mod, "BATCHER_ENABLED", enabled)
    bodies = [{"query": {"match": {"body": "w0 w2"}}, "size": 5},
              {"query": {"match": {"body": "w3"}}, "size": 5},
              {"query": {"match": {"body": "w1"}}, "size": 3,
               "min_score": 0.5},
              {"query": {"bool": {"must": [{"match": {"body": "w4"}}]}},
               "size": 4}]
    seq = [strip_took(port_searcher.search(b)) for b in bodies]
    s0 = engine.pool.stats()["submitted"]
    out = engine.msearch(port_searcher, [dict(b) for b in bodies])
    assert [strip_took(r) for r in out] == seq
    assert engine.pool.stats()["submitted"] >= s0 + 2   # fanned out


def test_threadpool_named_threads_and_idempotent_shutdown():
    eng = engine_mod.query_engine()
    out = eng.pool.run_all([lambda: threading.current_thread().name
                            for _ in range(4)])
    assert all(n.startswith("search-engine-") for n in out)
    t0 = time.monotonic()
    eng.shutdown()
    eng.shutdown()                 # idempotent
    assert time.monotonic() - t0 < 6.0
    assert eng.pool.run_all([lambda: 1 + 1]) == [2]   # respawned


def test_threadpool_reraises_in_submission_order_and_nests_inline():
    pool = engine_mod.SearchThreadpool(size=2)
    try:
        def boom(tag):
            raise KeyError(tag)

        with pytest.raises(KeyError, match="first"):
            pool.run_all([lambda: 1, lambda: boom("first"),
                          lambda: boom("second")])
        # a worker's own fan-out runs inline instead of waiting on the
        # queue
        assert pool.run_all([lambda: pool.run_all([lambda: 3] * 3)]) == \
            [[3, 3, 3]]
    finally:
        pool.stop()


# -- the searcher's caches under threads -------------------------------------

def test_searcher_caches_survive_concurrent_eviction(monkeypatch):
    """Threads caching distinct entries through a searcher whose plan and
    prepared-bindings caches hold two entries evict concurrently; no
    eviction may fail (with plain dicts, two threads popping one key
    raised KeyError, or iteration met a dict changing size), every
    thread reads back what it cached, and searches stay right."""
    monkeypatch.setattr(texec, "_PLAN_CACHE_MAX", 2)
    monkeypatch.setattr(texec, "_PREP_CACHE_MAX", 2)
    mapper = DocumentMapper(MAPPING)
    segs = build(SegmentWriter(), mapper, json_docs(7, sum(SEG_SIZES)))
    searcher = ShardSearcher(segs, mapper, device="cpu")
    bodies = [{"query": {"bool": {"must": [
        {"match": {"body": f"w{i % 13} w{(i * 7) % 11}"}}]}}, "size": 3}
        for i in range(16)]
    refs = [strip_took(ShardSearcher(segs, mapper, device="cpu")
                       .search(b)) for b in bodies]

    def worker(i):
        for j in range(1500):
            got = searcher._cached(("q", i, j), segs[0], "x",
                                   lambda: (i, j))
            assert got == (i, j)
        searcher.compiled({"match": {"body": f"w{i} x{i}"}})
        return strip_took(searcher.search(bodies[i]))

    assert run_concurrent(worker, 16, switch_s=1e-6) == refs
    assert len(searcher._plan_cache) <= 2
    assert len(searcher._prep_cache) <= 2


def test_bounded_cache_keeps_the_first_value_and_its_limit():
    cache = BoundedCache(3)
    assert cache.put("a", 1) == 1
    assert cache.put("a", 2) == 1              # the first value stays
    assert cache.get_or_make("b", lambda: 5) == 5
    assert cache.get_or_make("b", lambda: 6) == 5
    for key in "cde":
        cache.put(key, key)
    assert len(cache) == 3 and cache.get("a") is None   # oldest out

    def hammer(i):
        for j in range(300):
            cache.put((i, j), j)
            cache.get((i, j - 1))
        return True

    assert all(run_concurrent(hammer, 12, switch_s=1e-6))
    assert len(cache) == 3
