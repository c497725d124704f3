"""The plan top-k (``csrc/plan_topk.cu``, wrapper ``ops/cuda_plan.py``
``plan_topk_segments_cuda``), held on the CPU: one launch over every
segment of a request replaces each segment's stable sort after a plan's
dense evaluation (the reference's ``run_topk`` / ``topk_from_scores``,
``opensearch_tpu/search/plan.py:1760,1773``).

- A numpy model of the kernel, which reads nothing but the launch table
  ``plan_table`` builds (and the columns its pointers name): per tile of
  ``TILE_DOCS`` docs the keys of ``topk.cuh`` (orderable score, then
  the lower doc id; -0.0 folded into +0.0) of the matched, live docs at
  or above ``min_score``, the tile's best kp, the merge of every tile's
  kp, each kept doc's own score, the total and the first kept score as
  the max.  It equals the plain version ``plan_topk_segments`` (values
  byte for byte, ids where the value is above -inf, totals, maxes), at
  the kernel's tile and at 16 docs a tile (many tiles a segment): ties,
  negative scores, -0.0, no match, fewer matches than k, k = n_pad,
  ``min_score``, a segment of no live doc.
- The plain version (``plan_segment_topk``) equals the JAX package's
  ``topk_from_scores`` (and its ``run_topk``'s masks).
- The launch table's layout, word by word; the wrapper refuses CPU
  tensors; the executor calls the plan top-k once per request (once per
  segment when exact totals are waived) and no sort remains there.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opensearch_tpu.search import plan as jplan
from opensearch_tpu_torch.ops import bm25 as tbm25
from opensearch_tpu_torch.ops import cuda_plan
from opensearch_tpu_torch.ops.cuda_bm25 import K_MAX, k_padded

KS = (1, 3, 10, 100, K_MAX)


def orderable(s: np.float32) -> int:
    """``topk.cuh`` ``orderable``: -0.0 folded into +0.0, then a monotone
    map of the float bits."""
    b = int(np.array([0.0 if s == 0 else s], np.float32).view(np.uint32)[0])
    return (~b & 0xFFFFFFFF) if b & 0x80000000 else b | 0x80000000


def make_key(s, doc: int) -> int:
    return (orderable(s) << 32) | (0xFFFFFFFF - doc)


def key_id(key: int) -> int:
    return 0xFFFFFFFF - (key & 0xFFFFFFFF)


def run_plan_table(table, n_seg, n_blocks, memory, k, min_score, tile,
                   out):
    """``plan_topk_kernel`` in numpy over a ``plan_table``: each block of
    the work list keys its tile, keeps its best kp (0-padded), the
    segment's blocks' keys merge into its best kp, and the segment's row
    of ``out`` (vals, ids, totals, maxes as numpy) gets k pairs, each
    doc's own score, ``(-inf, -1)`` for key 0."""
    u = [int(w) for w in table.tolist()]
    words = cuda_plan.SEG_WORDS
    assert len(u) == n_seg * words + n_blocks + n_seg   # + 2 n_seg int32
    assert not any(u[n_seg * words + n_blocks:])
    kp = k_padded(k)
    kept = {}
    totals = [0] * n_seg
    for wk in u[n_seg * words: n_seg * words + n_blocks]:
        seg, t = wk >> 32, wk & 0xFFFFFFFF
        e = u[seg * words: (seg + 1) * words]
        scores, matched = memory[e[0]], memory[e[1]]
        live = memory[e[2]] if e[2] else np.ones(e[3], bool)
        doc0 = t * tile
        keys = [0] * tile
        for d in range(doc0, min(doc0 + tile, e[3])):
            if matched[d] and live[d] and scores[d] >= min_score:
                keys[d - doc0] = make_key(scores[d], d)
                totals[seg] += 1
        kept.setdefault(seg, []).append(sorted(keys, reverse=True)[:kp])
        assert t < e[5] and e[4] + t < n_blocks
    vals, ids, tot, mx = out
    for seg, tiles in kept.items():
        e = u[seg * words: (seg + 1) * words]
        assert len(tiles) == e[5]
        best = sorted((x for t in tiles for x in t), reverse=True)[:kp]
        scores = memory[e[0]]
        row = e[6]
        for i in range(k):
            key = best[i] if i < len(best) else 0
            ids[row, i] = key_id(key) if key else -1
            vals[row, i] = scores[key_id(key)] if key else -np.inf
        tot[row] = totals[seg]
        mx[row] = scores[key_id(best[0])] if best[0] else -np.inf


def model_plan_topk(entries, k, min_score, tile):
    """The plan top-k in numpy: ``plan_table``'s table run by
    ``run_plan_table``, rows as ``TermBagTopK.numpy()`` gives them."""
    memory = {}
    for e in entries:
        for t in e:
            if t is not None:
                memory[t.data_ptr()] = t.numpy()
    table, n_blocks = cuda_plan.plan_table(
        [(e.scores.data_ptr(), e.matched.data_ptr(),
          0 if e.live is None else e.live.data_ptr()) for e in entries],
        [e.scores.shape[0] for e in entries])
    n = len(entries)
    out = (np.zeros((n, k), np.float32), np.zeros((n, k), np.int32),
           np.zeros(n, np.int32), np.zeros(n, np.float32))
    run_plan_table(table, n, n_blocks, memory, k, min_score, tile, out)
    return out


def entry(rng, n, *, levels=(0.5, 1.0, 2.0, 3.25), p_match=0.6,
          p_live=0.9, negative=False, neg_zero=False, live=True):
    """A segment's (scores, matched, live): scores from a few levels
    (ties), negated where asked, zeros spelled -0.0 where asked."""
    s = rng.choice(np.float32(levels), size=n).astype(np.float32)
    s += rng.integers(0, 3, size=n).astype(np.float32)
    if negative:
        s = np.where(rng.random(n) < 0.5, -s, s).astype(np.float32)
    if neg_zero:
        s = np.where(rng.random(n) < 0.4, np.float32(-0.0), -s).astype(
            np.float32)
    m = rng.random(n) < p_match
    lv = rng.random(n) < p_live
    return tbm25.PlanScores(torch.from_numpy(s), torch.from_numpy(m),
                            torch.from_numpy(lv) if live else None)


def cases():
    rng = np.random.default_rng(7)
    yield "ties", [entry(rng, n) for n in (300, 4096, 4097, 9000)]
    yield "negative", [entry(rng, n, negative=True) for n in (1000, 128)]
    yield "neg_zero", [entry(rng, n, neg_zero=True) for n in (700, 64)]
    yield "no_match", [entry(rng, 500, p_match=0.0), entry(rng, 200)]
    yield "few", [entry(rng, 600, p_match=0.004), entry(rng, 8)]
    yield "no_live", [entry(rng, 256, p_live=0.0), entry(rng, 256)]
    yield "no_live_mask", [entry(rng, n, live=False) for n in (333, 4100)]


CASES = list(cases())


def check_equal(got, want, exact_max=True):
    gv, gi, gt, gm = got
    wv, wi, wt, wm = want
    assert gv.tobytes() == wv.tobytes()
    keep = wv > -np.inf
    assert (gi[keep] == wi[keep]).all()
    assert gt.tolist() == wt.tolist()
    if exact_max:
        assert gm.tobytes() == wm.tobytes()
    else:
        assert (gm == wm).all()


@pytest.mark.parametrize("tile", [16, cuda_plan.TILE_DOCS])
@pytest.mark.parametrize("name,entries", CASES, ids=[c[0] for c in CASES])
def test_model_equals_the_plain_version(name, entries, tile, monkeypatch):
    monkeypatch.setattr(cuda_plan, "TILE_DOCS", tile)
    for k in KS:
        for ms in (-np.inf, 2.0, -1.0):
            got = model_plan_topk(entries, k, ms, tile)
            want = tbm25.plan_topk_segments(entries, k=k,
                                            min_score=ms).numpy()
            check_equal(got, want)
    if name == "neg_zero":
        # -0.0 comes back as -0.0 (its own bits), as the sort returns it
        got = model_plan_topk(entries, 10, -np.inf, tile)
        assert (np.signbit(got[0]) & (got[0] == 0)).any()


def test_model_at_k_equal_to_n_pad():
    rng = np.random.default_rng(3)
    entries = [entry(rng, 128, p_match=0.9), entry(rng, 128, p_match=1.0,
                                                   p_live=1.0)]
    got = model_plan_topk(entries, 128, -np.inf, cuda_plan.TILE_DOCS)
    want = tbm25.plan_topk_segments(entries, k=128).numpy()
    check_equal(got, want)
    assert got[2][1] == 128


@pytest.mark.parametrize("name,entries", CASES, ids=[c[0] for c in CASES])
def test_plain_version_equals_topk_from_scores_and_the_reference(name,
                                                                 entries):
    """``plan_segment_topk``, the port's one plain top-k after a plan's
    eval, is the JAX package's ``topk_from_scores`` over the same masks
    (the reference's ``run_topk``), byte for byte, ties to the lower doc
    id."""
    for e in entries:
        n = e.scores.shape[0]
        for k in sorted({1, min(10, n), min(100, n), n}):
            for ms in (-np.inf, 2.0):
                vals, idx, tot, mx = tbm25.plan_segment_topk(e, k, ms)
                live = e.live if e.live is not None else torch.ones(
                    n, dtype=torch.bool)
                matched = e.matched & live & (e.scores >= ms)
                if name == "ties" and n > 4096 and k == n:
                    continue          # the reference's top_k at 9,000 is slow
                rv, ri, rt, rm = (np.asarray(x) for x in
                                  jplan.topk_from_scores(
                                      jnp.asarray(e.scores.numpy()), k,
                                      jnp.asarray(matched.numpy())))
                assert rv.tobytes() == vals.numpy().tobytes()
                assert (ri == idx.numpy()).all()
                assert int(rt) == int(tot)
                assert rm.tobytes() == mx.numpy().tobytes()


def test_plan_table_layout():
    rng = np.random.default_rng(5)
    entries = [entry(rng, n) for n in (1, 4096, 4097, 12_000)]
    entries.append(entry(rng, 50, live=False))
    table, n_blocks = cuda_plan.plan_table(
        [(e.scores.data_ptr(), e.matched.data_ptr(),
          0 if e.live is None else e.live.data_ptr()) for e in entries],
        [e.scores.shape[0] for e in entries])
    tiles = [1, 1, 2, 3, 1]
    assert n_blocks == sum(tiles)
    words = cuda_plan.SEG_WORDS
    head = table[: len(entries) * words].reshape(len(entries), words)
    first = np.concatenate([[0], np.cumsum(tiles)[:-1]])
    for s, e in enumerate(entries):
        assert head[s, 0] == e.scores.data_ptr()
        assert head[s, 1] == e.matched.data_ptr()
        assert head[s, 2] == (0 if e.live is None else e.live.data_ptr())
        assert head[s, 3] == e.scores.shape[0]
        assert (head[s, 4], head[s, 5], head[s, 6]) == (first[s], tiles[s],
                                                        s)
    work = table[len(entries) * words: len(entries) * words + n_blocks]
    assert work.tolist() == [(s << 32) | t for s, n in enumerate(tiles)
                             for t in range(n)]
    assert len(table) == len(entries) * words + n_blocks + len(entries)
    assert not table[len(entries) * words + n_blocks:].any()


def test_wrapper_refuses_cpu_tensors():
    rng = np.random.default_rng(1)
    before = cuda_plan.plan_topk_segments_cuda.launches
    with pytest.raises(ValueError, match="CUDA"):
        cuda_plan.plan_topk_segments_cuda([entry(rng, 64)], k=10)
    assert cuda_plan.plan_topk_segments_cuda.launches == before
    got = tbm25.plan_topk_segments_auto([entry(rng, 64)], k=10)
    assert got.vals.device.type == "cpu" and got.vals.shape == (1, 10)
    assert "PLAN_K_MAX" in cuda_plan.defines()


def test_executor_calls_the_plan_topk_once_per_request(monkeypatch):
    """``bool``, ``constant_score``, ``knn``, ``hybrid`` and an
    aggregations request with hits each take every segment's top-k from
    ONE plan top-k call; ``track_total_hits: false`` one a segment it
    does not prune; a scored ``match`` none (K2's own top-k); the answers
    equal the JAX package's."""
    from opensearch_tpu.index.segment import SegmentWriter as JaxWriter
    from opensearch_tpu.mapping.mapper import DocumentMapper as JaxMapper
    from opensearch_tpu.ops import bm25 as jbm25
    from opensearch_tpu.search.executor import ShardSearcher as JaxSearcher
    from opensearch_tpu_torch.index.segment import (segment_arrays,
                                                    segment_from_arrays)
    from opensearch_tpu_torch.mapping.mapper import DocumentMapper
    from opensearch_tpu_torch.search.executor import ShardSearcher
    from opensearch_tpu_torch.testing.parity import (bm25_mismatch,
                                                     knn_mismatch)
    from test_torch_filters import MAPPING, build, filter_docs

    monkeypatch.setattr(jbm25, "HOST_SCORING", False)
    jsegs = build(JaxWriter(), JaxMapper(MAPPING), filter_docs(41, 200))
    jax_s = JaxSearcher(jsegs, JaxMapper(MAPPING))
    port_s = ShardSearcher([segment_from_arrays(*segment_arrays(s))
                            for s in jsegs], DocumentMapper(MAPPING),
                           device="cpu")
    calls = []
    real = tbm25.plan_topk_segments_auto
    monkeypatch.setattr(tbm25, "plan_topk_segments_auto",
                        lambda entries, **kw: (calls.append(len(entries)),
                                               real(entries, **kw))[1])
    n_seg = len(port_s.segments)
    knn = {"knn": {"vec": {"vector": [0.1, -0.2, 0.3, 0.0], "k": 5}}}
    expect = [
        ({"query": {"bool": {"must": [{"match": {"body": "w1 w2"}}],
                             "filter": [{"terms": {"tag": ["g1", "g2"]}}],
                             "boost": -2.0}}, "size": 7}, [n_seg]),
        ({"query": {"constant_score": {"filter": {"term": {"tag": "g3"}}}},
          "size": 12}, [n_seg]),
        ({"query": knn, "size": 5}, [n_seg]),
        ({"query": {"match": {"body": "w1 w3"}}, "size": 5}, []),
        ({"query": {"bool": {"should": [{"match": {"body": "w0"}}],
                             "filter": [{"exists": {"field": "price"}}]}},
          "size": 5, "track_total_hits": False}, None),
        ({"query": {"match": {"body": "w2"}}, "size": 3,
          "aggs": {"t": {"terms": {"field": "tag"}}}}, [n_seg]),
    ]
    for body, want in expect:
        calls.clear()
        got = port_s.search(dict(body))
        if want is None:          # one call per segment not pruned
            assert 1 <= len(calls) <= n_seg and set(calls) == {1}
        else:
            assert calls == want, body
        ref = jax_s.search(dict(body))
        if "knn" in body["query"]:
            assert not knn_mismatch(got, ref)
        elif "track_total_hits" not in body:
            assert not bm25_mismatch(got, ref), body
            assert got.get("aggregations") == ref.get("aggregations")
        assert got["hits"]["hits"]
    hybrid = {"query": {"hybrid": {"queries": [
        {"match": {"body": "w1 w2"}}, knn]}}, "size": 5}
    calls.clear()
    port_s.search(hybrid)
    assert calls == [n_seg]       # the knn sub-query; the match is K2's
