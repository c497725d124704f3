"""Ops parity between the PyTorch port and the JAX package on the CPU.

The BM25 ops (``gather_postings``, ``impact_scores``,
``impact_score_count``, ``match_count``, ``compute_impacts``) must equal
the JAX functions byte for byte on the same numpy inputs.  The plain
k-NN scores must match both the JAX ``knn_scores`` and the Pallas kernel
``knn_scores_pallas`` in interpret mode, in all three spaces, within
rtol=1e-5, atol=1e-6 (no summation order is fixed by either), with -inf
on invalid rows; the port also takes any row count.  The CUDA wrappers
refuse CPU tensors: a wrapper never falls back on its own.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opensearch_tpu.ops import bm25 as jbm25
from opensearch_tpu.ops import knn as jknn
from opensearch_tpu.ops.pallas_knn import TILE, knn_scores_pallas
from opensearch_tpu_torch.index.segment import pad_bucket, pad_pow2
from opensearch_tpu_torch.ops import bm25 as tbm25
from opensearch_tpu_torch.ops import cuda_bm25, cuda_knn
from opensearch_tpu_torch.ops import knn as tknn
from opensearch_tpu_torch.testing.parity import topk_mismatch

RTOL, ATOL = 1e-5, 1e-6


def csr_case(seed, n_docs, n_terms, n_query, n_inactive):
    """Random CSR postings (doc-ascending rows) and a padded query bag,
    laid out as the staged segment and ``TermBagPlan.prepare`` lay them
    out."""
    rng = np.random.default_rng(seed)
    offsets = [0]
    docs, tfs = [], []
    for _t in range(n_terms):
        df = int(rng.integers(0, max(2, n_docs // 2)))
        row = np.sort(rng.choice(n_docs, size=df, replace=False))
        docs.extend(row.tolist())
        tfs.extend(rng.integers(1, 6, size=df).tolist())
        offsets.append(len(docs))
    n_pad = pad_pow2(n_docs + 1)
    t_pad_off = pad_pow2(len(offsets))
    off = np.full(t_pad_off, offsets[-1], np.int32)
    off[: len(offsets)] = offsets
    p_pad = pad_pow2(len(docs))
    doc_ids = np.full(p_pad, n_docs, np.int32)
    doc_ids[: len(docs)] = docs
    tf = np.zeros(p_pad, np.float32)
    tf[: len(tfs)] = tfs
    impacts = np.zeros(p_pad, np.float32)
    impacts[: len(docs)] = rng.random(len(docs), dtype=np.float32)
    t_pad = pad_pow2(n_query, minimum=1)
    tids = np.zeros(t_pad, np.int32)
    tids[:n_query] = rng.choice(n_terms, size=n_query, replace=False)
    active = np.zeros(t_pad, bool)
    active[: n_query - n_inactive] = True
    idfs = np.zeros(t_pad, np.float32)
    idfs[:n_query] = (rng.random(n_query) * 3 + 0.1).astype(np.float32)
    weights = np.zeros(t_pad, np.float32)
    weights[:n_query] = (rng.random(n_query) * 2 + 0.5).astype(np.float32)
    budget = pad_bucket(int(sum(offsets[t + 1] - offsets[t]
                                for t in tids[:n_query - n_inactive])))
    return dict(offsets=off, doc_ids=doc_ids, tfs=tf, impacts=impacts,
                tids=tids, active=active, idfs=idfs, weights=weights,
                n_pad=n_pad, budget=budget,
                doc_lens=rng.integers(1, 30, size=n_pad).astype(np.float32))


CASES = [(3, 50, 12, 2, 0), (17, 300, 40, 5, 1), (92, 1000, 64, 8, 2),
         (5, 9, 4, 1, 0), (11, 700, 30, 3, 3)]


def both(c, *names):
    return ([jnp.asarray(c[n]) for n in names],
            [torch.from_numpy(c[n]) for n in names])


@pytest.mark.parametrize("case", CASES)
def test_gather_postings_byte_exact(case):
    c = csr_case(*case)
    j, t = both(c, "offsets", "doc_ids", "tfs", "tids", "active")
    ref = jbm25.gather_postings(*j, budget=c["budget"],
                                pad_doc=c["n_pad"] - 1)
    got = tbm25.gather_postings(*t, budget=c["budget"],
                                pad_doc=c["n_pad"] - 1)
    for r, g in zip(ref, got):
        r = np.asarray(r)
        g = g.numpy()
        assert r.dtype == g.dtype
        np.testing.assert_array_equal(g, r)


@pytest.mark.parametrize("case", CASES)
def test_impact_scores_and_counts_byte_exact(case):
    c = csr_case(*case)
    names = ("offsets", "doc_ids", "impacts", "tids", "active", "idfs",
             "weights")
    j, t = both(c, *names)
    kw = dict(n_pad=c["n_pad"], budget=c["budget"])
    ref = np.asarray(jbm25.impact_scores(*j, **kw))
    got = tbm25.impact_scores(*t, **kw).numpy()
    assert ref.tobytes() == got.tobytes()
    for scored in (True, False):
        rs, rc = jbm25.impact_score_count(*j, **kw, scored=scored)
        gs, gc = tbm25.impact_score_count(*t, **kw, scored=scored)
        assert np.asarray(rs).tobytes() == gs.numpy().tobytes()
        assert np.asarray(rc).tobytes() == gc.numpy().tobytes()
    jm, tm = both(c, "offsets", "doc_ids", "tfs", "tids", "active")
    rm = np.asarray(jbm25.match_count(*jm, **kw))
    gm = tbm25.match_count(*tm, **kw).numpy()
    assert rm.tobytes() == gm.tobytes()
    # several docs match more than one term, so the order matters
    assert (gm >= 2).any() or case[3] - case[4] < 2


@pytest.mark.parametrize("case", CASES[:3])
def test_compute_impacts_matches_host_table_formula(case):
    """Byte for byte against the float32 numpy formula of the reference's
    ``Segment.impact_table`` (the impacts every search stages); within
    rtol=1e-6 (a few float32 ulps) of the jitted JAX
    ``compute_impacts``, whose XLA:CPU program rounds differently from
    its own numpy twin."""
    c = csr_case(*case)
    avgdl = np.float32(17.25)
    tfs, dl = c["tfs"], c["doc_lens"][c["doc_ids"]]
    host = (tfs / (tfs + np.float32(1.2) * (
        np.float32(1.0 - 0.75) + np.float32(0.75) * dl / avgdl))
            ).astype(np.float32)
    _j, t = both(c, "tfs", "doc_ids", "doc_lens")
    got = tbm25.compute_impacts(*t, avgdl).numpy()
    assert host.tobytes() == got.tobytes()
    j, _t = both(c, "tfs", "doc_ids", "doc_lens")
    ref = np.asarray(jbm25.compute_impacts(*j, avgdl))
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=0)


def knn_data(seed, n, d=16, p_valid=0.8):
    rng = np.random.default_rng(seed)
    vectors = rng.normal(size=(n, d)).astype(np.float32)
    valid = rng.random(n) < p_valid
    query = rng.normal(size=d).astype(np.float32)
    return vectors, valid, query


def port_scores(vectors, valid, query, space):
    return tknn.knn_scores(torch.from_numpy(vectors),
                           torch.from_numpy(valid),
                           torch.from_numpy(query), space=space).numpy()


@pytest.mark.parametrize("space", tknn.SPACES)
@pytest.mark.parametrize("seed", [3, 17])
def test_knn_scores_match_jnp_and_pallas_interpret(space, seed):
    vectors, valid, query = knn_data(seed, 2 * TILE)
    got = port_scores(vectors, valid, query, space)
    ref = np.asarray(jknn.knn_scores(jnp.asarray(vectors),
                                     jnp.asarray(valid),
                                     jnp.asarray(query), space=space))
    pal = np.asarray(knn_scores_pallas(jnp.asarray(vectors),
                                       jnp.asarray(valid),
                                       jnp.asarray(query), space=space,
                                       interpret=True))
    assert np.all(np.isneginf(got[~valid]))
    assert np.all(np.isfinite(got[valid]))
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, pal, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("space", tknn.SPACES)
def test_knn_any_row_count(space):
    """The reference's Pallas kernel needs n % 256 == 0; the port's path
    takes any n (here 300 and 7), agreeing with the jnp reference."""
    for n in (300, 7):
        vectors, valid, query = knn_data(92, n)
        got = port_scores(vectors, valid, query, space)
        ref = np.asarray(jknn.knn_scores(jnp.asarray(vectors),
                                         jnp.asarray(valid),
                                         jnp.asarray(query), space=space))
        np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)
        k = min(5, n)
        tv, ti = tknn.knn_topk_segments_auto(
            [tknn.KnnSegment(torch.from_numpy(vectors),
                             torch.from_numpy(valid))],
            torch.from_numpy(query), space=space, k=k)
        rv, ri = jknn.knn_topk(jnp.asarray(vectors), jnp.asarray(valid),
                               jnp.asarray(query), space=space, k=k)
        np.testing.assert_allclose(tv[0].numpy(), np.asarray(rv),
                                   rtol=RTOL, atol=ATOL)
        np.testing.assert_array_equal(ti[0].numpy(), np.asarray(ri))


def test_topk_breaks_ties_by_lower_index_like_lax_top_k():
    scores = np.array([1.0, 3.0, 3.0, -np.inf, 2.0, 3.0, 2.0, -np.inf],
                      np.float32)
    from jax import lax
    rv, ri = lax.top_k(jnp.asarray(scores), 8)
    tv, ti = tbm25.topk(torch.from_numpy(scores), 8)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(rv))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ri))
    assert ti.dtype == torch.int32


def test_cuda_wrappers_refuse_cpu_tensors():
    vectors, valid, query = knn_data(1, 16)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_knn.knn_scores_cuda(torch.from_numpy(vectors),
                                 torch.from_numpy(valid),
                                 torch.from_numpy(query), space="l2")
    c = csr_case(3, 50, 12, 2, 0)
    _j, t = both(c, "offsets", "doc_ids", "impacts", "tids", "active",
                 "idfs", "weights")
    with pytest.raises(ValueError, match="CUDA"):
        cuda_bm25.term_bag_cuda(*t, n_pad=c["n_pad"], budget=c["budget"],
                                scores=True, counts=True)
    assert cuda_knn.knn_scores_cuda.launches == 0
    assert cuda_bm25.term_bag_cuda.launches == 0


# -- the fused top-k over segments (K1's top-k entry) ----------------------

TOPK_K = 16


def segment_cases(seed, d=16):
    """Segments of different sizes: plain, filtered, one with no valid
    row, one shorter than k, one of duplicated rows (ties)."""
    rng = np.random.default_rng(seed)

    def seg(n, p_exists=0.9, p_live=0.9, p_mask=None, rows=None):
        vectors = (rows if rows is not None
                   else rng.normal(size=(n, d)).astype(np.float32))
        mask = None if p_mask is None else rng.random(n) < p_mask
        return (vectors, rng.random(n) < p_exists, rng.random(n) < p_live,
                mask)

    base = rng.normal(size=(8, d)).astype(np.float32)
    dup = base[rng.integers(0, 8, size=512)]
    return [seg(256), seg(512, p_mask=0.3), seg(1024),
            seg(256, p_exists=0.0), seg(8, p_live=0.5),
            seg(512, rows=dup)]


def valid_of(exists, live, mask):
    v = exists & live
    return v if mask is None else v & mask


def as_torch_segments(cases):
    def t(a):
        return None if a is None else torch.from_numpy(a)
    return [tknn.KnnSegment(t(v), t(e), t(lv), t(m)) for v, e, lv, m in cases]


@pytest.mark.parametrize("space", tknn.SPACES)
@pytest.mark.parametrize("seed", [3, 17, 92])
def test_knn_topk_segments_match_jax_knn_topk_and_pallas(space, seed):
    """The plain twin of the fused K1 top-k, segment by segment, against
    the JAX ``knn_topk`` and against ``knn_scores_pallas`` (interpret
    mode) + ``lax.top_k``; a segment shorter than k ends in (-inf, -1),
    and duplicated rows tie-break to the lower id, byte-equal to JAX."""
    from jax import lax
    cases = segment_cases(seed)
    rng = np.random.default_rng(seed + 100)
    query = rng.normal(size=16).astype(np.float32)
    vals, ids = tknn.knn_topk_segments(as_torch_segments(cases),
                                       torch.from_numpy(query), space=space,
                                       k=TOPK_K)
    assert vals.shape == (len(cases), TOPK_K) and ids.dtype == torch.int32
    vals, ids = vals.numpy(), ids.numpy()
    for s, (v, e, lv, m) in enumerate(cases):
        n = v.shape[0]
        kk = min(TOPK_K, n)
        jv, jvalid, jq = (jnp.asarray(v), jnp.asarray(valid_of(e, lv, m)),
                          jnp.asarray(query))
        refs = [jknn.knn_topk(jv, jvalid, jq, space=space, k=kk)]
        if n % TILE == 0:
            refs.append(lax.top_k(knn_scores_pallas(
                jv, jvalid, jq, space=space, interpret=True), kk))
        for rv, ri in refs:
            bad, _err = topk_mismatch(vals[s:s + 1, :kk], ids[s:s + 1, :kk],
                                      np.asarray(rv)[None],
                                      np.asarray(ri)[None])
            assert bad is None, (s, bad)
        assert np.all(np.isneginf(vals[s, kk:])) and np.all(ids[s, kk:] == -1)
    assert np.all(np.isneginf(vals[3])) and list(ids[3]) == list(range(16))
    assert np.isneginf(vals[4]).sum() >= TOPK_K - 8
    dup_ref = jknn.knn_topk(jnp.asarray(cases[5][0]),
                            jnp.asarray(valid_of(*cases[5][1:])),
                            jnp.asarray(query), space=space, k=TOPK_K)[1]
    assert ids[5].tobytes() == np.asarray(dup_ref).astype(np.int32).tobytes()
    assert len(set(np.round(vals[5], 6))) < TOPK_K     # ties were present


def test_knn_topk_segments_auto_takes_the_plain_twin_on_cpu():
    cases = as_torch_segments(segment_cases(5))
    q = torch.from_numpy(np.random.default_rng(6).normal(size=16)
                         .astype(np.float32))
    for k in (1, 10, cuda_knn.K_MAX + 1):
        a = tknn.knn_topk_segments_auto(cases, q, space="l2", k=k)
        b = tknn.knn_topk_segments(cases, q, space="l2", k=k)
        assert a[0].shape == (len(cases), k)
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert cuda_knn.knn_topk_segments_cuda.launches == 0
    assert cuda_knn.knn_topk_segments_cuda.sorted_route_segments == 0


def test_knn_topk_segments_cuda_refuses_cpu_tensors():
    cases = as_torch_segments(segment_cases(7))
    q = torch.zeros(16)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_knn.knn_topk_segments_cuda(cases, q, space="l2", k=10)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_knn.knn_topk_segments_cuda(cases, q, space="l2",
                                        k=cuda_knn.K_MAX + 1)
    with pytest.raises(ValueError, match="space"):
        cuda_knn.knn_topk_segments_cuda(cases, q, space="hamming", k=10)
    assert cuda_knn.knn_topk_segments_cuda.launches == 0


def test_launch_table_layout_and_work_list():
    """The top-k launch's table: per-segment pointers, rows, first chunk
    and chunk count; a work list naming (segment, chunk) for every block
    in order; zeroed counters; an empty segment still takes one chunk."""
    C = cuda_knn.CHUNK_ROWS
    rows = [7, C, C + 1, 16 * C, 0]
    ptrs = [(1000 + 10 * s, 2000 + s, 0 if s == 1 else 3000 + s,
             0 if s != 2 else 4000) for s in range(len(rows))]
    table, n_blocks = cuda_knn.launch_table(ptrs, rows)
    chunks = [1, 1, 2, 16, 1]
    assert n_blocks == sum(chunks)
    S, W = len(rows), cuda_knn.SEG_WORDS
    head = table[: S * W].reshape(S, W)
    np.testing.assert_array_equal(head[:, 0:4], np.asarray(ptrs))
    np.testing.assert_array_equal(head[:, 4], rows)
    np.testing.assert_array_equal(head[:, 5], np.cumsum([0] + chunks[:-1]))
    np.testing.assert_array_equal(head[:, 6], chunks)
    np.testing.assert_array_equal(head[:, 7], range(S))
    work = table[S * W: S * W + n_blocks]
    expect = [(s, c) for s, n in enumerate(chunks) for c in range(n)]
    assert [(int(w) >> 32, int(w) & 0xFFFFFFFF) for w in work] == expect
    counters = table[S * W + n_blocks:].view(np.int32)
    assert counters.shape[0] >= S and not counters.any()
    assert table.dtype == np.int64
    empty, nb = cuda_knn.launch_table([], [])
    assert nb == 0 and empty.shape == (0,)
    # a launch over some segments of a call writes each to its own row
    some, nb = cuda_knn.launch_table(ptrs[1:3], rows[1:3], [1, 2])
    np.testing.assert_array_equal(some[: 2 * W].reshape(2, W)[:, 7], [1, 2])
    assert nb == 3


def test_knn_layout_constants_reach_the_kernel_as_macros():
    """The wrapper is the one source of the chunk size and the table
    layout: ``csrc/knn.cu`` takes them as -D macros, and a library built
    with other values lands at another path."""
    from opensearch_tpu_torch.ops import cuda_build

    assert cuda_knn.defines() == {"KNN_CHUNK_ROWS": cuda_knn.CHUNK_ROWS,
                                  "KNN_K_MAX": cuda_knn.K_MAX,
                                  "KNN_SEG_WORDS": cuda_knn.SEG_WORDS}
    src = (cuda_build.CSRC / "knn.cu").read_text()
    for macro in cuda_knn.defines():
        assert f"= {macro};" in src
    base = cuda_build.library_path("knn", cuda_knn.defines())
    other = cuda_build.library_path(
        "knn", {**cuda_knn.defines(), "KNN_CHUNK_ROWS": 1024})
    assert base != other
    assert base == cuda_build.library_path("knn", cuda_knn.defines())
    assert cuda_build.library_path("bm25") == \
        cuda_build.library_path("bm25", {})


@pytest.mark.parametrize("k,kp,sorted_route", [
    (1, 1, False), (10, 16, False), (100, 128, False),
    (cuda_knn.K_MAX, cuda_knn.K_MAX, False), (cuda_knn.K_MAX + 1, None, True),
    (10_000, None, True)])
def test_k_routing_and_padding(k, kp, sorted_route):
    """k up to K_MAX is selected inside the kernel, kept per chunk as a
    power of two; above K_MAX the scores-only entry + stable sort serve
    (a segment of the scale phase's 65,536 rows)."""
    assert cuda_knn.uses_sorted_route(k, 65_536) is sorted_route
    if kp is not None:
        assert cuda_knn.k_padded(k) == kp
    assert cuda_knn.K_MAX >= 256


@pytest.mark.parametrize("n,k,sorted_route", [
    (1_000_000, 10, False), (1_000_000, 100, False), (1_000_000, 256, True),
    (1_000_000, 129, True), (65_536, 256, False), (0, 256, False)])
def test_sorted_route_for_a_large_merge(n, k, sorted_route):
    """A segment whose merge would take more than MERGE_MAX_CANDIDATES
    candidates (chunks x k rounded up to a power of two) takes the
    scores-only entry + stable sort; the limit itself still merges."""
    assert cuda_knn.uses_sorted_route(k, n) is sorted_route
    limit = cuda_knn.MERGE_MAX_CANDIDATES
    kp = cuda_knn.k_padded(k)
    at_limit = limit // kp * cuda_knn.CHUNK_ROWS
    assert not cuda_knn.uses_sorted_route(k, at_limit)
    assert cuda_knn.uses_sorted_route(k, at_limit + 1)
