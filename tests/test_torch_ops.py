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


def case_bag(c, scores: bool = True) -> tbm25.DenseBag:
    """A ``csr_case`` as the dense entry's bag: the staged rows as CPU
    tensors, the slots' posting ranges read from the host offsets."""
    tids = c["tids"]
    rows = np.stack([c["offsets"][tids], c["offsets"][tids + 1]],
                    axis=1).astype(np.int64)
    return tbm25.DenseBag(
        torch.from_numpy(c["offsets"]), torch.from_numpy(c["doc_ids"]),
        torch.from_numpy(c["impacts"]) if scores else None, c["n_pad"],
        tids, c["active"], c["idfs"], c["weights"], rows, c["budget"])


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
    j, _t = both(c, *names)
    kw = dict(n_pad=c["n_pad"], budget=c["budget"])
    # the dispatcher the plans call, on CPU tensors: its plain version
    (got, none), = tbm25.term_bag_dense_auto([case_bag(c)], scores=True,
                                             counts=False)
    ref = np.asarray(jbm25.impact_scores(*j, **kw))
    assert none is None and ref.tobytes() == got.numpy().tobytes()
    rs, rc = jbm25.impact_score_count(*j, **kw, scored=True)
    (gs, gc), = tbm25.term_bag_dense_auto([case_bag(c)], scores=True,
                                          counts=True)
    assert np.asarray(rs).tobytes() == gs.numpy().tobytes()
    assert np.asarray(rc).tobytes() == gc.numpy().tobytes()
    jm, _tm = both(c, "offsets", "doc_ids", "tfs", "tids", "active")
    rm = np.asarray(jbm25.match_count(*jm, **kw))
    (none, gm), = tbm25.term_bag_dense_auto([case_bag(c, scores=False)],
                                            scores=False, counts=True)
    gm = gm.numpy()
    assert none is None and rm.tobytes() == gm.tobytes()
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


@pytest.mark.parametrize("space", tknn.SPACES)
def test_knn_scores_do_not_depend_on_summation_order(space):
    """The plain version sums in float64 and rounds each score to
    float32 once, as K1 does: sums in another order (numpy's, over the
    dimensions reversed) give the same bytes, so the card and the CPU
    agree exactly and a hybrid's min_max has no float32 noise to
    magnify."""
    rng = np.random.default_rng(21)
    vectors = rng.standard_normal((3000, 128)).astype(np.float32)
    query = rng.standard_normal(128).astype(np.float32)
    v = vectors[:, ::-1].astype(np.float64)
    q = query[::-1].astype(np.float64)
    dots = np.einsum("ij,j->i", v, q)
    v2 = np.einsum("ij,ij->i", v, v)
    if space == "l2":
        want = 1.0 / (1.0 + np.maximum(v2 - 2.0 * dots + q @ q, 0.0))
    elif space == "cosinesimil":
        cos = dots / np.maximum(np.sqrt(v2) * np.sqrt(q @ q), 1e-30)
        want = (1.0 + cos) / 2.0
    else:
        want = np.where(dots >= 0, dots + 1.0, 1.0 / (1.0 - dots))
    got = tknn.knn_scores(torch.from_numpy(vectors),
                          torch.ones(len(vectors), dtype=torch.bool),
                          torch.from_numpy(query), space=space)
    assert got.dtype == torch.float32
    assert got.numpy().tobytes() == want.astype(np.float32).tobytes()


@pytest.mark.parametrize("space", tknn.SPACES)
@pytest.mark.parametrize("seed", [5, 29])
def test_knn_topk_batch_matches_jax(space, seed):
    """``knn_topk_batch`` (one float32 [n, d] x [d, Q] product) against
    the JAX package's: the same ids (tied rows, duplicated vectors, take
    the lower index first), scores within rtol=1e-5 / atol=1e-6, invalid
    rows at -inf when k exceeds the valid rows; and against the plain
    ``knn_topk`` one query at a time."""
    rng = np.random.default_rng(seed)
    n, d, q, k = 300, 24, 7, 12
    vecs = rng.standard_normal((n, d)).astype(np.float32)
    vecs[100:110] = vecs[3]                 # ties with row 3
    valid = rng.random(n) > 0.1
    valid[3] = valid[100:110] = True
    queries = rng.standard_normal((q, d)).astype(np.float32)
    queries[0] = vecs[3] * 0.5              # row 3's twins lead query 0
    want_v, want_i = (np.asarray(a) for a in jknn.knn_topk_batch(
        jnp.asarray(vecs), jnp.asarray(valid), jnp.asarray(queries),
        space=space, k=k))
    got_v, got_i = tknn.knn_topk_batch(
        torch.from_numpy(vecs), torch.from_numpy(valid),
        torch.from_numpy(queries), space=space, k=k)
    assert got_v.dtype == torch.float32 and got_i.dtype == torch.int32
    assert got_v.shape == got_i.shape == (q, k)
    np.testing.assert_array_equal(got_i.numpy(), want_i)
    np.testing.assert_allclose(got_v.numpy(), want_v, rtol=RTOL, atol=ATOL)
    if space != "innerproduct":
        # the twins score equal and come out in index order
        assert got_i[0, :11].tolist() == [3, *range(100, 110)]
    for j in range(q):
        one_v, one_i = tknn.knn_topk(
            torch.from_numpy(vecs), torch.from_numpy(valid),
            torch.from_numpy(queries[j]), space=space, k=k)
        assert topk_mismatch(got_v[j: j + 1].numpy(),
                             got_i[j: j + 1].numpy(),
                             one_v[None].numpy(),
                             one_i[None].numpy())[0] is None
    few = np.zeros(n, bool)
    few[[7, 8]] = True
    v, i = tknn.knn_topk_batch(torch.from_numpy(vecs), torch.from_numpy(few),
                               torch.from_numpy(queries), space=space, k=4)
    assert np.isneginf(v[:, 2:].numpy()).all()
    assert sorted(i[0, :2].tolist()) == [7, 8]


def test_cuda_wrappers_refuse_cpu_tensors():
    vectors, valid, query = knn_data(1, 16)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_knn.knn_scores_cuda(torch.from_numpy(vectors),
                                 torch.from_numpy(valid),
                                 torch.from_numpy(query), space="l2")
    c = csr_case(3, 50, 12, 2, 0)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_bm25.term_bag_dense_cuda([case_bag(c)], scores=True,
                                      counts=True)
    (scores, counts), = tbm25.term_bag_dense_auto([case_bag(c)],
                                                  scores=True, counts=True)
    assert scores.shape == counts.shape == (c["n_pad"],)
    assert cuda_knn.knn_scores_cuda.launches == 0
    assert cuda_bm25.dense_f32.launches == 0


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

    assert cuda_knn.defines() == {
        "KNN_CHUNK_ROWS": cuda_knn.CHUNK_ROWS, "KNN_K_MAX": cuda_knn.K_MAX,
        "KNN_SEG_WORDS": cuda_knn.SEG_WORDS,
        "KNN_SCORE_MIN_BLOCKS": cuda_knn.SCORE_BLOCKS_PER_SM}
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


# -- a scored term bag's top-k over segments (K2's top-k entry) ------------

BAG_MAPPING = {"properties": {"body": {"type": "text"}}}
# (terms, required, weights): an OR bag (the fast path), an AND bag,
# minimum_should_match, and a negative weight (scores of either sign;
# matched by counts)
BAGS = {"or": (["w0", "w1", "w3"], 1, [1.0, 1.0, 1.0]),
        "and": (["w0", "w2"], 2, [1.0, 1.0]),
        "msm": (["w0", "w1", "w4", "w5"], 2, [1.0, 1.0, 1.0, 1.0]),
        "negative": (["w0", "w1", "w2"], 1, [1.0, -0.5, 1.0])}
BAG_KS = (1, 10, cuda_bm25.K_MAX, cuda_bm25.K_MAX + 1)


def bag_corpus():
    """Two segments (150 and 90 docs) built by the JAX package, with
    deletes, and with every fourth doc a copy of the one before (equal
    scores: ties); the port's segments carry the same arrays."""
    from opensearch_tpu.index.segment import SegmentWriter as JaxWriter
    from opensearch_tpu.mapping.mapper import DocumentMapper as JaxMapper
    from opensearch_tpu.search.executor import ShardSearcher as JaxSearcher
    from opensearch_tpu_torch.index.segment import (segment_arrays,
                                                    segment_from_arrays)
    from opensearch_tpu_torch.mapping.mapper import DocumentMapper
    from opensearch_tpu_torch.search.executor import ShardSearcher

    rng = np.random.default_rng(21)
    bodies = []
    for i in range(240):
        if i % 4 == 3:
            bodies.append(bodies[-1])
            continue
        words = (rng.zipf(1.3, size=int(rng.integers(4, 25))) - 1) % 40
        bodies.append(" ".join(f"w{w}" for w in words))
    mapper = JaxMapper(BAG_MAPPING)
    parsed = [mapper.parse(str(i), {"body": b}) for i, b in enumerate(bodies)]
    writer = JaxWriter()
    jsegs = [writer.build(parsed[:150], "s0"), writer.build(parsed[150:], "s1")]
    for seg in jsegs:
        seg.apply_deletes(rng.choice(seg.n_docs, size=12, replace=False))
    tsegs = [segment_from_arrays(*segment_arrays(s)) for s in jsegs]
    return (JaxSearcher(jsegs, mapper),
            ShardSearcher(tsegs, DocumentMapper(BAG_MAPPING), device="cpu"))


@pytest.fixture(scope="module")
def bag_searchers():
    return bag_corpus()


def bag_bind(jax_searcher, name):
    terms, required, weights = BAGS[name]
    ctx = jax_searcher.ctx
    stats = ctx.field_stats("body")
    idfs = np.asarray([jbm25.idf(ctx.df("body", t), stats.doc_count)
                       for t in terms], np.float32)
    return {"terms": tuple(terms), "idfs": idfs,
            "weights": np.asarray(weights, np.float32),
            "avgdl": stats.avgdl, "required": required}


def port_bag_inputs(port_searcher, bind):
    from opensearch_tpu_torch.search import plan as tplan
    from opensearch_tpu_torch.search.executor import build_arrays

    plan = tplan.TermBagPlan(field="body")
    ctx = port_searcher.ctx
    inputs = []
    for seg in port_searcher.segments:
        dseg = seg.device("cpu")
        A = build_arrays(dseg, plan.arrays(), port_searcher.mapper,
                         live=ctx.live_mask(seg, dseg))
        inputs.append(plan.topk_input(bind, seg, dseg, A))
    return inputs


@pytest.mark.parametrize("with_min_score", [False, True],
                         ids=["all", "min_score"])
@pytest.mark.parametrize("k", BAG_KS)
@pytest.mark.parametrize("bag", list(BAGS))
def test_term_bag_topk_segments_match_jax_host_topk_and_run_topk(
        bag, k, with_min_score, bag_searchers, monkeypatch):
    """The plain twin of the fused K2 top-k, segment by segment, byte for
    byte against the reference's ``TermBagPlan.host_topk`` and its
    ``run_topk`` on the device lowering (``HOST_SCORING = False``): the
    matched docs' scores and ids (ties to the lower doc id), then
    ``(-inf, -1)``; the matched total and the max; deleted docs and docs
    below ``min_score`` excluded from both."""
    from opensearch_tpu.search import executor as jexec
    from opensearch_tpu.search import plan as jplan

    monkeypatch.setattr(jbm25, "HOST_SCORING", False)
    jax_s, port_s = bag_searchers
    bind = bag_bind(jax_s, bag)
    plan = jplan.TermBagPlan(field="body")
    ctx = jax_s.ctx
    ms = None
    if with_min_score:
        all_vals = np.concatenate([plan.host_topk(
            bind, seg, ctx.lives[id(seg)], seg.n_docs)[0]
            for seg in jax_s.segments])
        ms = float(np.float32(np.median(all_vals)))
    ms_port = -np.inf if ms is None else ms
    vals, ids, totals, maxes = tbm25.term_bag_topk_segments(
        port_bag_inputs(port_s, bind), k=k, min_score=ms_port).numpy()
    assert vals.shape == (2, k) and ids.dtype == np.int32
    for s, seg in enumerate(jax_s.segments):
        hv, hi, htot, hmx = plan.host_topk(bind, seg, ctx.lives[id(seg)],
                                           min(k, seg.n_docs), ms)
        dseg = seg.device()
        dims, ins = plan.prepare(bind, seg, dseg, ctx)
        A = jexec.build_arrays(dseg, plan.arrays(), jax_s.mapper,
                               live=ctx.live_jnp(seg, dseg))
        rv, ri, rtot, rmx = (np.asarray(x) for x in jplan.run_topk(
            plan, dims, min(k, dseg.n_pad), A, ins,
            np.float32(-np.inf if ms is None else ms)))
        m = len(hv)
        assert vals[s, :m].tobytes() == np.asarray(hv, np.float32).tobytes()
        assert vals[s, :m].tobytes() == rv[:m].tobytes()
        assert ids[s, :m].tolist() == np.asarray(hi).tolist() == \
            ri[:m].tolist()
        assert np.all(np.isneginf(vals[s, m:])) and np.all(ids[s, m:] == -1)
        assert np.all(np.isneginf(rv[m:]))
        assert totals[s] == htot == int(rtot)
        assert np.float32(maxes[s]).tobytes() == np.float32(hmx).tobytes() \
            == np.float32(rmx).tobytes()
        if k == cuda_bm25.K_MAX and bag == "or" and not with_min_score:
            assert len(set(vals[s, :m].tolist())) < m      # ties present
            everyone = plan.host_topk(bind, seg, np.ones(seg.n_docs, bool),
                                      seg.n_docs)[2]
            assert everyone > htot                         # deletes matter
        if with_min_score:
            assert m == 0 or vals[s, m - 1] >= ms


def test_term_bag_launch_table_layout_and_work_list():
    """K2's top-k table: per-segment pointers, n_pad, first tile and tile
    count, output row, first slot and slot count, required and fast flag;
    two words per active slot (row range; idf and weight bits, a negative
    weight too); a work list naming (segment, tile) for every block in
    order; zeroed counters, totals and max keys."""
    T = cuda_bm25.TILE_DOCS
    n_pads = [8, T, 2 * T, 16 * T]
    ptrs = [(100 + s, 200 + s, 300 + s) for s in range(4)]
    slot_counts = [1, 0, 3, 2]
    rows = np.array([[0, 5], [7, 9], [9, 9], [20, 4000], [1, 2], [3, 2 ** 30]])
    idfs = np.float32([0.5, 1.25, 2.0, 3.0, 0.1, 7.5])
    weights = np.float32([1.0, -0.5, 2.0, 1.0, 1.0, 0.25])
    table, n_blocks, n_slots = cuda_bm25.launch_table(
        ptrs, n_pads, slot_counts, rows, idfs, weights, [1, 1, 2, 1],
        [True, True, False, False])
    tiles = [1, 1, 2, 16]
    assert (n_blocks, n_slots) == (sum(tiles), 6)
    S, W = 4, cuda_bm25.SEG_WORDS
    head = table[: S * W].reshape(S, W)
    np.testing.assert_array_equal(head[:, 0:3], np.asarray(ptrs))
    np.testing.assert_array_equal(head[:, 3], n_pads)
    np.testing.assert_array_equal(head[:, 4], np.cumsum([0] + tiles[:-1]))
    np.testing.assert_array_equal(head[:, 5], tiles)
    np.testing.assert_array_equal(head[:, 6], range(S))
    np.testing.assert_array_equal(head[:, 7], [0, 1, 1, 4])
    np.testing.assert_array_equal(head[:, 8], slot_counts)
    np.testing.assert_array_equal(head[:, 9], [1, 1, 2, 1])
    np.testing.assert_array_equal(head[:, 10], [1, 1, 0, 0])
    pairs = table[S * W: S * W + 2 * n_slots].reshape(-1, 2).view(np.uint64)
    np.testing.assert_array_equal(pairs[:, 0] & 0xFFFFFFFF, rows[:, 0])
    np.testing.assert_array_equal(pairs[:, 0] >> np.uint64(32), rows[:, 1])
    bits = (pairs[:, 1] & 0xFFFFFFFF).astype(np.uint32).view(np.float32)
    np.testing.assert_array_equal(bits, idfs)
    bits = (pairs[:, 1] >> np.uint64(32)).astype(np.uint32).view(np.float32)
    np.testing.assert_array_equal(bits, weights)
    at = S * W + 2 * n_slots
    work = table[at: at + n_blocks]
    expect = [(s, t) for s, n in enumerate(tiles) for t in range(n)]
    assert [(int(w) >> 32, int(w) & 0xFFFFFFFF) for w in work] == expect
    zeros = table[at + n_blocks:].view(np.int32)
    assert zeros.shape[0] >= 3 * S and not zeros.any()
    assert table.dtype == np.int64
    # a segment's output row, when the launch serves some of a call's
    _t, _n, _s = cuda_bm25.launch_table(ptrs[1:3], n_pads[1:3], [0, 3],
                                        rows[1:4], idfs[1:4], weights[1:4],
                                        [1, 2], [True, False], [1, 2])
    np.testing.assert_array_equal(_t[: 2 * W].reshape(2, W)[:, 6], [1, 2])


def test_segments_table_reads_the_active_slots_in_slot_order(bag_searchers):
    """``segments_table`` lays out ``TermBagSegment``s as ``launch_table``
    does, skipping inactive slots (a term absent from a segment)."""
    jax_s, port_s = bag_searchers
    bind = bag_bind(jax_s, "msm")
    bind = {**bind, "terms": bind["terms"][:3] + ("absent",)}
    inputs = port_bag_inputs(port_s, bind)
    table, n_blocks, n_slots = cuda_bm25.segments_table(inputs)
    act = [seg.active for seg in inputs]
    assert n_slots == sum(int(a.sum()) for a in act) and not any(
        a[3] for a in act)
    expect, _nb, _ns = cuda_bm25.launch_table(
        [(s.doc_ids.data_ptr(), s.impacts.data_ptr(), s.live.data_ptr())
         for s in inputs], [s.live.shape[0] for s in inputs],
        [int(a.sum()) for a in act],
        np.concatenate([s.rows[s.active] for s in inputs]),
        np.concatenate([s.idfs[s.active] for s in inputs]),
        np.concatenate([s.weights[s.active] for s in inputs]),
        [s.required for s in inputs], [s.fast for s in inputs])
    np.testing.assert_array_equal(table, expect)
    seg0 = port_s.segments[0]
    pf = seg0.postings["body"]
    for i, t in enumerate(bind["terms"][:3]):
        tid = pf.term_id(t)
        assert inputs[0].rows[i].tolist() == [pf.offsets[tid],
                                              pf.offsets[tid + 1]]


def test_term_bag_layout_constants_reach_the_kernel_as_macros():
    """The wrapper is the one source of the tile size, K_MAX and the
    table layout: ``csrc/bm25.cu`` takes them as -D macros, and a library
    built with other values lands at another path."""
    from opensearch_tpu_torch.ops import cuda_build

    assert cuda_bm25.defines() == {"BM25_TILE_DOCS": cuda_bm25.TILE_DOCS,
                                   "BM25_K_MAX": cuda_bm25.K_MAX,
                                   "BM25_SEG_WORDS": cuda_bm25.SEG_WORDS,
                                   "BM25_QSEG_WORDS": cuda_bm25.QSEG_WORDS,
                                   "BM25_QSLOT_WORDS":
                                       cuda_bm25.QSLOT_WORDS,
                                   "BM25_FOLD_TILE_DOCS":
                                       cuda_bm25.FOLD_TILE_DOCS}
    src = (cuda_build.CSRC / "bm25.cu").read_text()
    for macro in cuda_bm25.defines():
        assert f"= {macro};" in src
    assert '#include "topk.cuh"' in src
    base = cuda_build.library_path("bm25", cuda_bm25.defines())
    assert base != cuda_build.library_path(
        "bm25", {**cuda_bm25.defines(), "BM25_TILE_DOCS": 2048})
    assert base == cuda_build.library_path("bm25", cuda_bm25.defines())


@pytest.mark.parametrize("edited", ["topk.cuh", "bm25.cu", "knn.cu"])
def test_library_path_hashes_the_shared_headers(edited, tmp_path,
                                                monkeypatch):
    """A library's path changes with its source and with every header of
    ``csrc/``, so an edited header never loads a stale build; a source
    edit leaves the other library's path alone."""
    import shutil

    from opensearch_tpu_torch.ops import cuda_build

    csrc = tmp_path / "csrc"
    shutil.copytree(cuda_build.CSRC, csrc)
    monkeypatch.setattr(cuda_build, "CSRC", csrc)
    defs = {"bm25": cuda_bm25.defines(), "knn": cuda_knn.defines()}
    before = {n: cuda_build.library_path(n, d) for n, d in defs.items()}
    with open(csrc / edited, "a") as f:
        f.write("\n// edited\n")
    after = {n: cuda_build.library_path(n, d) for n, d in defs.items()}
    for name in defs:
        changed = edited == "topk.cuh" or edited == f"{name}.cu"
        assert (before[name] != after[name]) is changed, name


def test_term_bag_topk_segments_cuda_refuses_cpu_tensors(bag_searchers):
    jax_s, port_s = bag_searchers
    inputs = port_bag_inputs(port_s, bag_bind(jax_s, "or"))
    for k in (10, cuda_bm25.K_MAX + 1):
        with pytest.raises(ValueError, match="CUDA"):
            cuda_bm25.term_bag_topk_segments_cuda(inputs, k=k)
    with pytest.raises(ValueError, match="k must be"):
        cuda_bm25.term_bag_topk_segments_cuda(inputs, k=0)
    assert cuda_bm25.term_bag_topk_segments_cuda.launches == 0
    assert cuda_bm25.term_bag_topk_segments_cuda.sorted_route_segments == 0


@pytest.mark.parametrize("bag", list(BAGS))
def test_term_bag_topk_segments_auto_takes_the_plain_twin_on_cpu(
        bag, bag_searchers):
    jax_s, port_s = bag_searchers
    inputs = port_bag_inputs(port_s, bag_bind(jax_s, bag))
    for k in BAG_KS:
        for ms in (-np.inf, 1.0):
            a = tbm25.term_bag_topk_segments_auto(inputs, k=k, min_score=ms)
            b = tbm25.term_bag_topk_segments(inputs, k=k, min_score=ms)
            assert a.vals.shape == (len(inputs), k)
            assert a.packed.device.type == "cpu"
            assert all(x.tobytes() == y.tobytes()
                       for x, y in zip(a.numpy(), b.numpy()))
    assert cuda_bm25.term_bag_topk_segments_cuda.launches == 0
    assert cuda_bm25.dense_f32.launches == 0


@pytest.mark.parametrize("k,kp", [(1, 1), (10, 16), (100, 128),
                                  (cuda_bm25.K_MAX, cuda_bm25.K_MAX)])
def test_term_bag_k_padding_and_tiles(k, kp):
    """Each tile keeps k rounded up to a power of two, at most K_MAX; a
    segment takes one block per TILE_DOCS docs, at least one."""
    assert cuda_bm25.k_padded(k) == kp <= cuda_bm25.K_MAX
    T = cuda_bm25.TILE_DOCS
    assert [cuda_bm25.n_tiles(n) for n in (8, T, T + 1, 65_536)] == \
        [1, 1, 2, -(-65_536 // T)]


def test_term_bag_topk_result_reads_back_in_one_copy():
    """The four outputs are views of one packed buffer, which
    ``numpy()`` copies once and splits."""
    out = tbm25.empty_topk(3, 4, "cpu")
    out.vals.copy_(torch.arange(12, dtype=torch.float32).view(3, 4))
    out.ids.copy_(torch.arange(12, dtype=torch.int32).view(3, 4) - 5)
    out.totals.copy_(torch.tensor([7, 8, 9], dtype=torch.int32))
    out.maxes.copy_(torch.tensor([1.5, -np.inf, 0.0]))
    for t in out[:4]:
        assert t.untyped_storage().data_ptr() == \
            out.packed.untyped_storage().data_ptr()
    v, i, t, m = out.numpy()
    np.testing.assert_array_equal(v, np.arange(12, dtype=np.float32)
                                  .reshape(3, 4))
    np.testing.assert_array_equal(i, np.arange(12).reshape(3, 4) - 5)
    assert t.tolist() == [7, 8, 9] and m.tolist() == [1.5, -np.inf, 0.0]
