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
        tv, ti = tknn.knn_topk_auto(torch.from_numpy(vectors),
                                    torch.from_numpy(valid),
                                    torch.from_numpy(query), space=space,
                                    k=k)
        rv, ri = jknn.knn_topk(jnp.asarray(vectors), jnp.asarray(valid),
                               jnp.asarray(query), space=space, k=k)
        np.testing.assert_allclose(tv.numpy(), np.asarray(rv), rtol=RTOL,
                                   atol=ATOL)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ri))


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
