"""The port's IVF / IVF-PQ (``opensearch_tpu_torch/ops/ivf.py``) on the
CPU against the JAX package's ``opensearch_tpu/ops/ivf.py``.

- On an index the JAX package trained, carried across with
  ``ivf_index_from_arrays`` / ``ivfpq_index_from_arrays``, each search
  function equals the reference's in every space: the same probed
  clusters, equal ids, scores within rtol 1e-5 / atol 1e-6 (l2 scores
  also within the reference's own float32 error, which its cancelling
  sum ``|v|^2 - 2 v.q + |q|^2`` makes larger near a stored row:
  ``reference_l2_slack``; the port sums in float64).
- ``train_kmeans`` on separated clusters gives the reference's
  assignments and centroids within rtol 1e-5; the port's own indexes
  meet the reference's recall bars (0.9 IVF, 0.7 IVF-PQ); two trainings
  are byte-equal.
- Ties go to the lower flat index ``probe_rank * c_pad + position``,
  not the lower doc id.
- The kernels' layout (``stage_index``) and plain twins
  (``ivf_search_segments``, ``ivfpq_search_segments``) equal the
  reference-signature versions byte for byte, over several segments and
  queries, deletes, clusters of one row, k past the candidates; the
  launch table's layout; the dispatchers take the plain twins on the
  CPU and the CUDA wrappers refuse CPU tensors.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from opensearch_tpu.ops import ivf as jivf
from opensearch_tpu_torch.ops import cuda_ivf, ivf
from opensearch_tpu_torch.ops.knn import ATOL, RTOL

SPACES = ("l2", "cosinesimil", "innerproduct")


def corpus(n=2000, d=32, seed=5, clusters=30):
    """``tests/test_ivf.py``'s clustered corpus."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(clusters, d)).astype(np.float32) * 4
    assign = rng.integers(0, clusters, size=n)
    x = centers[assign] + rng.normal(size=(n, d)).astype(np.float32)
    return x.astype(np.float32)


def exact_top10(x, q):
    d2 = ((x - q) ** 2).sum(axis=1)
    return set(np.argsort(d2, kind="stable")[:10])


def queries(x, n, seed, scale=0.1):
    rng = np.random.default_rng(seed)
    return [x[rng.integers(len(x))] + rng.normal(size=x.shape[1]).astype(
        np.float32) * scale for _ in range(n)]


def jax_probes(centroids, q, nprobe):
    """The reference's probe (``opensearch_tpu/ops/ivf.py`` ``ivf_search``)."""
    c = jnp.asarray(centroids)
    cd = jnp.sum(c * c, axis=1) - 2.0 * (c @ jnp.asarray(q))
    return np.asarray(jax.lax.top_k(-cd, nprobe)[1])


def reference_l2_slack(x, ids, q, scores):
    """The reference's own float32 error in an l2 score: it sums ``d2 =
    |v|^2 - 2 v.q + |q|^2`` in float32 (the port in float64), and each
    term can carry 2 ulps, so ``d2`` is off by up to ``4 * 2^-23 * (|v|^2
    + 2 |v.q| + |q|^2)`` and the score ``1 / (1 + d2)`` by that times
    ``score^2``.  Near a stored row (``|v - q|`` small beside ``|v|``)
    this exceeds rtol 1e-5."""
    v = x[np.maximum(ids, 0)].astype(np.float64)
    qd = q.astype(np.float64)
    terms = (v * v).sum(1) + 2 * np.abs(v @ qd) + qd @ qd
    return np.where(ids >= 0, scores.astype(np.float64) ** 2 * 4 * 2.0 ** -23
                    * terms, 0.0)


def assert_close_hits(got, want, slack=0.0):
    """Equal ids and -inf slots; finite scores within rtol 1e-5 / atol
    1e-6 (plus ``slack`` per hit: ``reference_l2_slack``)."""
    gv, gi = (np.asarray(t) for t in got)
    wv, wi = (np.asarray(t) for t in want)
    np.testing.assert_array_equal(gi, wi)
    np.testing.assert_array_equal(np.isneginf(gv), np.isneginf(wv))
    fin = ~np.isneginf(wv)
    err = np.abs(gv[fin].astype(np.float64) - wv[fin])
    bound = ATOL + RTOL * np.abs(wv[fin]) + np.broadcast_to(slack,
                                                           wv.shape)[fin]
    assert (err <= bound).all(), (gv, wv, err - bound)


@pytest.fixture(scope="module")
def jax_ivf():
    x = corpus(n=1200, d=24)
    valid = np.ones(len(x), bool)
    valid[::23] = False                  # rows without the field
    return x, valid, jivf.IvfIndex.build(x, valid, nlist=24, iters=8)


@pytest.fixture(scope="module")
def jax_pq():
    x = corpus(n=1000, d=32, seed=8)
    valid = np.ones(len(x), bool)
    return x, valid, jivf.IvfPqIndex.build(x, valid, nlist=16, m=8)


def carried_ivf(idx):
    return ivf.ivf_index_from_arrays(idx.centroids, idx.grouped,
                                     idx.grouped_ids, idx.grouped_valid)


def carried_pq(idx):
    return ivf.ivfpq_index_from_arrays(idx.centroids, idx.codebooks,
                                       idx.grouped_codes, idx.grouped_ids,
                                       idx.grouped_valid)


def live_mask(n, seed):
    live = np.ones(n, bool)
    live[np.random.default_rng(seed).choice(n, size=n // 10,
                                            replace=False)] = False
    return live


@pytest.mark.parametrize("space", SPACES)
@pytest.mark.parametrize("nprobe", [1, 3, 24])
def test_ivf_search_equals_jax_on_a_jax_trained_index(jax_ivf, space,
                                                      nprobe):
    x, _valid, jidx = jax_ivf
    tidx = carried_ivf(jidx)
    live = live_mask(len(x), 4)
    for q in queries(x, 6, seed=nprobe):
        probes = ivf.probe(tidx.centroids, torch.from_numpy(q), nprobe)
        np.testing.assert_array_equal(
            probes.numpy(), jax_probes(jidx.centroids, q, nprobe))
        for k in (1, 10):
            want = jivf.ivf_search(*jidx.device(), jnp.asarray(q),
                                   jnp.asarray(live), space=space, k=k,
                                   nprobe=nprobe)
            got = ivf.ivf_search(*tidx.arrays(), torch.from_numpy(q),
                                 torch.from_numpy(live), space=space, k=k,
                                 nprobe=nprobe)
            slack = (reference_l2_slack(x, np.asarray(want[1]), q,
                                        np.asarray(want[0]))
                     if space == "l2" else 0.0)
            assert_close_hits(got, want, slack)


def test_ivf_search_batch_equals_jax(jax_ivf):
    x, _valid, jidx = jax_ivf
    tidx = carried_ivf(jidx)
    qs = np.stack(queries(x, 5, seed=3))
    live = np.ones(len(x), bool)
    want = jivf.ivf_search_batch(*jidx.device(), jnp.asarray(qs),
                                 jnp.asarray(live), space="l2", k=7,
                                 nprobe=4)
    got = ivf.ivf_search_batch(*tidx.arrays(), torch.from_numpy(qs),
                               torch.from_numpy(live), space="l2", k=7,
                               nprobe=4)
    slack = np.stack([reference_l2_slack(x, np.asarray(want[1][i]), q,
                                         np.asarray(want[0][i]))
                      for i, q in enumerate(qs)])
    assert_close_hits(got, want, slack)


@pytest.mark.parametrize("nprobe", [1, 4, 16])
def test_ivfpq_search_equals_jax_on_a_jax_trained_index(jax_pq, nprobe):
    x, _valid, jidx = jax_pq
    tidx = carried_pq(jidx)
    live = live_mask(len(x), 6)
    for q in queries(x, 6, seed=10 + nprobe, scale=0.05):
        probes = ivf.probe(tidx.centroids, torch.from_numpy(q), nprobe)
        np.testing.assert_array_equal(
            probes.numpy(), jax_probes(jidx.centroids, q, nprobe))
        for k in (1, 10):
            want = jivf.ivfpq_search_l2(*jidx.device(), jnp.asarray(q),
                                        jnp.asarray(live), k=k,
                                        nprobe=nprobe)
            got = ivf.ivfpq_search_l2(*tidx.arrays(), torch.from_numpy(q),
                                      torch.from_numpy(live), k=k,
                                      nprobe=nprobe)
            assert_close_hits(got, want)


def test_train_kmeans_matches_jax_on_separated_clusters():
    rng = np.random.default_rng(2)
    centers = rng.normal(size=(6, 8)).astype(np.float32) * 20
    x = (centers[rng.integers(0, 6, size=600)]
         + rng.normal(size=(600, 8)).astype(np.float32)).astype(np.float32)
    valid = np.ones(len(x), bool)
    valid[::50] = False
    jc, ja = jivf.train_kmeans(x, valid, 6, iters=12)
    tc, ta = ivf.train_kmeans(x, valid, 6, iters=12)
    np.testing.assert_array_equal(ta.numpy(), ja)
    np.testing.assert_allclose(tc.numpy(), jc, rtol=1e-5, atol=1e-6)
    # every valid point assigned to its nearest centroid
    d2 = ((x[:, None, :] - tc.numpy()[None]) ** 2).sum(-1)
    np.testing.assert_array_equal(ta.numpy()[valid], d2.argmin(1)[valid])
    assert (ta.numpy()[~valid] == 6).all()


def test_segment_sums_are_exact_float64_sums_per_key():
    rng = np.random.default_rng(4)
    x = rng.normal(size=(1000, 5)) * 10.0 ** rng.integers(-3, 4, (1000, 1))
    keys = rng.integers(0, 37, size=1000)
    got = ivf._segment_sums(torch.from_numpy(x), torch.from_numpy(keys), 40)
    want = np.zeros((40, 5))
    np.add.at(want, keys, x)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-12)
    assert (got.numpy()[37:] == 0).all()


def test_port_indexes_meet_the_reference_recall_bars():
    x = corpus()
    valid = np.ones(len(x), bool)
    idx = ivf.IvfIndex.build(x, valid, nlist=64, iters=10)
    live = torch.ones(len(x), dtype=torch.bool)
    recalls = []
    for q in queries(x, 20, seed=9):
        _v, ids = ivf.ivf_search(*idx.arrays(), torch.from_numpy(q), live,
                                 space="l2", k=10, nprobe=8)
        got = {int(i) for i in ids if i >= 0}
        recalls.append(len(got & exact_top10(x, q)) / 10)
    assert np.mean(recalls) >= 0.9, np.mean(recalls)
    x = corpus(n=1500, d=32)
    pq = ivf.IvfPqIndex.build(x, np.ones(len(x), bool), nlist=32, m=8)
    live = torch.ones(len(x), dtype=torch.bool)
    recalls = []
    for q in queries(x, 15, seed=11, scale=0.05):
        _v, ids = ivf.ivfpq_search_l2(*pq.arrays(), torch.from_numpy(q),
                                      live, k=10, nprobe=8)
        got = {int(i) for i in ids if i >= 0}
        recalls.append(len(got & exact_top10(x, q)) / 10)
    assert np.mean(recalls) >= 0.7, np.mean(recalls)


def test_two_trainings_are_byte_equal():
    x = corpus(n=800, d=16, seed=3)
    valid = np.ones(len(x), bool)
    valid[::7] = False
    for build in (lambda: ivf.IvfIndex.build(x, valid, nlist=20),
                  lambda: ivf.IvfPqIndex.build(x, valid, nlist=12, m=4)):
        a, b = build(), build()
        for name in a.__dataclass_fields__:
            va, vb = getattr(a, name), getattr(b, name)
            if isinstance(va, torch.Tensor):
                assert va.dtype == vb.dtype and va.shape == vb.shape, name
                assert va.numpy().tobytes() == vb.numpy().tobytes(), name
            else:
                assert va == vb, name


def tie_index():
    """Two clusters whose rows score alike: cluster 0 holds doc 7 at its
    first slot, cluster 1 doc 2; a query nearest cluster 0 probes it
    first, so doc 7 (flat index 0) comes before doc 2 (flat index c_pad)."""
    d, c_pad = 4, 8
    centroids = np.array([[1, 0, 0, 0], [0, 1, 0, 0]], np.float32)
    grouped = np.zeros((2, c_pad, d), np.float32)
    ids = np.full((2, c_pad), -1, np.int32)
    valid = np.zeros((2, c_pad), bool)
    row = np.array([0.5, 0.5, 0, 0], np.float32)
    grouped[0, 0], grouped[1, 0] = row, row
    ids[0, 0], ids[1, 0] = 7, 2
    grouped[1, 1] = [0, 2, 0, 0]
    ids[1, 1] = 3
    valid[0, 0] = valid[1, 0] = valid[1, 1] = True
    return centroids, grouped, ids, valid


@pytest.mark.parametrize("space", SPACES)
def test_ties_follow_the_flat_index_not_the_doc_id(space):
    arrays = tie_index()
    q = np.array([0.9, 0.1, 0, 0], np.float32)
    live = np.ones(8, bool)
    want = jivf.ivf_search(*(jnp.asarray(a) for a in arrays),
                           jnp.asarray(q), jnp.asarray(live), space=space,
                           k=3, nprobe=2)
    got = ivf.ivf_search(*ivf.ivf_index_from_arrays(*arrays).arrays(),
                         torch.from_numpy(q), torch.from_numpy(live),
                         space=space, k=3, nprobe=2)
    assert_close_hits(got, want)
    pair = [int(i) for i in got[1] if i in (7, 2)]
    assert pair == [7, 2]
    staged = ivf.stage_index(ivf.ivf_index_from_arrays(*arrays), "cpu")
    seg = ivf.IvfSegment(staged, torch.from_numpy(live), 2, 3)
    sv, si = ivf.ivf_search_segments([seg], torch.from_numpy(q)[None],
                                     space=space)
    assert torch.equal(si[0], got[1]) and torch.equal(sv[0], got[0])


def staged_segments(pq: bool):
    """Three segments with deletes: one JAX-free port index each (one of
    them with clusters of one row), as ``IvfSegment``s over several
    nprobe / k, k past the candidates included."""
    out = []
    for s, (n, nlist) in enumerate(((300, 12), (40, 30), (500, 16))):
        x = corpus(n=n, d=16, seed=20 + s, clusters=8)
        valid = np.ones(n, bool)
        valid[s::9] = False
        idx = (ivf.IvfPqIndex.build(x, valid, nlist, m=4) if pq
               else ivf.IvfIndex.build(x, valid, nlist))
        live = torch.from_numpy(live_mask(pq + n + 8, s))[: n + 8].clone()
        out.append((idx, live))
    return out


@pytest.mark.parametrize("pq", [False, True])
def test_kernel_layout_twins_equal_the_reference_signatures(pq):
    segs = staged_segments(pq)
    qs = torch.from_numpy(np.stack(queries(corpus(n=300, d=16, seed=20,
                                                  clusters=8), 3, seed=1)))
    for nprobe_of, k in ((lambda nl: 1, 1), (lambda nl: max(1, nl // 8), 10),
                         (lambda nl: nl, 300), (lambda nl: 2, 10_000)):
        items = []
        for idx, live in segs:
            nprobe = nprobe_of(idx.nlist)
            items.append(ivf.IvfSegment(ivf.stage_index(idx, "cpu"), live,
                                        nprobe,
                                        min(k, nprobe * idx.c_pad)))
        offs = ivf.k_offsets(items)
        spaces = ("l2",) if pq else SPACES
        for space in spaces:
            vals, ids = (ivf.ivfpq_search_segments(items, qs) if pq else
                         ivf.ivf_search_segments(items, qs, space=space))
            auto = (ivf.ivfpq_search_segments_auto(items, qs) if pq else
                    ivf.ivf_search_segments_auto(items, qs, space=space))
            assert torch.equal(auto[1], ids)
            assert auto[0].numpy().tobytes() == vals.numpy().tobytes()
            for (idx, live), item, a, b in zip(segs, items, offs[:-1],
                                               offs[1:]):
                for qi in range(qs.shape[0]):
                    want = (ivf.ivfpq_search_l2(
                        *idx.arrays(), qs[qi], live, k=item.k,
                        nprobe=item.nprobe) if pq else ivf.ivf_search(
                        *idx.arrays(), qs[qi], live, space=space, k=item.k,
                        nprobe=item.nprobe))
                    assert torch.equal(ids[qi, a:b], want[1])
                    assert vals[qi, a:b].numpy().tobytes() == \
                        want[0].numpy().tobytes()


def test_stage_index_keeps_only_the_valid_rows_in_cluster_order():
    x = corpus(n=200, d=8, seed=2, clusters=5)
    idx = ivf.IvfIndex.build(x, np.ones(200, bool), nlist=6)
    st = ivf.stage_index(idx, "cpu")
    counts = idx.grouped_valid.sum(1).numpy()
    assert st.rows.shape == (200, 8) and st.ids.shape == (200,)
    np.testing.assert_array_equal(np.diff(st.starts.numpy()), counts)
    assert st.c_pad == idx.c_pad
    for c in range(idx.nlist):
        lo, hi = st.starts_host[c], st.starts_host[c + 1]
        assert torch.equal(st.rows[lo:hi], idx.grouped[c, : hi - lo])
        assert torch.equal(st.ids[lo:hi], idx.grouped_ids[c, : hi - lo])
    assert st.nbytes() < idx.grouped.numel() * 4 + 4 * 200 + 4 * 7 + 6 * 32


def test_launch_table_layout():
    x = corpus(n=100, d=8, seed=1, clusters=4)
    items = [ivf.IvfSegment(ivf.stage_index(ivf.IvfIndex.build(
        x, np.ones(100, bool), nlist), "cpu"), torch.ones(128, dtype=bool),
        nprobe, k) for nlist, nprobe, k in ((4, 2, 5), (8, 8, 3))]
    table, p_tot, f_tot = cuda_ivf.launch_table(items, 3, [0, 5], True)
    w = cuda_ivf.SEG_WORDS
    assert p_tot == 10 and table.shape == (2 * w + 3,)
    e0, e1 = table[:w], table[w: 2 * w]
    assert e0[cuda_ivf.W_CENTROIDS] == items[0].index.centroids.data_ptr()
    assert e1[cuda_ivf.W_ROWS] == items[1].index.rows.data_ptr()
    assert e1[cuda_ivf.W_LIVE] == items[1].live.data_ptr()
    assert (e0[cuda_ivf.W_NLIST], e0[cuda_ivf.W_NPROBE], e0[cuda_ivf.W_K]) \
        == (4, 2, 5)
    assert (e1[cuda_ivf.W_PROBE_OFF], e1[cuda_ivf.W_OUT_COL]) == (2, 5)
    assert e1[cuda_ivf.W_FLAT_OFF] == 2 * items[0].index.c_pad
    assert f_tot == 2 * items[0].index.c_pad + 8 * items[1].index.c_pad
    assert e0[cuda_ivf.W_CODEBOOKS] == 0 and e0[cuda_ivf.W_M] == 0
    assert (table[2 * w:] == 0).all()      # the counters start at zero
    assert cuda_ivf.k_padded(5) == 8 and cuda_ivf.k_padded(256) == 256


def test_cuda_wrappers_refuse_cpu_tensors():
    x = corpus(n=100, d=8, seed=1, clusters=4)
    seg = ivf.IvfSegment(ivf.stage_index(ivf.IvfIndex.build(
        x, np.ones(100, bool), 4), "cpu"), torch.ones(128, dtype=bool), 2, 5)
    q = torch.zeros((1, 8))
    with pytest.raises(ValueError, match="CUDA"):
        cuda_ivf.ivf_search_segments_cuda([seg], q, space="l2")
    pq = ivf.IvfSegment(ivf.stage_index(ivf.IvfPqIndex.build(
        x, np.ones(100, bool), 4, m=2), "cpu"), seg.live, 2, 5)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_ivf.ivfpq_search_segments_cuda([pq], q)
    assert cuda_ivf.ivf_search_segments_cuda.launches == 0
    assert cuda_ivf.ivfpq_search_segments_cuda.launches == 0
