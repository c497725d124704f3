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
- On layouts laid out by hand (``testing/ann.py`` ``SKEWED``: a cluster
  of c_pad rows over several scan chunks, one holding most of a segment,
  clusters of one row and of none, nlist 1, 3 and 2,000, tied rows
  straddling every multiple of 64; two of them at d = 768, IVF-PQ at m
  = 8 and 128), the kernels' plain twins equal the JAX
  package's ``ivf_search`` / ``ivfpq_search_l2``; ``stage_index``
  records the largest cluster's rows and leaves the slack the scan's
  16-byte copies need.
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
from opensearch_tpu_torch.testing import ann

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
    chunk = 16
    table, p_tot, b_tot, f_tot = cuda_ivf.launch_table(items, 3, [0, 5],
                                                       True, chunk)
    w = cuda_ivf.SEG_WORDS
    # two segments' entries, then a pair of int32 counters per (query,
    # segment): 3 x 2 int64 words
    assert p_tot == 10 and table.shape == (2 * w + 6,)
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
    # scan blocks: each probe's chunks come from the segment's largest
    # cluster, and a segment's blocks follow the one before it
    chunks = [-(-it.index.max_rows // chunk) for it in items]
    assert (e0[cuda_ivf.W_CHUNKS], e1[cuda_ivf.W_CHUNKS]) == tuple(chunks)
    assert chunks == [cuda_ivf.chunks_per_probe(it.index, chunk)
                      for it in items]
    assert (e0[cuda_ivf.W_BLOCK_OFF], e1[cuda_ivf.W_BLOCK_OFF]) == \
        (0, 2 * chunks[0])
    assert b_tot == 2 * chunks[0] + 8 * chunks[1]
    assert (table[2 * w:] == 0).all()      # the counters start at zero
    assert cuda_ivf.k_padded(5) == 8 and cuda_ivf.k_padded(256) == 256
    # a chunk as large as the largest cluster: one block per probe
    _t, _p, b_one, _f = cuda_ivf.launch_table(items, 1, [0, 5], False,
                                              cuda_ivf.CHUNK_MAX)
    assert b_one == p_tot


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


def skewed_queries(a, n_random, seed):
    """A query on a duplicated row of the largest cluster (its tied
    copies straddle a chunk boundary), one on each of the first 8
    centroids, and ``n_random`` near random rows."""
    rng = np.random.default_rng(seed)
    valid = a["grouped_valid"]
    big = int(np.argmax(valid.sum(1)))
    d = a["centroids"].shape[1]
    rows = (a["grouped"] if "grouped" in a else None)
    out = [c + rng.normal(size=d).astype(np.float32) * 0.1
           for c in a["centroids"][:8]]
    if rows is not None:
        size = int(valid[big].sum())
        if size > ann.TIE_STRIDE + 2:
            out.append(rows[big, ann.TIE_STRIDE - 2].copy())
        flat = rows[valid]
        out += [flat[i] + rng.normal(size=d).astype(np.float32) * 0.05
                for i in rng.integers(0, len(flat), n_random)]
    else:
        out += [rng.normal(size=d).astype(np.float32) * 3
                for _ in range(n_random)]
    return [q.astype(np.float32) for q in out]


@pytest.mark.parametrize("pq", [False, True])
@pytest.mark.parametrize("layout", sorted(ann.SKEWED))
def test_twins_equal_jax_on_skewed_layouts(layout, pq):
    twins_equal_jax(ann.SKEWED[layout], 16, 4 if pq else 0)


@pytest.mark.parametrize("layout", ["full_cluster", "nlist_3"])
@pytest.mark.parametrize("m", [0, *ann.WIDE_MS])
def test_twins_equal_jax_at_wide_rows(layout, m):
    """``ann.WIDE_D`` = 768: rows wider than one pass of K6's stages, K7
    at m = 8 (a codebook subspace of 96 floats) and at m = M_MAX."""
    assert max(ann.WIDE_MS) == cuda_ivf.M_MAX
    twins_equal_jax(ann.SKEWED[layout], ann.WIDE_D, m, n_random=1)


def twins_equal_jax(sizes, d, m, n_random=3):
    """The plain twin (IVF-PQ when ``m``) against the JAX package's
    search on ``skewed_arrays(sizes, d, m)``, nprobe 1, nlist // 2 and
    nlist, k = 10, every space."""
    pq = m > 0
    a = ann.skewed_arrays(sizes, d, m, seed=3)
    idx = ann.skewed_index(sizes, d, m, seed=3)
    staged = ivf.stage_index(idx, "cpu")
    n = sum(sizes)
    live = live_mask(n, 7)
    nlist = len(sizes)
    for q in skewed_queries(a, n_random, seed=len(sizes)):
        qt = torch.from_numpy(q)
        for nprobe in sorted({1, max(1, nlist // 2), nlist}):
            seg = ivf.IvfSegment(staged, torch.from_numpy(live), nprobe, 10)
            spaces = ("l2",) if pq else SPACES
            for space in spaces:
                if pq:
                    got = ivf.ivfpq_search_segments([seg], qt[None])
                    want = jivf.ivfpq_search_l2(
                        *(jnp.asarray(a[f]) for f in (
                            "centroids", "codebooks", "grouped_codes",
                            "grouped_ids", "grouped_valid")),
                        jnp.asarray(q), jnp.asarray(live), k=10,
                        nprobe=nprobe)
                    slack = 0.0
                else:
                    got = ivf.ivf_search_segments([seg], qt[None],
                                                  space=space)
                    want = jivf.ivf_search(
                        *(jnp.asarray(a[f]) for f in (
                            "centroids", "grouped", "grouped_ids",
                            "grouped_valid")),
                        jnp.asarray(q), jnp.asarray(live), space=space,
                        k=10, nprobe=nprobe)
                    x = np.zeros((n, d), np.float32)
                    x[a["grouped_ids"][a["grouped_valid"]]] = \
                        a["grouped"][a["grouped_valid"]]
                    slack = (reference_l2_slack(x, np.asarray(want[1]), q,
                                                np.asarray(want[0]))
                             if space == "l2" else 0.0)
                assert_close_hits((got[0][0], got[1][0]), want, slack)


@pytest.mark.parametrize("layout", sorted(ann.SKEWED) + ["trained"])
def test_staged_index_records_its_largest_cluster_and_slack(layout):
    if layout == "trained":
        x = corpus(n=600, d=12, seed=9, clusters=6)
        valid = np.ones(600, bool)
        valid[::11] = False
        indexes = [ivf.IvfIndex.build(x, valid, nlist=9),
                   ivf.IvfPqIndex.build(x, valid, nlist=9, m=3)]
    else:
        indexes = [ann.skewed_index(ann.SKEWED[layout], 12, m, seed=2)
                   for m in (0, 3)]
    for idx in indexes:
        st = ivf.stage_index(idx, "cpu")
        counts = idx.grouped_valid.sum(1).numpy()
        assert st.max_rows == int(counts.max())
        assert st.max_rows == int(np.diff(st.starts_host).max())
        if layout != "trained":
            assert st.max_rows == max(ann.SKEWED[layout])
        for t in (st.ids, st.codes if st.pq else st.rows):
            storage = t.untyped_storage()
            end = t.data_ptr() + t.numel() * t.element_size()
            assert storage.data_ptr() + storage.nbytes() >= end + 16
            assert t.is_contiguous()


def probe_by_slices(cd_keys, nprobe, blocks):
    """A numpy model of ``csrc/ivf.cu``'s probe: ``blocks`` slices of
    ceil(nlist / blocks) keys, each ranked within its slice; a key among
    its slice's first ``nprobe`` finds its rank in the segment by adding
    each other slice's count of larger keys (binary lifting over the
    sorted list); the first ``nprobe`` are written by rank."""
    nlist = len(cd_keys)
    per = -(-nlist // blocks)
    slices = [sorted(cd_keys[min(nlist, b * per): min(nlist, (b + 1) * per)],
                     reverse=True) for b in range(blocks)]
    top = 1
    while top < per:
        top <<= 1
    out = [None] * nprobe
    for me, mine in enumerate(slices):
        for i, k in enumerate(mine[:nprobe]):
            r = i
            for b, other in enumerate(slices):
                if b == me:
                    continue
                above, step = 0, top
                while step:
                    if above + step <= len(other) and \
                            other[above + step - 1] > k:
                        above += step
                    step >>= 1
                r += above
            if r < nprobe:
                assert out[r] is None
                out[r] = k
    return out


@pytest.mark.parametrize("nlist,blocks,nprobe", [
    (1, 8, 1), (3, 8, 3), (3, 8, 1), (271, 8, 33), (271, 8, 271),
    (271, 1, 33), (272, 4, 8), (9, 2, 9), (1000, 8, 125)])
def test_probe_slices_rank_as_one_sort(nlist, blocks, nprobe):
    rng = np.random.default_rng(nlist + blocks)
    # keys as the kernel builds them: (orderable(-cd) << 32) | ~c, with
    # repeated distances so ties fall to the lower centroid
    cd = rng.integers(0, max(2, nlist // 3), size=nlist)
    keys = [int((1 << 31) - v) << 32 | (0xFFFFFFFF - c)
            for c, v in enumerate(cd)]
    got = [0xFFFFFFFF - (k & 0xFFFFFFFF)
           for k in probe_by_slices(keys, nprobe, blocks)]
    want = np.lexsort((np.arange(nlist), cd))[:nprobe]
    assert got == list(want)


@pytest.mark.parametrize("layout", sorted(ann.SKEWED))
@pytest.mark.parametrize("chunk", [64, 256, 1024])
def test_scan_blocks_cover_every_probed_row_once(layout, chunk):
    """A model of the scan's grid: block j of a query finds its segment
    by the launch table's ``W_BLOCK_OFF`` words, its probe rank and chunk
    by ``W_CHUNKS``; together the blocks cover each probed cluster's rows
    exactly once, the blocks past a cluster's rows take none."""
    items = [ivf.IvfSegment(ivf.stage_index(ann.skewed_index(
        ann.SKEWED[name], 4, seed=1), "cpu"), torch.ones(4096, dtype=bool),
        len(ann.SKEWED[name]), 10) for name in (layout, "nlist_3")]
    table, p_tot, b_tot, _f = cuda_ivf.launch_table(items, 1, [0, 10],
                                                    False, chunk)
    w = cuda_ivf.SEG_WORDS
    entries = table[: len(items) * w].reshape(len(items), w)
    seen = {}
    for j in range(b_tot):
        seg = int(np.searchsorted(entries[:, cuda_ivf.W_BLOCK_OFF], j,
                                  side="right")) - 1
        e = entries[seg]
        local = j - e[cuda_ivf.W_BLOCK_OFF]
        rank, ch = divmod(local, e[cuda_ivf.W_CHUNKS])
        starts = items[seg].index.starts_host
        c = rank            # nprobe = nlist: any probe order covers them
        lo = starts[c] + ch * chunk
        rows = min(chunk, starts[c + 1] - starts[c] - ch * chunk)
        for r in range(max(0, rows)):
            key = (seg, lo + r)
            assert key not in seen
            seen[key] = j
    assert len(seen) == sum(int(it.index.starts_host[-1]) for it in items)
    assert p_tot == sum(it.nprobe for it in items)


def test_wrapper_caches_keep_the_launch_table_and_the_checks():
    """The wrapper keeps each staged index's static table words and its
    checks on the (frozen) index: a second table is the same bytes as
    the first, the words equal those of the index's arrays, and a staged
    array without the copies' slack is refused."""
    import dataclasses

    x = corpus(n=300, d=8, seed=4, clusters=5)
    items = [ivf.IvfSegment(ivf.stage_index(ivf.IvfIndex.build(
        x, np.ones(300, bool), nlist), "cpu"), torch.ones(512, dtype=bool),
        nprobe, 7) for nlist, nprobe in ((6, 3), (9, 9))]
    first = cuda_ivf.launch_table(items, 2, [0, 7], False, 32)
    again = cuda_ivf.launch_table(items, 2, [0, 7], False, 32)
    assert first[0].tobytes() == again[0].tobytes() and first[1:] == again[1:]
    w = cuda_ivf.SEG_WORDS
    for s, it in enumerate(items):
        e = first[0][s * w: (s + 1) * w]
        assert e[cuda_ivf.W_ROWS] == it.index.rows.data_ptr()
        assert e[cuda_ivf.W_IDS] == it.index.ids.data_ptr()
        assert e[cuda_ivf.W_STARTS] == it.index.starts.data_ptr()
        assert e[cuda_ivf.W_CHUNKS] == cuda_ivf.chunks_per_probe(it.index, 32)
    other = cuda_ivf.launch_table(items, 2, [0, 7], False, 16)[0]
    assert other[cuda_ivf.W_CHUNKS] == cuda_ivf.chunks_per_probe(
        items[0].index, 16)
    cpu = torch.device("cpu")
    st = items[0].index
    cuda_ivf._check_index(st, 0, cpu, 8, False, "k")
    assert st.__dict__["_checked"] == (cpu, 8, False)
    bare = dataclasses.replace(st, rows=st.rows.clone())   # no slack
    with pytest.raises(ValueError, match="slack"):
        cuda_ivf._check_index(bare, 0, cpu, 8, False, "k")
    with pytest.raises(TypeError):
        cuda_ivf._check_index(st, 0, cpu, 8, True, "k")
