"""Aggregation ops of the PyTorch port (``ops/aggs.py``) against the JAX
package's ``ops/aggs.py``, on the CPU, and K5's chosen summation order
against a numpy model of the kernel.

Inputs are seeded multi-valued columns laid out as a segment stages them
(values sorted per doc, pads with value 0 and doc ``n_docs``, ordinal
pads -1, the dead doc never matched): docs with 0 to 3 values,
duplicates of one value and values in one bucket, values outside the
edges, long and double columns.

Tolerances: counts, min and max are exact; per-doc sums are exact (both
add a doc's values in column order from 0.0).  Bucket sums and
``masked_metrics``' sum are the pairwise tree over each bucket's entries
(ops/aggs.py, so K5 can equal its plain version on the card), where the
reference adds sequentially (its CPU scatter) or in XLA's reduction
order: exact on long columns whose partial sums stay below 2^53 (every
order is exact there), within rtol 1e-12 on double columns (two orders
of n doubles differ by at most ~n ulps; n <= 2,000 here).  The plain
version equals the numpy model of K5's streaming order byte for byte.
"""

import numpy as np
import pytest
import torch

import opensearch_tpu.common.jaxenv  # noqa: F401
import jax.numpy as jnp
from opensearch_tpu.ops import aggs as jaggs
from opensearch_tpu_torch.index.segment import pad_pow2
from opensearch_tpu_torch.ops import aggs as taggs
from opensearch_tpu_torch.ops import cuda_aggs

RTOL = 1e-12


def column(seed: int, n_docs: int, kind: str):
    """A multi-valued column of ``n_docs`` docs (0-3 values, sorted per
    doc, duplicates), padded as ``DeviceSegment`` pads it, and a matched
    mask [n_pad] (the dead slots False)."""
    rng = np.random.default_rng(seed)
    per = rng.integers(0, 4, size=n_docs)
    docs = np.repeat(np.arange(n_docs, dtype=np.int32), per)
    if kind == "long":
        vals = rng.integers(-40, 400, size=len(docs)).astype(np.int64)
    elif kind == "double":
        vals = np.round(rng.lognormal(2.3, 0.9, size=len(docs)), 2)
        vals[rng.random(len(docs)) < 0.1] *= -1
    else:                              # ordinals: distinct per doc
        vals = rng.integers(0, 9, size=len(docs)).astype(np.int32)
    dup = rng.random(len(docs)) < 0.2             # repeat the previous
    same = np.r_[False, docs[1:] == docs[:-1]] & dup
    vals[same] = vals[np.nonzero(same)[0] - 1]
    order = np.lexsort((vals, docs))
    vals, docs = vals[order], docs[order]
    if kind == "ordinal":
        keep = np.r_[True, (docs[1:] != docs[:-1]) | (vals[1:] != vals[:-1])]
        vals, docs = vals[keep], docs[keep]
    offsets = np.searchsorted(docs, np.arange(n_docs + 1)).astype(np.int32)
    n_pad = pad_pow2(n_docs + 1)
    v_pad = pad_pow2(len(vals))
    pv = np.full(v_pad, -1 if kind == "ordinal" else 0, vals.dtype)
    pv[: len(vals)] = vals
    pd = np.full(v_pad, n_docs, np.int32)
    pd[: len(docs)] = docs
    po = np.full(n_pad + 1, offsets[-1], np.int32)
    po[: n_docs + 1] = offsets
    matched = np.zeros(n_pad, bool)
    matched[:n_docs] = rng.random(n_docs) < 0.7
    return {"values": pv, "value_docs": pd, "offsets": po,
            "matched": matched, "n_pad": n_pad}


def edges_for(seed: int, kind: str) -> np.ndarray:
    """Ascending edges that leave values below the first and at or
    above the last edge out."""
    lo, step = (-10.0, 37.0) if kind == "long" else (-5.0, 4.5)
    return lo + step * np.arange(8 + seed % 3, dtype=np.float64)


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def j(a):
    return jnp.asarray(a)


def assert_exact(got, ref, what=""):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.dtype == ref.dtype, (what, got.dtype, ref.dtype)
    np.testing.assert_array_equal(got, ref, err_msg=what)


def assert_sums(got, ref, kind, what=""):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.dtype == ref.dtype == np.float64, what
    if kind == "long":
        np.testing.assert_array_equal(got, ref, err_msg=what)
    else:
        np.testing.assert_allclose(got, ref, rtol=RTOL, atol=0,
                                   err_msg=what)


SEEDS = [1, 2, 3]
KINDS = ["long", "double"]


@pytest.mark.parametrize("seed", SEEDS)
def test_ordinal_counts_equal_the_reference(seed):
    c = column(seed, 300, "ordinal")
    nbp = pad_pow2(9 + 1)
    got = taggs.ordinal_counts(t(c["values"]), t(c["value_docs"]),
                               t(c["matched"]), n_buckets_pad=nbp)
    ref = jaggs.ordinal_counts(j(c["values"]), j(c["value_docs"]),
                               j(c["matched"]), n_buckets_pad=nbp)
    assert_exact(got.numpy(), ref)
    assert int(got[-1]) == 0                  # the dead bucket


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("seed", SEEDS)
def test_bucketed_counts_and_first_occurrence(seed, kind):
    c = column(seed, 400, kind)
    edges = edges_for(seed, kind)
    nbp = pad_pow2(len(edges))
    got = taggs.bucketed_counts(t(c["values"]), t(c["value_docs"]),
                                t(c["matched"]), t(edges), n_buckets_pad=nbp)
    ref = jaggs.bucketed_counts(j(c["values"]), j(c["value_docs"]),
                                j(c["matched"]), j(edges), n_buckets_pad=nbp)
    assert_exact(got.numpy(), ref)
    b = taggs.edge_buckets(t(c["values"]), t(edges))
    jb = jnp.searchsorted(j(edges), j(c["values"]),
                          side="right").astype(jnp.int32) - 1
    assert_exact(b.numpy(), jb)
    assert_exact(taggs._first_occurrence(t(c["value_docs"]), b).numpy(),
                 jaggs._first_occurrence(j(c["value_docs"]), jb))
    # values outside the edges exist and are dropped
    ok = c["matched"][c["value_docs"]]
    assert ((b.numpy() < 0) & ok).any() or \
        ((b.numpy() >= len(edges) - 1) & ok).any()


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("seed", SEEDS)
def test_masked_metrics(seed, kind):
    c = column(seed, 500, kind)
    got = taggs.masked_metrics(t(c["values"]), t(c["value_docs"]),
                               t(c["matched"]))
    ref = jaggs.masked_metrics(j(c["values"]), j(c["value_docs"]),
                               j(c["matched"]))
    assert_sums(got[0].numpy(), ref[0], kind, "sum")
    for g, r, what in zip(got[1:], ref[1:], ("count", "min", "max")):
        assert_exact(g.numpy(), r, what)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("seed", SEEDS)
def test_per_doc_partials_exact(seed, kind):
    c = column(seed, 300, kind)
    got = taggs.per_doc_partials(t(c["values"]), t(c["value_docs"]),
                                 t(c["matched"]), n_pad=c["n_pad"])
    ref = jaggs.per_doc_partials(j(c["values"]), j(c["value_docs"]),
                                 j(c["matched"]), n_pad=c["n_pad"])
    for g, r, what in zip(got, ref, ("sum", "count", "min", "max")):
        assert_exact(g.numpy(), r, what)


@pytest.mark.parametrize("mode", ["ordinal", "edges"])
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("seed", SEEDS)
def test_scatter_partials_to_buckets(seed, kind, mode):
    key = column(seed, 600, "ordinal" if mode == "ordinal" else kind)
    sub = column(seed + 100, 600, kind)
    matched = key["matched"]
    if mode == "ordinal":
        b = key["values"]
        nbp = pad_pow2(9 + 1)
        ok = matched[key["value_docs"]] & (b >= 0)
    else:
        edges = edges_for(seed, kind)
        nbp = pad_pow2(len(edges))
        b = taggs.edge_buckets(t(key["values"]), t(edges)).numpy()
        ok = (matched[key["value_docs"]] & (b >= 0) & (b < len(edges) - 1)
              & taggs._first_occurrence(t(key["value_docs"]),
                                        t(b)).numpy())
    n_pad = key["n_pad"]
    tpd = taggs.per_doc_partials(t(sub["values"]), t(sub["value_docs"]),
                                 t(matched), n_pad=n_pad)
    jpd = jaggs.per_doc_partials(j(sub["values"]), j(sub["value_docs"]),
                                 j(matched), n_pad=n_pad)
    got = taggs.scatter_partials_to_buckets(
        t(key["value_docs"]), t(b), t(ok), tpd, n_buckets_pad=nbp)
    ref = jaggs.scatter_partials_to_buckets(
        j(key["value_docs"]), j(b), j(ok), jpd, n_buckets_pad=nbp)
    assert_sums(got[0].numpy(), ref[0], kind, "sum")
    for g, r, what in zip(got[1:], ref[1:], ("count", "min", "max")):
        assert_exact(g.numpy(), r, what)


@pytest.mark.parametrize("seed", SEEDS)
def test_masked_centroids(seed):
    c = column(seed, 3000, "double")
    got = taggs.masked_centroids(t(c["values"]), t(c["value_docs"]),
                                 t(c["matched"]), n_cent=64)
    ref = jaggs.masked_centroids(j(c["values"]), j(c["value_docs"]),
                                 j(c["matched"]), n_cent=64)
    assert_exact(got[1].numpy(), ref[1], "weights")
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]),
                               rtol=RTOL, atol=0)


def test_long_sums_are_exact_in_any_order():
    """Integers below 2^53 sum exactly in any order: the pairwise tree
    equals the reference's sequential sum bit for bit on a long column
    of large values."""
    rng = np.random.default_rng(9)
    vals = rng.integers(-2 ** 40, 2 ** 40, size=4000).astype(np.int64)
    seg = rng.integers(0, 5, size=4000)
    got = taggs.pairwise_sums(t(vals), t(seg), 5).numpy()
    ref = np.zeros(5)
    np.add.at(ref, seg, vals.astype(np.float64))
    assert_exact(got, ref)


# -- K5: the plain version against a numpy model of the kernel's order ---

def _raw_buckets(mode, keys, edges):
    if mode == "ordinal":
        return keys.astype(np.int64)
    if mode == "edges":
        return np.searchsorted(edges, keys.astype(np.float64),
                               side="right") - 1
    return np.where((keys < 0) if keys.dtype == np.int32 else
                    np.zeros(len(keys), bool), -1, 0)


def _node_level(p, end):
    cap = (end - p).bit_length() - 1
    return cap if p == 0 else min((p & -p).bit_length() - 1, cap)


def k5_model(segments, mode, edges=None, self_metric=False, chunk=4096):
    """numpy model of ``csrc/aggs.cu``'s decomposition, per job: entries
    cut into chunks of ``chunk``; an entry's validity from entries e - 1
    and e alone; per chunk a stable sort by bucket (invalid entries to
    the dead bucket, last) and one record per bucket (count, start);
    each record's starting rank r0 an exclusive scan over the chunks in
    order; per chunk the tree's complete nodes inside [r0, r0 + n),
    aligned to the global ranks, level by level, and each record's
    maximal nodes in rank order; per bucket those nodes pushed into a
    binary counter in chunk order, the tail folded from the lowest level
    up.  ``self_metric``: a bool or a flag per segment.  Returns the flat
    int64 output."""
    flags = list(self_metric) if isinstance(self_metric, (list, tuple)) \
        else [self_metric] * len(segments)
    out = []
    for seg, flag in zip(segments, flags):
        keys, kdocs, matched = seg["keys"], seg["key_docs"], seg["matched"]
        nb = seg["n_buckets"]
        nbp = pad_pow2(nb + 1)
        n = len(keys)
        n_subs = 1 if flag else len(seg["subs"])
        b = _raw_buckets(mode, keys, edges)
        valid = (b >= 0) & (b < nb) & matched[kdocs]
        if mode == "edges":
            valid &= np.r_[True, (kdocs[1:] != kdocs[:-1]) | (b[1:] != b[:-1])]

        def partial(e, jj):
            if flag:
                v = float(keys[e])
                return v, 1, v, v
            col = seg["subs"][jj]
            s, mn, mx = 0.0, np.inf, -np.inf
            if col is None:
                return s, 0, mn, mx
            lo, hi = col["offsets"][kdocs[e]], col["offsets"][kdocs[e] + 1]
            for k in range(lo, hi):
                v = float(col["values"][k])
                s = s + v
                mn, mx = min(mn, v), max(mx, v)
            return s, int(hi - lo), mn, mx

        # count: per chunk, the stable sort and the records
        chunks = []
        for e0 in range(0, n, chunk):
            key = np.where(valid[e0: e0 + chunk], b[e0: e0 + chunk], nbp - 1)
            perm = np.argsort(key, kind="stable")
            sk = key[perm]
            n_valid = int((sk != nbp - 1).sum())
            starts = [q for q in range(n_valid)
                      if q == 0 or sk[q] != sk[q - 1]]
            recs = {int(sk[q]): (q, (starts[i + 1] if i + 1 < len(starts)
                                     else n_valid) - q)
                    for i, q in enumerate(starts)}
            chunks.append((e0, perm[:n_valid], recs))
        # scan: each record's r0, the chunks in order
        counts = np.zeros(nbp, np.int64)
        r0 = []
        for _e0, _perm, recs in chunks:
            r0.append({bk: int(counts[bk]) for bk in recs})
            for bk, (_loc, cnt) in recs.items():
                counts[bk] += cnt
        parts = [counts]
        if n_subs == 0:
            out.append(counts)
            continue
        # reduce: per chunk and sub-column, the aligned complete nodes,
        # then each record's maximal nodes
        nodes = [[{} for _ in chunks] for _ in range(n_subs)]
        for k, (e0, perm, recs) in enumerate(chunks):
            nv = len(perm)
            rank = np.zeros(nv, np.int64)
            rend = np.zeros(nv, np.int64)
            for bk, (loc, cnt) in recs.items():
                rank[loc: loc + cnt] = r0[k][bk] + np.arange(cnt)
                rend[loc: loc + cnt] = r0[k][bk] + cnt
            for jj in range(n_subs):
                p4 = [partial(e0 + int(li), jj) for li in perm]
                xs = np.array([p[0] for p in p4], np.float64)
                xc = np.array([p[1] for p in p4], np.int64)
                xmn = np.array([p[2] for p in p4], np.float64)
                xmx = np.array([p[3] for p in p4], np.float64)
                step = 1
                while step < nv:
                    q = np.nonzero((rank % (2 * step) == 0)
                                   & (rank + 2 * step <= rend))[0]
                    xs[q] = xs[q] + xs[q + step]
                    xc[q] = xc[q] + xc[q + step]
                    xmn[q] = np.minimum(xmn[q], xmn[q + step])
                    xmx[q] = np.maximum(xmx[q], xmx[q + step])
                    step *= 2
                for bk, (loc, cnt) in recs.items():
                    p, end, got = r0[k][bk], r0[k][bk] + cnt, []
                    c, mn, mx = 0, np.inf, -np.inf
                    while p < end:
                        lv = _node_level(p, end)
                        q = loc + p - r0[k][bk]
                        got.append((p, lv, float(xs[q])))
                        c += int(xc[q])
                        mn, mx = min(mn, xmn[q]), max(mx, xmx[q])
                        p += 1 << lv
                    nodes[jj][k][bk] = (got, c, mn, mx)
        # merge: per bucket, the chunks' nodes in chunk order
        for jj in range(n_subs):
            sums, cnt = np.zeros(nbp), np.zeros(nbp, np.int64)
            mns, mxs = np.full(nbp, np.inf), np.full(nbp, -np.inf)
            for bk in np.nonzero(counts)[0]:
                st = {}
                for k in range(len(chunks)):
                    if bk not in nodes[jj][k]:
                        continue
                    got, c, mn, mx = nodes[jj][k][bk]
                    for p, lv, v in got:
                        carry = v
                        while (p >> lv) & 1:
                            carry = st[lv] + carry
                            lv += 1
                        st[lv] = carry
                    cnt[bk] += c
                    mns[bk], mxs[bk] = min(mns[bk], mn), max(mxs[bk], mx)
                acc, have, r = 0.0, False, int(counts[bk])
                for lv in range(r.bit_length()):
                    if (r >> lv) & 1:
                        acc = st[lv] + acc if have else st[lv]
                        have = True
                sums[bk] = acc + 0.0
            parts += [sums.view(np.int64), cnt, mns.view(np.int64),
                      mxs.view(np.int64)]
        out.append(np.concatenate(parts))
    return np.concatenate(out)


def collect_case(seed, mode, n_subs, key_kind="long", sizes=(700, 300)):
    """Segments of one collector call: a key column and ``n_subs``
    sub-columns (long, then double; the second segment lacks the last
    sub-column when there are two)."""
    segs = []
    for si, n_docs in enumerate(sizes):
        key = column(seed + si, n_docs,
                     "ordinal" if mode == "ordinal" else key_kind)
        subs = [column(seed + 50 + si + 7 * jj, n_docs,
                       ("long", "double")[jj]) for jj in range(n_subs)]
        if n_subs == 2 and si == 1:
            subs[1] = None
        segs.append({"keys": key["values"], "key_docs": key["value_docs"],
                     "matched": key["matched"],
                     "n_buckets": 9 if mode == "ordinal" else
                     (len(edges_for(seed, key_kind)) - 1
                      if mode == "edges" else 1),
                     "subs": subs})
    return segs


def as_collect(segs):
    return [taggs.CollectSegment(
        t(s["matched"]), t(s["keys"]), t(s["key_docs"]), s["n_buckets"],
        [None if c is None else {k: t(c[k]) for k in
                                 ("values", "value_docs", "offsets")}
         for c in s["subs"]]) for s in segs]


@pytest.mark.parametrize("n_subs", [0, 1, 2])
@pytest.mark.parametrize("mode", ["ordinal", "edges"])
def test_plain_collector_equals_the_model_of_k5(mode, n_subs):
    segs = collect_case(4, mode, n_subs)
    edges = edges_for(4, "long") if mode == "edges" else None
    got = taggs.bucket_collect_plain(as_collect(segs), mode=mode,
                                     edges=None if edges is None
                                     else t(edges)).numpy()
    assert_exact(got, k5_model(segs, mode, edges, chunk=64))


@pytest.mark.parametrize("key_kind", ["long", "double", "ordinal"])
def test_plain_collector_single_mode_equals_the_model(key_kind):
    segs = collect_case(6, "single", 0, key_kind=key_kind)
    if key_kind == "ordinal":
        for s in segs:
            s["keys"] = column(6, len(s["matched"]) - 1, "ordinal")[
                "values"][: len(s["keys"])]
    self_metric = key_kind != "ordinal"
    got = taggs.bucket_collect_plain(as_collect(segs), mode="single",
                                     self_metric=self_metric).numpy()
    assert_exact(got, k5_model(segs, "single", self_metric=self_metric,
                               chunk=64))


@pytest.mark.parametrize("kind", KINDS)
def test_plain_collector_equals_the_reference_composition(kind):
    """Counts, min and max of every mode equal the reference's functions
    exactly; sums within the stated tolerance (exact on long)."""
    segs = collect_case(8, "edges", 1, key_kind=kind)
    segs[0]["subs"][0] = column(58, 700, kind)
    edges = edges_for(8, kind)
    flat = taggs.bucket_collect_plain(as_collect(segs[:1]), mode="edges",
                                      edges=t(edges)).numpy()
    (counts, [(s, c, mn, mx)]), = taggs.unpack(flat, as_collect(segs[:1]),
                                               1)
    seg, sub = segs[0], segs[0]["subs"][0]
    nbp = pad_pow2(len(edges))
    jb = jnp.searchsorted(j(edges), j(seg["keys"]),
                          side="right").astype(jnp.int32) - 1
    ok = (j(seg["matched"])[j(seg["key_docs"])] & (jb >= 0)
          & (jb < len(edges) - 1)) & jaggs._first_occurrence(
              j(seg["key_docs"]), jb)
    assert_exact(counts, jaggs.bucketed_counts(
        j(seg["keys"]), j(seg["key_docs"]), j(seg["matched"]), j(edges),
        n_buckets_pad=nbp))
    ref = jaggs.scatter_partials_to_buckets(
        j(seg["key_docs"]), jb, ok, jaggs.per_doc_partials(
            j(sub["values"]), j(sub["value_docs"]), j(seg["matched"]),
            n_pad=len(seg["matched"])), n_buckets_pad=nbp)
    assert_sums(s, ref[0], kind)
    for g, r in zip((c, mn, mx), ref[1:]):
        assert_exact(g, r)


def test_collector_dead_and_empty_buckets():
    segs = collect_case(10, "ordinal", 1)
    flat = taggs.bucket_collect_plain(as_collect(segs), mode="ordinal")
    for counts, [(s, c, mn, mx)] in taggs.unpack(flat.numpy(),
                                                  as_collect(segs), 1):
        assert counts[-1] == 0 and c[-1] == 0 and s[-1] == 0.0
        assert mn[-1] == np.inf and mx[-1] == -np.inf
        assert counts.sum() > 0


def test_k5_wrapper_refuses_cpu_tensors():
    segs = as_collect(collect_case(3, "ordinal", 1))
    with pytest.raises(ValueError, match="CUDA"):
        cuda_aggs.bucket_collect_cuda(segs, mode="ordinal")
    assert cuda_aggs.bucket_collect_cuda.launches == 0


def test_k5_launch_layout():
    """The launch table's words, work lists and scratch plan as
    csrc/aggs.cu reads them: per job its chunks, its scan blocks and a
    merge block list per sub-column; dense rows only for jobs of at most
    a chunk of buckets; shared memory under the card's 227 KB."""
    C = cuda_aggs.CHUNK
    jobs = [((1, 2, 3, [(4, 5)]), (10_000, 20, 32, 0, 1, False, 1)),
            ((6, 7, 8, [(0, 0)]), (C, 100_000, 131_072, 160, 0, False, 1)),
            ((9, 10, 11, [(0, 0)]), (0, 1, 8, 999, 2, True, 1))]
    table, (n_chunk, n_scan, n_merge), scratch, words = \
        cuda_aggs.launch_table(jobs)
    assert words == cuda_aggs.HEAD_WORDS + 2
    head = table[:3 * words].reshape(3, words)
    assert head[0].tolist() == [1, 2, 3, 10_000, 20, 32, 0, 1 | 1 << 16,
                                0, 3, 0, 32, 0, 0, 0, 0, 4, 5]
    assert head[1].tolist() == [6, 7, 8, C, 100_000, 131_072, 160,
                                1 << 16, 3, 1, 96, C, -1, 3 * C, 96, 0,
                                0, 0]
    assert head[2, 7] == 2 | 1 << 8 | 1 << 16 and head[2, 9] == 0
    per_scan, per_merge = cuda_aggs.SCAN_BUCKETS, cuda_aggs.MERGE_BUCKETS
    assert n_chunk == 3 + 1
    assert n_scan == 32 // per_scan + 131_072 // per_scan + 1
    assert n_merge == 32 // per_merge + 131_072 // per_merge + 2
    assert len(table) == 3 * words + n_chunk + n_scan + n_merge
    work = table[3 * words:]
    assert (work[:n_chunk] >> 32).tolist() == [0, 0, 0, 1]
    assert (work[:n_chunk] & 0xffffffff).tolist() == [0, 1, 2, 0]
    scan = work[n_chunk: n_chunk + n_scan]
    assert (scan >> 32).tolist() == [0] * (32 // per_scan) + \
        [1] * (131_072 // per_scan) + [2]
    assert (scan[:32 // per_scan] & 0xffffffff).tolist() == \
        list(range(32 // per_scan))
    merge = work[n_chunk + n_scan:]
    assert (merge >> 40).tolist() == [0] * (32 // per_merge) + \
        [1] * (131_072 // per_merge) + [2] * 2
    assert ((merge >> 32) & 0xff).max() == 0
    assert scratch["rec_n"] == (4, 4) and scratch["dense_idx"] == (96, 4)
    assert scratch["rec_bucket"] == (96 + C, 4)
    assert scratch["perm"] == (4 * C, 2) and scratch["nodes"] == (4 * C, 8)
    offs, nbytes = cuda_aggs.scratch_offsets(scratch)
    assert all(o % 16 == 0 for o in offs.values()) and nbytes % 16 == 0
    assert nbytes >= sum(n * size for n, size in scratch.values())
    edges_smem, dense, stride = cuda_aggs.plan_launch([32, 131_072, 8], 367)
    assert edges_smem and dense == 32 and stride == C
    assert not cuda_aggs.plan_launch([8], 65_537)[0]
    smem = 227 * 1024 - 32 * 1024        # room for CUB's sort storage
    assert cuda_aggs.smem_bytes(0, cuda_aggs.EDGES_SMEM_MAX, C, C) <= smem
    assert cuda_aggs.smem_bytes(1, 0, 0, C) <= 227 * 1024
    assert cuda_aggs.kernels_launched(n_chunk, n_scan, n_merge) == 4
    assert cuda_aggs.kernels_launched(n_chunk, n_scan, 0) == 2
    assert cuda_aggs.defines() == {"AGG_CHUNK": C}
    flat_words = taggs.output_words(as_collect(collect_case(3, "ordinal",
                                                            2)), 2)
    assert flat_words == [0, 16 * 9, 16 * 9 * 2]
    assert taggs.output_words(as_collect(collect_case(3, "ordinal", 0)),
                              [1, 0]) == [0, 16 * 5, 16 * 5 + 16]


# -- K5's decomposition at its boundaries --------------------------------

def keyed(keys, matched, n_buckets, docs=None, subs=()):
    """A segment of one collector call from entry arrays: ``docs`` sorted
    (one entry a doc by default), padded to a power of two with doc
    ``n_docs`` and key -1 (ordinal) or 0, ``matched`` per doc."""
    keys = np.asarray(keys)
    n_docs = len(matched)
    docs = np.arange(len(keys), dtype=np.int32) if docs is None else \
        np.asarray(docs, np.int32)
    v_pad = pad_pow2(len(keys))
    pk = np.full(v_pad, -1 if keys.dtype == np.int32 else 0, keys.dtype)
    pk[: len(keys)] = keys
    pd = np.full(v_pad, n_docs, np.int32)
    pd[: len(docs)] = docs
    m = np.zeros(pad_pow2(n_docs + 1), bool)
    m[:n_docs] = matched
    return {"keys": pk, "key_docs": pd, "matched": m,
            "n_buckets": n_buckets, "subs": list(subs)}


def model_equals_plain(segs, mode, chunk, edges=None, self_metric=False):
    got = taggs.bucket_collect_plain(
        as_collect(segs), mode=mode, self_metric=self_metric,
        edges=None if edges is None else t(edges)).numpy()
    assert_exact(got, k5_model(segs, mode, edges, self_metric, chunk=chunk))
    return got


@pytest.mark.parametrize("skip", range(16))
def test_k5_run_starts_at_every_residue(skip):
    """The first ``skip`` docs unmatched, then every entry in bucket 0:
    with chunks of 16 each chunk's run starts at rank 16 k - ``skip``, so
    the starts fall at every residue mod 2, 4, 8 and 16."""
    n = 16 * 9 + 5
    matched = np.arange(n) >= skip
    sub = column(300 + skip, n, "double")
    segs = [keyed(np.zeros(n, np.int32), matched, 2, subs=[sub])]
    got = model_equals_plain(segs, "ordinal", 16)
    assert got[0] == n - skip


@pytest.mark.parametrize("offset", [0, 5])
@pytest.mark.parametrize("length", [7, 8, 9, 31, 32, 33, 255, 256, 257])
def test_k5_runs_across_chunks(length, offset):
    """A run of 2^k - 1, 2^k and 2^k + 1 entries of bucket 0 behind
    ``offset`` entries of bucket 1, in chunks of 16: within one chunk,
    across two and across many; a double and a long sub-column."""
    keys = np.r_[np.ones(offset), np.zeros(length), np.ones(3)].astype(
        np.int32)
    n = len(keys)
    subs = [column(400 + length, n, "double"), column(500 + offset, n,
                                                      "long")]
    segs = [keyed(keys, np.ones(n, bool), 2, subs=subs)]
    got = model_equals_plain(segs, "ordinal", 16)
    assert got[0] == length and got[1] == offset + 3


@pytest.mark.parametrize("mode", ["ordinal", "edges", "single"])
def test_k5_empty_chunks(mode):
    """Whole chunks of unmatched docs, and chunks that hold none of a
    bucket's entries, between chunks that do (chunks of 8)."""
    rng = np.random.default_rng(13)
    n = 120
    matched = np.ones(n, bool)
    matched[16:40] = False                     # chunks 2-4 empty
    if mode == "ordinal":
        keys = np.where(np.arange(n) < 64, 0, 1 + (np.arange(n) % 3))
        keys = keys.astype(np.int32)
        nb, edges = 4, None
    else:
        keys = rng.integers(0, 100, size=n).astype(np.int64)
        keys[48:72] = 500                      # outside the edges
        nb, edges = 4, np.array([0.0, 25.0, 50.0, 75.0, 100.0])
    if mode == "single":
        nb, edges = 1, None
    segs = [keyed(keys, matched, nb, subs=[column(600, n, "double")])]
    got = model_equals_plain(segs, mode, 8, edges=edges)
    assert 0 < got[:nb].sum() < n


@pytest.mark.parametrize("chunk", [8, 16])
def test_k5_edges_repeat_across_a_chunk_boundary(chunk):
    """A doc's two values in one bucket at entries chunk - 1 and chunk:
    the second is not counted, though it opens a chunk (entry e - 1 is
    read across the boundary)."""
    docs = np.r_[np.arange(chunk), chunk - 1, np.arange(chunk, chunk + 9)]
    docs = np.sort(docs).astype(np.int32)
    keys = (docs * 7 % 40).astype(np.float64)
    first = np.searchsorted(docs, chunk - 1)
    assert docs[first] == docs[first + 1] == chunk - 1 and first + 1 == chunk
    keys[first + 1] = keys[first] + 0.5       # same bucket, next entry
    n_docs = int(docs.max()) + 1
    edges = np.arange(0.0, 45.0, 5.0)
    sub = column(700, n_docs, "double")
    segs = [keyed(keys, np.ones(n_docs, bool), len(edges) - 1, docs=docs,
                  subs=[sub])]
    got = model_equals_plain(segs, "edges", chunk, edges=edges)
    assert got[: len(edges) - 1].sum() == n_docs


@pytest.mark.parametrize("n_subs", [0, 1])
def test_k5_hundred_thousand_ordinals(n_subs):
    """100,000 ordinals (n_buckets_pad 131,072, more than a chunk holds:
    the records are looked up by binary search, not a dense row), 1-3 a
    doc, in chunks of 4,096."""
    rng = np.random.default_rng(17)
    n_docs = 12_000
    per = rng.integers(1, 4, size=n_docs)
    docs = np.repeat(np.arange(n_docs, dtype=np.int32), per)
    keys = rng.integers(0, 100_000, size=len(docs)).astype(np.int32)
    order = np.lexsort((keys, docs))
    docs, keys = docs[order], keys[order]
    keep = np.r_[True, (docs[1:] != docs[:-1]) | (keys[1:] != keys[:-1])]
    docs, keys = docs[keep], keys[keep]
    subs = [column(800, n_docs, "double")][:n_subs]
    segs = [keyed(keys, rng.random(n_docs) < 0.8, 100_000, docs=docs,
                  subs=subs)]
    assert cuda_aggs.plan_launch([pad_pow2(100_001)], 0)[1] == 0
    got = model_equals_plain(segs, "ordinal", 4096)
    assert got[:100_000].sum() > 0


@pytest.mark.parametrize("chunk", [64, 4096])
def test_k5_batched_single_mode(chunk):
    """Several key columns in one single-mode call, a flag per segment:
    a long and a double column over two segments, the long column again
    (a field asked twice), a keyword's int32 ordinals counted without a
    metric; the dispatcher's output equals each column's own plain call
    and the model, and unpacks per segment."""
    segs, flags = [], []
    for kind, flag in (("long", True), ("double", True), ("long", True),
                       ("ordinal", False)):
        for si, n_docs in enumerate((500, 200)):
            c = column(900 + si, n_docs, kind)
            segs.append({"keys": c["values"], "key_docs": c["value_docs"],
                         "matched": c["matched"], "n_buckets": 1,
                         "subs": []})
            flags.append(flag)
    got = taggs.bucket_collect(as_collect(segs), mode="single",
                               self_metric=flags).numpy()
    want = np.concatenate([taggs.bucket_collect_plain(
        as_collect([sg]), mode="single", self_metric=f).numpy()
        for sg, f in zip(segs, flags)])
    assert_exact(got, want)
    assert_exact(got, k5_model(segs, "single", self_metric=flags,
                               chunk=chunk))
    parts = taggs.unpack(got, as_collect(segs), [int(f) for f in flags])
    assert [len(subs) for _c, subs in parts] == [1] * 6 + [0] * 2
    assert_exact(parts[0][1][0][0], parts[4][1][0][0])     # asked twice
    assert parts[6][0][0] > 0


def test_k5_replaced_kernel_is_built_only_into_the_sweep():
    """The kernel K5 replaced stays only as ``testing/k5_sweep.py``'s
    yardstick: ``csrc/aggs.cu`` includes it under ``AGG_OLD_ROUTE``, no
    other port file names it, and the wrapper's macros leave it out."""
    from pathlib import Path

    from opensearch_tpu_torch.ops import cuda_build

    src = (cuda_build.CSRC / "aggs.cu").read_text()
    guard = src.index("#ifdef AGG_OLD_ROUTE")
    assert src.index('#include "aggs_old_route.cuh"') > guard
    assert "AGG_OLD_ROUTE" not in cuda_aggs.defines()
    root = Path(cuda_build.CSRC).parent
    naming = sorted(str(p.relative_to(root)) for p in root.rglob("*.py")
                    if "agg_old_launch" in p.read_text()
                    or "AGG_OLD_ROUTE" in p.read_text())
    assert naming == ["testing/k5_sweep.py"]
    for macro in cuda_aggs.defines():
        assert f"= {macro};" in src
