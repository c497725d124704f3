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

def k5_model(segments, mode, edges=None, self_metric=False, threads=256):
    """numpy model of ``csrc/aggs.cu``: per segment, entries streamed in
    chunks of ``threads``, warps of 32, each warp's entries grouped by
    bucket, the groups' complete tree nodes (up to 32 entries) pushed in
    rank order into a binary counter per bucket, warp after warp; the
    counter folded from its lowest level up at the end.  Returns the
    flat int64 output."""
    n_subs = 1 if self_metric else len(segments[0]["subs"])
    out = []
    for seg in segments:
        keys, kdocs, matched = seg["keys"], seg["key_docs"], seg["matched"]
        nb = seg["n_buckets"]
        nbp = pad_pow2(nb + 1)
        n = len(keys)
        if mode == "ordinal":
            b = keys.astype(np.int64)
        elif mode == "edges":
            b = np.searchsorted(edges, keys.astype(np.float64),
                                side="right") - 1
        else:
            b = np.where((keys < 0) if keys.dtype == np.int32 else
                         np.zeros(n, bool), -1, 0)
        valid = (b >= 0) & (b < nb) & matched[kdocs]
        if mode == "edges":
            valid &= np.r_[True, (kdocs[1:] != kdocs[:-1]) | (b[1:] != b[:-1])]

        def partial(e, jj):
            if self_metric:
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

        count = np.zeros(nbp, np.int64)
        stacks = [np.zeros((nbp, 64)) for _ in range(n_subs)]
        acc = [[np.zeros(nbp, np.int64), np.full(nbp, np.inf),
                np.full(nbp, -np.inf)] for _ in range(n_subs)]
        for base in range(0, n, threads):
            groups, sizes = [], []
            for w in range(threads // 32):
                g = {}
                for e in range(base + 32 * w, min(base + 32 * w + 32, n)):
                    if valid[e]:
                        g.setdefault(int(b[e]), []).append(e)
                groups.append(g)
                sizes.append({k: len(v) for k, v in g.items()})
            for w, g in enumerate(groups):
                for bk, es in g.items():
                    r0 = count[bk] + sum(s.get(bk, 0) for s in sizes[:w])
                    rend = r0 + len(es)
                    for jj in range(n_subs):
                        x = [list(partial(e, jj)) for e in es]
                        step = 1
                        while step < 32:
                            for i in range(len(es)):
                                r = r0 + i
                                if r % (2 * step) == 0 and r + 2 * step <= rend:
                                    a, o = x[i], x[i + step]
                                    x[i] = [a[0] + o[0], a[1] + o[1],
                                            min(a[2], o[2]), max(a[3], o[3])]
                            step *= 2
                        p = r0
                        while p < rend:
                            lv = 0
                            while lv < 5 and p % (2 << lv) == 0 and \
                                    p + (2 << lv) <= rend:
                                lv += 1
                            node = x[p - r0]
                            carry, ll = node[0], lv
                            while (p >> ll) & 1:
                                carry = stacks[jj][bk, ll] + carry
                                ll += 1
                            stacks[jj][bk, ll] = carry
                            acc[jj][0][bk] += node[1]
                            acc[jj][1][bk] = min(acc[jj][1][bk], node[2])
                            acc[jj][2][bk] = max(acc[jj][2][bk], node[3])
                            p += 1 << lv
            for s in sizes:
                for bk, c in s.items():
                    count[bk] += c
        parts = [count]
        for jj in range(n_subs):
            sums = np.zeros(nbp)
            for bk in range(nbp):
                have, a = False, 0.0
                for lv in range(64):
                    if (count[bk] >> lv) & 1:
                        a = stacks[jj][bk, lv] + a if have else \
                            stacks[jj][bk, lv]
                        have = True
                sums[bk] = a + 0.0 if have else 0.0
            parts += [sums.view(np.int64), acc[jj][0],
                      acc[jj][1].view(np.int64), acc[jj][2].view(np.int64)]
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
    assert_exact(got, k5_model(segs, mode, edges))


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
    assert_exact(got, k5_model(segs, "single", self_metric=self_metric))


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
    """The launch table's words and the tile choice, as csrc/aggs.cu
    reads them: every segment's tiles cover its n_buckets_pad, shared
    memory stays under the cap, edges move to shared memory when they
    fit."""
    table, n_blocks = cuda_aggs.launch_table(
        [(1, 2, 3, [(4, 5)]), (6, 7, 8, [(0, 0)])],
        [(100, 20, 32, 0), (50, 300, 512, 160)], tile=64)
    words = cuda_aggs.HEAD_WORDS + 2
    assert table[:words].tolist() == [1, 2, 3, 100, 20, 32, 0, 0, 4, 5]
    assert table[words: 2 * words].tolist() == [6, 7, 8, 50, 300, 512, 160,
                                                0, 0, 0]
    assert n_blocks == 1 + 8
    work = table[2 * words:]
    assert (work >> 32).tolist() == [0] + [1] * 8
    assert (work & 0xffffffff).tolist() == [0] + list(range(8))
    tile, smem = cuda_aggs.plan_launch(2, 20, 367)
    assert tile == cuda_aggs.TILE_MAX and smem
    assert cuda_aggs.smem_bytes(tile, 2, 20, 367) <= cuda_aggs.SMEM_MAX
    tile, smem = cuda_aggs.plan_launch(16, 31, 65_537)
    assert not smem and tile < cuda_aggs.TILE_MAX
    assert cuda_aggs.smem_bytes(tile, 16, 31, 0) <= cuda_aggs.SMEM_MAX
    flat_words = taggs.output_words(as_collect(collect_case(3, "ordinal",
                                                            2)), 2)
    assert flat_words == [0, 16 * 9, 16 * 9 * 2]
