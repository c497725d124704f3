"""The quantized term-bag lowering of the PyTorch port (on the CPU, through
the plain versions of K4) against the JAX package's: the codec's arrays,
the packed-id gather and the quantized scoring functions, ``search`` and
``msearch`` on quantized segments, a shard that mixes quantized and f32
segments, K4's launch table, and the staging lint.

Both packages are set to the same lowering (``QUANTIZED_MODE``,
``QUANTIZED_MIN_DOCS``, ``QUANTIZED_DTYPE``) through ``monkeypatch`` on
both codec modules; segments are built by the JAX package and carried
into the port with ``segment_arrays`` / ``segment_from_arrays``.  The
tolerance is 0: ids and float32 scores byte for byte (modelled on
``tests/test_quantized.py``).
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opensearch_tpu.common.device_ledger import device_ledger
from opensearch_tpu.index import codec as jcodec
from opensearch_tpu.index.segment import SegmentWriter as JaxWriter
from opensearch_tpu.mapping.mapper import DocumentMapper as JaxMapper
from opensearch_tpu.ops import bm25 as jbm25
from opensearch_tpu.ops import quantized as jquant
from opensearch_tpu.search.executor import ShardSearcher as JaxSearcher
from opensearch_tpu_torch.index import codec as tcodec
from opensearch_tpu_torch.index.segment import (pad_bucket, segment_arrays,
                                                segment_from_arrays)
from opensearch_tpu_torch.mapping.mapper import DocumentMapper
from opensearch_tpu_torch.ops import bm25 as tbm25
from opensearch_tpu_torch.ops import cuda_bm25
from opensearch_tpu_torch.ops import quantized as tquant
from opensearch_tpu_torch.search import plan as tplan
from opensearch_tpu_torch.search.executor import ShardSearcher
from opensearch_tpu_torch.testing.parity import bm25_mismatch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MAPPING = {"properties": {"body": {"type": "text"}}}
SEG_SIZES = (150, 110)


@pytest.fixture(autouse=True)
def _clean_pager_state():
    led = device_ledger()
    led.reset()
    yield
    led.reset()


def set_lowering(monkeypatch, mode="on", min_docs=65536, dtype="int8"):
    for mod in (jcodec, tcodec):
        monkeypatch.setattr(mod, "QUANTIZED_MODE", mode)
        monkeypatch.setattr(mod, "QUANTIZED_MIN_DOCS", min_docs)
        monkeypatch.setattr(mod, "QUANTIZED_DTYPE", dtype)


def zipf_docs(seed, n, vocab=120, avg_len=24):
    rng = np.random.default_rng(seed)
    docs = []
    for _ in range(n):
        k = int(rng.integers(avg_len // 2, avg_len * 2))
        terms = (rng.zipf(1.4, size=k) - 1).clip(0, vocab - 1)
        docs.append({"body": " ".join(f"w{t}" for t in terms)})
    return docs


def build_pair(seed, prefix, deletes=True):
    """(JAX searcher, port searcher) over the same segments of
    ``SEG_SIZES`` docs, with deletes applied when asked.  The lowering
    must be set before: each searcher stages its segments on first use,
    under the policy of that moment."""
    docs = zipf_docs(seed, sum(SEG_SIZES))
    mapper, writer = JaxMapper(MAPPING), JaxWriter()
    jsegs, i = [], 0
    for si, size in enumerate(SEG_SIZES):
        jsegs.append(writer.build(
            [mapper.parse(str(i + j), d)
             for j, d in enumerate(docs[i: i + size])], f"{prefix}{si}"))
        i += size
    if deletes:
        rng = np.random.default_rng(seed + 1)
        for seg in jsegs:
            seg.apply_deletes(rng.choice(seg.n_docs, size=9, replace=False))
    tsegs = [segment_from_arrays(*segment_arrays(s)) for s in jsegs]
    return (JaxSearcher(jsegs, mapper),
            ShardSearcher(tsegs, DocumentMapper(MAPPING), device="cpu"))


def bodies(seed):
    rng = np.random.default_rng(seed + 5)
    w = [f"w{int(x)}" for x in rng.integers(0, 14, size=10)]
    return [
        {"query": {"match": {"body": f"{w[0]} {w[1]}"}}, "size": 20},
        {"query": {"term": {"body": w[2]}}, "size": 7},
        {"query": {"match": {"body": {"query": f"{w[3]} {w[4]}",
                                      "operator": "and"}}}, "size": 30},
        {"query": {"match": {"body": {
            "query": f"{w[0]} {w[5]} {w[6]} {w[7]}",
            "minimum_should_match": 2}}}},
        {"query": {"bool": {
            "must": [{"match": {"body": f"{w[1]} {w[8]}"}}],
            "should": [{"match": {"body": w[9]}}],
            "filter": [{"term": {"body": w[0]}}]}}, "size": 15},
        {"query": {"constant_score": {"filter": {"match": {"body": w[3]}},
                                      "boost": 2.5}}, "size": 12},
        {"query": {"match": {"body": f"{w[2]} {w[6]}"}}, "size": 40,
         "min_score": 1.5},
        {"query": {"match": {"body": f"{w[4]} w0"}}, "size": 300},
        {"query": {"match": {"body": f"{w[5]} {w[7]}"}}, "size": 6,
         "track_total_hits": False},
    ]


def quant_stats(searcher):
    """The port's quantized tables of ``body`` on every segment, built
    as the searcher's queries build them."""
    avgdl = searcher.ctx.field_stats("body").avgdl
    return [seg.quantized_table("body", avgdl).stats
            for seg in searcher.segments]


# seeds whose guard keeps some terms exact in every dtype
@pytest.fixture(params=[("int8", 3), ("int8", 17), ("int16", 33)],
                ids=["int8-3", "int8-17", "int16-33"])
def quantized_pair(request, monkeypatch):
    """(seed, dtype, JAX searcher, port searcher) over quantized segments
    with deletes, whose guard kept some terms exact (so the exact branch
    is exercised)."""
    dtype, seed = request.param
    set_lowering(monkeypatch, "on", dtype=dtype)
    jax_s, port_s = build_pair(seed, f"q{dtype}{seed}_")
    stats = quant_stats(port_s)
    assert all(s["dtype"] == dtype for s in stats)
    assert sum(s["exact_terms"] for s in stats) > 0
    assert sum(s["exact_terms"] for s in stats) < sum(s["terms"]
                                                      for s in stats)
    return seed, dtype, jax_s, port_s


# -- the codec ---------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["int8", "int16"])
def test_codec_tables_equal_the_reference_byte_for_byte(dtype, monkeypatch):
    set_lowering(monkeypatch, "on", dtype=dtype)
    jax_s, port_s = build_pair(11, f"codec{dtype}_")
    avgdl = jax_s.ctx.field_stats("body").avgdl
    assert np.float32(avgdl) == np.float32(
        port_s.ctx.field_stats("body").avgdl)
    for jseg, tseg in zip(jax_s.segments, port_s.segments):
        ref = jseg.quantized_table("body", avgdl)
        got = tseg.quantized_table("body", avgdl)
        a, b = tcodec.quantized_arrays(ref), tcodec.quantized_arrays(got)
        assert sorted(a) == sorted(b)
        for name in a:
            assert a[name].dtype == b[name].dtype, name
            assert a[name].tobytes() == b[name].tobytes(), name
        assert got.dtype == ref.dtype == dtype
        assert got.width == ref.width
        assert got.dequantized().tobytes() == ref.dequantized().tobytes()
        assert got.stats == ref.stats
        back = tcodec.quantized_from_arrays(a)
        assert back.dtype == dtype and back.width == ref.width
        assert back.dequantized().tobytes() == ref.dequantized().tobytes()


@pytest.mark.parametrize("seed", [0, 5])
def test_pack_unpack_doc_ids_roundtrip(seed):
    rng = np.random.default_rng(seed)
    dfs = rng.integers(0, 40, size=30)
    offsets = np.concatenate([[0], np.cumsum(dfs)]).astype(np.int32)
    ids = np.concatenate([np.sort(rng.choice(70_000, size=int(d),
                                             replace=False))
                          for d in dfs]).astype(np.int32)
    packed, base, width = tcodec.pack_doc_ids(ids, offsets)
    ref = jcodec.pack_doc_ids(ids, offsets)
    assert packed.tobytes() == ref[0].tobytes()
    assert base.tobytes() == ref[1].tobytes() and width == ref[2]
    np.testing.assert_array_equal(
        tcodec.unpack_doc_ids(packed, base, offsets, width), ids)


# -- the plain versions of K4 against the reference's jnp functions ----------

def quant_case(seed, dtype, monkeypatch):
    """A quantized segment's padded tables (as both packages stage them),
    its offsets and a bag of query terms, some exact, some inactive."""
    set_lowering(monkeypatch, "on", dtype=dtype)
    _jax_s, port_s = build_pair(seed, f"ops{dtype}{seed}_")
    seg = port_s.segments[0]
    avgdl = port_s.ctx.field_stats("body").avgdl
    qt = seg.quantized_table("body", avgdl)
    dseg = seg.device("cpu")
    q = dseg.quantized("body", avgdl)
    pf = seg.postings["body"]
    exact = np.flatnonzero(np.diff(qt.exact_offsets) > 0)
    plain = np.flatnonzero(np.diff(qt.exact_offsets) == 0)
    rng = np.random.default_rng(seed)
    tids = np.zeros(8, np.int32)
    pick = np.concatenate([exact[:2], rng.choice(plain, size=5)])[:5]
    tids[:5] = pick
    active = np.zeros(8, bool)
    active[:5] = True
    active[3] = False
    budget = pad_bucket(int(pf.df[tids[active]].sum()))
    idfs = rng.uniform(0.5, 3.0, size=8).astype(np.float32)
    weights = rng.uniform(0.5, 2.0, size=8).astype(np.float32)
    return dseg, q, qt, tids, active, idfs, weights, budget


@pytest.mark.parametrize("dtype,seed", [("int8", 3), ("int16", 33)])
def test_plain_k4_equals_the_reference_quantized_ops(dtype, seed,
                                                     monkeypatch):
    dseg, q, qt, tids, active, idfs, weights, budget = quant_case(
        seed, dtype, monkeypatch)
    assert (np.diff(qt.exact_offsets)[tids[active]] > 0).any()
    offsets = dseg.postings["body"]["offsets"]
    names = ("qvals", "scales", "exact_vals", "exact_offsets")
    t_args = (offsets, q["packed"], q["base"], *(q[n] for n in names),
              torch.from_numpy(tids), torch.from_numpy(active),
              torch.from_numpy(idfs), torch.from_numpy(weights))
    packed_u32 = q["packed"].numpy().view(np.uint32)
    j_args = (jnp.asarray(offsets.numpy()), jnp.asarray(packed_u32),
              jnp.asarray(q["base"].numpy()),
              *(jnp.asarray(q[n].numpy()) for n in names),
              jnp.asarray(tids), jnp.asarray(active), jnp.asarray(idfs),
              jnp.asarray(weights))
    kw = dict(width=qt.width, n_pad=dseg.n_pad, budget=budget)

    d, idx, slot, valid = tquant.gather_postings_packed(
        offsets, q["packed"], q["base"], torch.from_numpy(tids),
        torch.from_numpy(active), width=qt.width, budget=budget,
        pad_doc=dseg.n_pad - 1)
    jd, jidx, jslot, jvalid = jbm25.gather_postings_packed(
        j_args[0], j_args[1], j_args[2], j_args[7], j_args[8],
        width=qt.width, budget=budget, pad_doc=dseg.n_pad - 1)
    for a, b in ((d, jd), (idx, jidx), (slot, jslot), (valid, jvalid)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))

    got = tquant.quantized_impact_scores(*t_args, **kw)
    ref = jquant.quantized_impact_scores(*j_args, **kw)
    assert got.numpy().tobytes() == np.asarray(ref).tobytes()
    for scored in (True, False):
        gs, gc = tquant.quantized_impact_score_count(*t_args, **kw,
                                                     scored=scored)
        rs, rc = jquant.quantized_impact_score_count(*j_args, **kw,
                                                     scored=scored)
        assert gs.numpy().tobytes() == np.asarray(rs).tobytes()
        assert gc.numpy().tobytes() == np.asarray(rc).tobytes()
    assert bool((got > 0).any())


def test_plain_k4_equals_the_f32_scoring_of_the_dequantized_column(
        monkeypatch):
    """The invariant the kernel is held to on the card: K4 over the
    tables equals K2 over ``dequantized()`` staged as f32."""
    dseg, q, qt, tids, active, idfs, weights, budget = quant_case(
        17, "int8", monkeypatch)
    p = dseg.ensure_postings("body")
    deq = np.zeros(p["doc_ids"].shape[0], np.float32)
    deq[: len(qt.qvals)] = qt.dequantized()
    bag = (torch.from_numpy(tids), torch.from_numpy(active),
           torch.from_numpy(idfs), torch.from_numpy(weights))
    kw = dict(n_pad=dseg.n_pad, budget=budget)
    got = tquant.quantized_impact_score_count_plain(
        p["offsets"], q["packed"], q["base"], q["qvals"], q["scales"],
        q["exact_vals"], q["exact_offsets"], *bag, width=qt.width, **kw,
        scored=True)
    ref = tbm25.impact_score_count_plain(
        p["offsets"], p["doc_ids"], torch.from_numpy(deq), *bag, **kw,
        scored=True)
    for a, b in zip(got, ref):
        assert a.numpy().tobytes() == b.numpy().tobytes()


# -- search and msearch against the reference --------------------------------

@pytest.mark.parametrize("host_scoring", [False, True],
                         ids=["jax-device", "jax-host"])
def test_search_on_quantized_segments_byte_exact(quantized_pair,
                                                 host_scoring, monkeypatch):
    seed, _dtype, jax_s, port_s = quantized_pair
    monkeypatch.setattr(jbm25, "HOST_SCORING", host_scoring)
    hits = 0
    for body in bodies(seed):
        got, ref = port_s.search(dict(body)), jax_s.search(dict(body))
        assert bm25_mismatch(got, ref) is None, body
        hits += len(ref["hits"]["hits"])
    assert hits > 0
    for q in ({"match": {"body": "w0 w3"}}, {"term": {"body": "w1"}}):
        assert port_s.count(q) == jax_s.count(q)


def test_scored_bags_read_the_quantized_tables_and_filters_the_f32_columns(
        quantized_pair):
    """A scored bag on a quantized segment never stages the f32 posting
    columns; a filter-context bag stages them on demand."""
    _seed, _dtype, _jax_s, port_s = quantized_pair
    port_s.search({"query": {"match": {"body": "w0 w2"}}, "size": 300})
    port_s.search({"query": {"match": {"body": "w0 w2"}}, "size": 5})
    before = []
    for seg in port_s.segments:
        dseg = seg.device("cpu")
        assert dseg.quantized_mode
        assert set(dseg.postings["body"]) == {"offsets"}
        [tables] = dseg._quant_cache.values()
        held = sum(t.numel() * t.element_size()
                   for t in (*tables.values(), dseg.live,
                             dseg.postings["body"]["offsets"]))
        assert dseg.nbytes() == held
        before.append(held)
    port_s.count({"match": {"body": "w0"}})
    for seg, held in zip(port_s.segments, before):
        dseg = seg.device("cpu")
        assert {"doc_ids", "tfs"} <= set(dseg.postings["body"])
        assert dseg.nbytes() == held + 8 * dseg.postings["body"][
            "doc_ids"].numel()


def test_quantized_dims_and_topk_input_carry_the_tables(quantized_pair):
    _seed, _dtype, _jax_s, port_s = quantized_pair
    plan, bind = port_s.compiled({"match": {"body": "w0 w1 w2"}})
    seg = port_s.segments[0]
    dseg = seg.device("cpu")
    qt = seg.quantized_table("body", bind["avgdl"])
    dims, ins = plan.prepare(bind, seg, dseg, port_s.ctx)
    assert len(dims) == 4 and dims[3] == qt.width
    assert plan.skip_arrays(dims) == {("postings", "body")}
    A = {"live": dseg.live, "postings": {"body": dseg.postings["body"]}}
    inp = plan.topk_input(bind, seg, dseg, A)
    assert inp.doc_ids is None and inp.impacts is None
    q = inp.quant
    tids = inp.term_ids[inp.active]
    np.testing.assert_array_equal(q.slot_base[inp.active], qt.base[tids])
    np.testing.assert_array_equal(q.slot_scale[inp.active],
                                  qt.scales[tids])
    e0, e1 = qt.exact_offsets[tids], qt.exact_offsets[tids + 1]
    np.testing.assert_array_equal(q.slot_exact[inp.active],
                                  np.where(e1 > e0, e0, -1))
    filt = tplan.TermBagPlan(field="body", scored=False)
    fdims, _ins = filt.prepare(bind, seg, dseg, port_s.ctx)
    assert len(fdims) == 3 and filt.skip_arrays(fdims) == frozenset()


def test_msearch_on_quantized_segments_matches_reference_msearch(
        quantized_pair, monkeypatch):
    """Both batched paths keep the f32 lowering on quantized segments, so
    msearch compares with the reference's msearch (not with search,
    which scores the quantized tables)."""
    seed, _dtype, jax_s, port_s = quantized_pair
    monkeypatch.setattr(jbm25, "HOST_SCORING", False)
    batch = [b for b in bodies(seed) if "min_score" not in b
             and "track_total_hits" not in b and b.get("size", 10) <= 256]
    batch += [{"query": {"match": {"body": "w0 w1"}}, "size": 9},
              {"query": {"match": {"body": "w3 w5 w2"}}, "size": 9}]
    for got, ref in zip(port_s.msearch(batch), jax_s.msearch(batch)):
        assert bm25_mismatch(got, ref) is None


@pytest.mark.parametrize("host_scoring", [False, True],
                         ids=["jax-device", "jax-host"])
def test_mixed_shard_quantizes_only_the_large_segment(host_scoring,
                                                      monkeypatch):
    """With QUANTIZED_MIN_DOCS between the two segments' sizes, one
    segment takes the quantized lowering and one the f32 one, in both
    packages, and every answer is byte-equal."""
    set_lowering(monkeypatch, "auto", min_docs=128)
    monkeypatch.setattr(jbm25, "HOST_SCORING", host_scoring)
    jax_s, port_s = build_pair(29, "mixed_")
    modes = [seg.device("cpu").quantized_mode for seg in port_s.segments]
    assert modes == [True, False]
    for body in bodies(29):
        got, ref = port_s.search(dict(body)), jax_s.search(dict(body))
        assert bm25_mismatch(got, ref) is None, body
    plan, bind = port_s.compiled({"match": {"body": "w0 w1"}})
    inputs = [plan.topk_input(bind, seg, seg.device("cpu"), {
        "live": seg.device("cpu").live,
        "postings": {"body": seg.device("cpu").postings["body"]}})
        for seg in port_s.segments]
    assert [i.quant is not None for i in inputs] == [True, False]
    got = tbm25.term_bag_topk_segments_auto(inputs, k=10).numpy()
    for s, inp in enumerate(inputs):
        vals, ids, total, mx = tbm25.segment_topk(inp, 10, -np.inf)
        m = vals.shape[0]
        assert got[0][s][:m].tobytes() == vals.numpy().tobytes()
        assert got[1][s][:m].tobytes() == ids.numpy().tobytes()
        assert got[2][s] == int(total) and got[3][s] == float(mx)


def test_large_segments_need_no_forced_mode(monkeypatch):
    """With the default policy a segment of QUANTIZED_MIN_DOCS docs is
    quantized and answered as the reference answers it."""
    set_lowering(monkeypatch, "auto", min_docs=150)
    jax_s, port_s = build_pair(41, "auto_", deletes=False)
    assert [seg.device("cpu").quantized_mode
            for seg in port_s.segments] == [True, False]
    body = {"query": {"match": {"body": "w0 w1 w7"}}, "size": 25}
    assert bm25_mismatch(port_s.search(body), jax_s.search(body)) is None


def test_concurrent_first_searches_stage_each_table_once(monkeypatch):
    """Sixteen threads send the first searches of a fresh quantized
    searcher at once (scored bags build and stage the quantized tables,
    filter bags stage the f32 columns on demand), four times over: every
    answer equals the sequential one, and each segment keeps one staged
    table set."""
    from test_torch_batch import run_concurrent

    set_lowering(monkeypatch, "on")
    jax_s, port_s = build_pair(7, "conc_")
    body_list = bodies(7)
    want = [port_s.search(dict(b)) for b in body_list]
    for _round in range(4):
        fresh = ShardSearcher([segment_from_arrays(*segment_arrays(s))
                               for s in jax_s.segments],
                              DocumentMapper(MAPPING), device="cpu")
        got = run_concurrent(
            lambda i: fresh.search(dict(body_list[i % len(body_list)])),
            16, switch_s=0.00005)
        for i, resp in enumerate(got):
            assert bm25_mismatch(resp, want[i % len(body_list)]) is None
        for seg in fresh.segments:
            dseg = seg.device("cpu")
            assert len(dseg._quant_cache) == 1
            assert {"offsets", "doc_ids", "tfs"} == set(
                dseg.postings["body"])


# -- K4's launch table and wrappers on the CPU -------------------------------

def test_quantized_launch_table_layout(quantized_pair):
    _seed, _dtype, _jax_s, port_s = quantized_pair
    plan, bind = port_s.compiled({"match": {"body": "w0 w1 w2"}})
    inputs = []
    for seg in port_s.segments:
        dseg = seg.device("cpu")
        inputs.append(plan.topk_input(bind, seg, dseg, {
            "live": dseg.live, "postings": {"body": dseg.postings["body"]}}))
    table, n_blocks, n_slots = cuda_bm25.segments_table(inputs,
                                                        out_rows=[1, 0])
    sw, qw = cuda_bm25.QSEG_WORDS, cuda_bm25.QSLOT_WORDS
    head = table[: 2 * sw].reshape(2, sw)
    assert list(head[:, 6]) == [1, 0]
    for s, inp in enumerate(inputs):
        q = inp.quant
        assert head[s, 0] == q.packed.data_ptr()
        assert head[s, 1] == q.qvals.data_ptr()
        assert head[s, 2] == inp.live.data_ptr()
        assert head[s, 11] == q.exact_vals.data_ptr()
        assert head[s, 12] == q.width
    assert n_slots == sum(int(i.active.sum()) for i in inputs)
    words = table[2 * sw: 2 * sw + qw * n_slots].reshape(n_slots, qw)
    act = np.concatenate([i.active for i in inputs])
    base = np.concatenate([i.quant.slot_base for i in inputs])[act]
    scale = np.concatenate([i.quant.slot_scale for i in inputs])[act]
    exact = np.concatenate([i.quant.slot_exact for i in inputs])[act]
    rows = np.concatenate([i.rows for i in inputs])[act]
    np.testing.assert_array_equal(words[:, 0],
                                  rows[:, 0] | (rows[:, 1] << 32))
    np.testing.assert_array_equal(words[:, 2] & 0xFFFFFFFF, base)
    np.testing.assert_array_equal(
        (words[:, 2] >> 32).astype(np.uint32).view(np.float32), scale)
    np.testing.assert_array_equal(words[:, 3] >> 32, exact >= 0)
    np.testing.assert_array_equal((words[:, 3] & 0xFFFFFFFF)[exact >= 0],
                                  exact[exact >= 0])
    assert (exact >= 0).any()
    tiles = [cuda_bm25.n_tiles(i.live.shape[0]) for i in inputs]
    assert n_blocks == sum(tiles)
    assert len(table) == 2 * sw + qw * n_slots + n_blocks + 3


def test_k4_wrappers_refuse_cpu_tensors(quantized_pair):
    _seed, _dtype, _jax_s, port_s = quantized_pair
    plan, bind = port_s.compiled({"match": {"body": "w0 w1"}})
    seg = port_s.segments[0]
    dseg = seg.device("cpu")
    inp = plan.topk_input(bind, seg, dseg, {
        "live": dseg.live, "postings": {"body": dseg.postings["body"]}})
    with pytest.raises(ValueError, match="CUDA"):
        cuda_bm25.term_bag_topk_quantized_cuda([inp], k=10)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_bm25.term_bag_topk_segments_cuda([inp], k=10)
    q = inp.quant
    with pytest.raises(ValueError, match="CUDA"):
        cuda_bm25.term_bag_quantized_cuda(
            dseg.postings["body"]["offsets"], q.packed, q.base, q.qvals,
            q.scales, q.exact_vals, q.exact_offsets,
            torch.from_numpy(inp.term_ids), torch.from_numpy(inp.active),
            torch.from_numpy(inp.idfs), torch.from_numpy(inp.weights),
            width=q.width, n_pad=dseg.n_pad, budget=inp.budget,
            scores=True, counts=True)


# -- the staging lint --------------------------------------------------------

def test_check_quantized_staging_lint_passes_on_the_port():
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "tools",
                                      "check_quantized_staging.py"),
         os.path.join(ROOT, "opensearch_tpu_torch")],
        capture_output=True, text=True)
    assert out.returncode == 0, out.stdout + out.stderr
