"""The plain versions of K8 and K9 (``opensearch_tpu_torch/ops/phrase.py``
``phrase_freqs``, ``ops/span.py`` ``span_near_freqs``) against the JAX
package's ``phrase_freqs`` and ``span_near_freqs``, and the port's
``PhrasePlan``, ``SpanNearPlan`` and ``DisMaxPlan`` against the
reference's plans, on the CPU.

Postings with positions are made from seeded numpy draws: docs of tokens
over a small vocabulary, with stopword gaps (skipped positions) in some.
The per-doc frequencies must be equal exactly (they are float32 counts),
for 2 to 6 slots, duplicated terms, a term the segment lacks, a term with
one posting, a slot whose position count fills its power-of-two gather
budget exactly, ordered spans at slop 0 / 1 / 3 / large, unordered spans
of one term and of two, span_first ends 0 / 1 / 5 / none, and positions
just below the reference's key base ``2^22`` (where comparing (doc,
position) pairs, as the port does, gives the reference's int64 keys'
answer).  Plan scores and matched masks compare byte for byte through
both searchers' full-scores pass.  The seeded corpus's positions
(``testing/corpus.py``) are held to what the writer builds from the same
draws.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opensearch_tpu.index.segment import SegmentWriter as JaxWriter
from opensearch_tpu.mapping.mapper import DocumentMapper as JaxMapper
from opensearch_tpu.ops import bm25 as jbm25
from opensearch_tpu.ops import phrase as jphrase
from opensearch_tpu.ops import span as jspan
from opensearch_tpu.search.executor import ShardSearcher as JaxSearcher
from opensearch_tpu_torch.index.segment import (SegmentWriter, pad_bucket,
                                                pad_pow2)
from opensearch_tpu_torch.mapping.mapper import DocumentMapper
from opensearch_tpu_torch.ops import phrase as tphrase
from opensearch_tpu_torch.ops import span as tspan
from opensearch_tpu_torch.search.compiler import _SPAN_NO_END
from opensearch_tpu_torch.search.executor import ShardSearcher
from opensearch_tpu_torch.testing import corpus
from opensearch_tpu_torch.testing.positions import (KEY_BASE, VOCAB,
                                                    bucket_docs, draw_docs,
                                                    phrase_sets, postings_of,
                                                    runs, span_sets,
                                                    trap_docs)

def _pad(a, fill):
    out = np.full(pad_pow2(len(a)), fill, a.dtype)
    out[: len(a)] = a
    return out


def staged(pf, n_docs):
    """(the reference's staged postings dict, the port's columns, n_pad),
    padded as each package stages them."""
    off_fill = pf.pos_offsets[-1]
    cols = {"offsets": _pad(pf.offsets, pf.offsets[-1]),
            "doc_ids": _pad(pf.doc_ids, n_docs),
            "pos_offsets": _pad(pf.pos_offsets, off_fill),
            "positions": _pad(pf.positions, 0)}
    ref = {k: jnp.asarray(v) for k, v in cols.items()}
    port = tuple(torch.from_numpy(cols[k])
                 for k in ("doc_ids", "pos_offsets", "positions"))
    return ref, port, pad_pow2(n_docs + 1)


def slot_args(pf, terms, tight):
    """The reference's (term ids, active, budgets) of ``terms``:
    ``tight`` budgets are the position counts' powers of two (a count
    that is one fills its bucket exactly), else the plan's buckets."""
    tids, active, budgets = [], [], []
    for t in terms:
        tid = pf.term_id(t)
        count = 0
        if tid >= 0:
            e0, e1 = pf.offsets[tid], pf.offsets[tid + 1]
            count = int(pf.pos_offsets[e1] - pf.pos_offsets[e0])
        tids.append(max(tid, 0))
        active.append(tid >= 0)
        budgets.append(pad_pow2(count, minimum=1) if tight
                       else pad_bucket(count, minimum=1024))
    return (jnp.asarray(np.asarray(tids, np.int32)),
            jnp.asarray(np.asarray(active)), tuple(budgets))


def phrase_pair(pf, n_docs, terms, offs, tight):
    ref, port, n_pad = staged(pf, n_docs)
    tids, active, budgets = slot_args(pf, terms, tight)
    want = np.asarray(jphrase.phrase_freqs(
        ref, tids, active, jnp.asarray(np.asarray(offs, np.int32)),
        budgets=budgets, n_pad=n_pad))
    got = tphrase.phrase_freqs(*port, tphrase.phrase_slots(pf, terms, offs),
                               n_pad).numpy()
    return got, want


def span_pair(pf, n_docs, terms, tight, ordered, slop, end):
    ref, port, n_pad = staged(pf, n_docs)
    tids, active, budgets = slot_args(pf, terms, tight)
    want = np.asarray(jspan.span_near_freqs(
        ref, tids, active, budgets=budgets, n_pad=n_pad, ordered=ordered,
        slop=jnp.int32(slop), end=jnp.int32(end)))
    got = tspan.span_near_freqs(*port, tspan.span_slots(pf, terms), n_pad,
                                ordered=ordered, slop=slop, end=end).numpy()
    return got, want


PHRASE_CASES = {
    "two": dict(length=2), "three": dict(length=3), "four": dict(length=4),
    "five": dict(length=5), "six": dict(length=6),
    "gaps": dict(length=3, gaps=True),
    "duplicated": dict(terms=["w1", "w1"], offs=[0, 1]),
    "to_be_or_not": dict(terms=["w2", "w1", "w0", "w3", "w2", "w1"],
                         offs=[0, 1, 2, 3, 4, 5],
                         plant=[[2, 1, 0, 3, 2, 1, 7, 2, 1, 0, 3, 2, 1],
                                [2, 1, 0, 3, 2, 2]]),
    "missing": dict(terms=["w0", f"w{VOCAB + 5}"], offs=[0, 1]),
    "one_posting": dict(terms=["w0", "w11"], offs=[0, 1], one_posting=True),
    "stopword_hole": dict(terms=["w0", "w1"], offs=[0, 2], gaps=True),
}


@pytest.mark.parametrize("tight", [False, True], ids=["bucket", "tight"])
@pytest.mark.parametrize("case", sorted(PHRASE_CASES))
def test_phrase_freqs_equal_reference(case, tight):
    spec = PHRASE_CASES[case]
    docs = draw_docs(3, gaps=spec.get("gaps", False))
    # planted docs: the phrase twice in one, a near miss in the other
    docs += [[(t, p) for p, t in enumerate(d)] for d in spec.get("plant", ())]
    # w11 has one posting: doc 7, right after a w0 placed there
    extra = ((0, 7, 1000), (11, 7, 1001)) if spec.get("one_posting") else ()
    pf = postings_of(docs, extra)
    cases = ([(spec["terms"], spec["offs"])] if "terms" in spec
             else runs(docs, spec["length"], 6, seed=len(case)))
    hits = 0
    for terms, offs in cases:
        got, want = phrase_pair(pf, len(docs), terms, offs, tight)
        np.testing.assert_array_equal(got, want, err_msg=str(terms))
        hits += int(want.sum())
    if case != "missing":
        assert hits > 0


def test_phrase_slot_filling_its_bucket_exactly():
    """A slot whose term has exactly 1,024 positions (the plan's smallest
    bucket, no key padding) anchors and is searched right."""
    docs = bucket_docs()
    pf = postings_of(docs)
    tid = pf.term_id("w1")
    assert pf.pos_offsets[pf.offsets[tid + 1]] - \
        pf.pos_offsets[pf.offsets[tid]] == 1024
    for terms, offs in ((["w1", "w2"], [0, 1]), (["w2", "w1"], [0, 1]),
                        (["w1", "w1", "w2"], [0, 1, 2])):
        for tight in (False, True):
            got, want = phrase_pair(pf, len(docs), terms, offs, tight)
            np.testing.assert_array_equal(got, want)
            assert want.sum() > 0


SPAN_CASES = [
    ("ordered_slop0", True, 2, 0, _SPAN_NO_END),
    ("ordered_slop1", True, 2, 1, _SPAN_NO_END),
    ("ordered_slop3", True, 3, 3, _SPAN_NO_END),
    ("ordered_large", True, 4, 1000, _SPAN_NO_END),
    ("ordered_end5", True, 2, 2, 5),
    ("unordered_slop0", False, 2, 0, _SPAN_NO_END),
    ("unordered_slop2", False, 2, 2, _SPAN_NO_END),
    ("unordered_beyond_key_base", False, 2, KEY_BASE + 1, _SPAN_NO_END),
    ("first_end0", True, 1, 0, 0),
    ("first_end1", True, 1, 0, 1),
    ("first_end5", True, 1, 0, 5),
    ("first_no_end", True, 1, 0, _SPAN_NO_END),
]


@pytest.mark.parametrize("tight", [False, True], ids=["bucket", "tight"])
@pytest.mark.parametrize("name,ordered,k,slop,end", SPAN_CASES,
                         ids=[c[0] for c in SPAN_CASES])
def test_span_near_freqs_equal_reference(name, ordered, k, slop, end,
                                         tight):
    docs = draw_docs(5, gaps=True)
    pf = postings_of(docs)
    rng = np.random.default_rng(k * 31 + slop % 97)
    pairs = [[f"w{int(t)}" for t in rng.integers(0, 4, size=k)]
             for _ in range(5)]
    if not ordered:
        pairs += [["w0", "w0"], ["w1", "w1"], ["w0", f"w{VOCAB + 3}"]]
    else:
        pairs += [["w0"] * k, ["w0", f"w{VOCAB + 3}"][:max(k, 1)]]
    hits = 0
    for terms in pairs:
        got, want = span_pair(pf, len(docs), terms, tight, ordered, slop,
                              end)
        np.testing.assert_array_equal(got, want, err_msg=str(terms))
        hits += int(want.sum())
    if name != "first_end0":
        assert hits > 0


def test_span_ordered_never_matches_backwards():
    """The reference's full-bucket fix: 1,023 ``b`` then a trap doc ``b
    a``; an ordered a -> b has no b after any a, at any slop, with the
    b slot exactly filling its bucket."""
    docs = trap_docs()
    pf = postings_of(docs)
    for slop in (0, 5, 1000):
        for tight in (False, True):
            got, want = span_pair(pf, len(docs), ["w1", "w2"], tight, True,
                                  slop, _SPAN_NO_END)
            np.testing.assert_array_equal(got, want)
            assert got.sum() == 0


@pytest.mark.parametrize("kind", ["phrase", "ordered", "unordered"])
def test_positions_below_key_base(kind):
    """Positions up to just below 2^22 (with the phrase offsets still
    below it): the (doc, position) pairs give the int64 keys' answer."""
    docs = draw_docs(9, n_docs=60, base=KEY_BASE - 40)
    pf = postings_of(docs)
    assert int(pf.positions.max()) >= KEY_BASE - 20
    for terms, offs in runs(docs, 2, 8, seed=4):
        if kind == "phrase":
            got, want = phrase_pair(pf, len(docs), terms, offs, False)
        else:
            got, want = span_pair(pf, len(docs), terms, False,
                                  kind == "ordered", 2, _SPAN_NO_END)
        np.testing.assert_array_equal(got, want)


def test_phrase_anchor_is_the_rarest_slot():
    """The anchor is the slot with the fewest positions, the others keep
    their offsets from it (negative before it)."""
    docs = draw_docs(3)
    pf = postings_of(docs)
    slots = tphrase.phrase_slots(pf, ["w0", "w5", "w1"], [0, 1, 3])
    counts = {t: int(pf.pos_offsets[pf.offsets[pf.term_id(t) + 1]]
                     - pf.pos_offsets[pf.offsets[pf.term_id(t)]])
              for t in ("w0", "w1", "w5")}
    assert counts["w5"] < min(counts["w0"], counts["w1"])
    assert slots.shifts.tolist() == [0, -1, 2]
    assert slots.rows[0].tolist() == [pf.offsets[5], pf.offsets[6]]


@pytest.mark.parametrize("kind", ["phrase", "span"])
def test_card_sets_equal_reference(kind):
    """The sets ``chip_smoke.py`` phase 2 holds K8 / K9 to their plain
    versions on (``testing/positions.py``) equal the reference here."""
    if kind == "phrase":
        for name, pf, cases in phrase_sets():
            n_docs = len(pf.present)
            for terms, offs in cases:
                for tight in (False, True):
                    got, want = phrase_pair(pf, n_docs, terms, offs, tight)
                    np.testing.assert_array_equal(got, want,
                                                  err_msg=f"{name} {terms}")
        return
    for name, pf, cases in span_sets():
        n_docs = len(pf.present)
        for terms, ordered, slop, end in cases:
            got, want = span_pair(pf, n_docs, terms, True, ordered, slop,
                                  end)
            np.testing.assert_array_equal(got, want,
                                          err_msg=f"{name} {terms}")


# -- plans, through both searchers' full-scores pass -------------------------

MAPPING = {"properties": {"body": {"type": "text"},
                          "title": {"type": "text"}}}
WORDS = [f"w{i}" for i in range(12)]


def searchers(seed=11, sizes=(90, 70)):
    rng = np.random.default_rng(seed)
    docs = [{"body": " ".join(rng.choice(WORDS[:8], size=int(n))),
             "title": " ".join(rng.choice(WORDS, size=3))}
            for n in rng.integers(1, 25, size=sum(sizes))]
    out = []
    for writer, mapper_cls, searcher_cls, kw in (
            (JaxWriter(), JaxMapper, JaxSearcher, {}),
            (SegmentWriter(), DocumentMapper, ShardSearcher,
             {"device": "cpu"})):
        mapper = mapper_cls(MAPPING)
        segs, i = [], 0
        for si, size in enumerate(sizes):
            segs.append(writer.build(
                [mapper.parse(str(i + j), d)
                 for j, d in enumerate(docs[i: i + size])], f"p{si}"))
            i += size
        out.append(searcher_cls(segs, mapper, **kw))
    return out


PLAN_BODIES = {
    "phrase": {"match_phrase": {"body": "w1 w2"}},
    "phrase_3": {"match_phrase": {"body": {"query": "w0 w1 w0",
                                           "boost": 1.7}}},
    "span_ordered": {"span_near": {"clauses": [
        {"span_term": {"body": "w0"}}, {"span_term": {"body": "w3"}}],
        "slop": 2, "in_order": True}},
    "span_unordered": {"span_near": {"clauses": [
        {"span_term": {"body": "w2"}}, {"span_term": {"body": "w2"}}],
        "slop": 1, "in_order": False}},
    "span_first": {"span_first": {"match": {"span_term": {"body": "w4"}},
                                  "end": 3}},
    "dis_max": {"dis_max": {"queries": [
        {"match_phrase": {"body": "w0 w1"}}, {"match": {"body": "w1 w5"}},
        {"match": {"title": "w1"}}], "tie_breaker": 0.35, "boost": 1.3}},
    "dis_max_unscored": {"bool": {"filter": [{"dis_max": {"queries": [
        {"match_phrase": {"body": "w3 w3"}}, {"match": {"title": "w2"}}]}}]}},
}


@pytest.fixture(scope="module")
def plan_pair():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jbm25, "HOST_SCORING", False)
        yield searchers()


@pytest.mark.parametrize("name", sorted(PLAN_BODIES))
def test_plan_scores_equal_reference(plan_pair, name):
    """Scores and matched masks of every segment, byte for byte."""
    jax_s, port_s = plan_pair
    q = PLAN_BODIES[name]
    jb = jax_s.compiled(q)
    pb = port_s.compiled(q)
    assert type(jb[0]).__name__ == type(pb[0]).__name__
    ref = list(jax_s._run_full(*jb, jb[0].arrays(), None))
    got = list(port_s._run_full(*pb, pb[0].arrays(), None))
    assert len(ref) == len(got) == 2
    matched = 0
    for (_s, _d, rs, rm), (_s2, _d2, gs, gm) in zip(ref, got):
        np.testing.assert_array_equal(np.asarray(rm), gm.numpy())
        np.testing.assert_array_equal(np.asarray(rs).view(np.int32),
                                      gs.numpy().view(np.int32))
        matched += int(gm.sum())
    assert matched > 0


def test_corpus_positions_are_the_writers():
    """``build_raw_corpus`` / ``make_segments`` positions are what the
    writer builds from ``render_texts`` of the same draws."""
    n = 400
    seg = corpus.make_segments(corpus.build_raw_corpus(n, seed=42), 1)[0]
    mapper = DocumentMapper({"properties": {"body": {"type": "text"}}})
    written = SegmentWriter().build(
        [mapper.parse(str(i), {"body": t})
         for i, t in enumerate(corpus.render_texts(n, seed=42))], "w")
    a, b = seg.postings["body"], written.postings["body"]
    for term, tid in b.terms.items():
        ta = a.term_id(term)
        ra = slice(a.offsets[ta], a.offsets[ta + 1])
        rb = slice(b.offsets[tid], b.offsets[tid + 1])
        np.testing.assert_array_equal(a.doc_ids[ra], b.doc_ids[rb])
        pa = a.positions[a.pos_offsets[ra.start]: a.pos_offsets[ra.stop]]
        pb = b.positions[b.pos_offsets[rb.start]: b.pos_offsets[rb.stop]]
        np.testing.assert_array_equal(pa, pb, err_msg=term)
    assert len(b.terms) == int((a.df > 0).sum())


def test_phrase_query_log_occurs():
    """Every run of ``phrase_query_log`` occurs in its doc, and its span
    clauses match it at their slop."""
    n = 2_000
    lens, terms = corpus._draws(n, 42)
    text = " " + " ".join(f"t{t}" for t in terms) + " "
    for run in corpus.phrase_query_log(20, seed=3, n_docs=n):
        assert 2 <= len(run) <= 5
        assert " " + " ".join(f"t{t}" for t in run) + " " in text
        clauses, slop = corpus.span_clauses(run, 2)
        assert clauses == (run[0], run[-1]) and slop == len(run) - 2


def test_wrapper_checks_slot_rows():
    """K8 / K9's slots are checked once, when made, against their
    segment's postings (``PositionSlots.limits``), and the wrapper takes
    a job only when its slots' limits are its staged columns' (a
    ``StagedPositions``, checked once when staged, padded as
    ``DeviceSegment.ensure_positions`` pads them); its launch table holds
    each job's words and its ``{row start, row end, shift}`` per slot; it
    takes CUDA tensors only."""
    from opensearch_tpu_torch.ops import cuda_positions as cp

    docs = draw_docs(2, n_docs=40)
    pf = postings_of(docs)
    cols = tphrase.stage_host_positions(pf, "cpu")
    n_pad = pad_pow2(len(docs) + 1)
    slots = tphrase.phrase_slots(pf, ["w0", "w1"], [0, 1])
    assert slots.limits == cols.limits == (len(pf.doc_ids),
                                           len(pf.positions))
    leaf = tphrase.PositionalLeaf(cols, slots, n_pad, 1.5, 7.0)
    jt = cp.job_table([leaf, leaf._replace(scored=False)], "phrase")
    words = jt.table[: 2 * cp.JOB_WORDS].reshape(2, cp.JOB_WORDS)
    slot_words = jt.table[2 * cp.JOB_WORDS:].reshape(-1, 3)
    assert slot_words[:2, :2].tolist() == slots.rows.tolist()
    assert slot_words[:2, 2].tolist() == slots.shifts.tolist()
    assert slot_words[2:].tolist() == slot_words[:2].tolist()
    assert words[:, cp.W_SLOTS].tolist() == [2 * cp.JOB_WORDS,
                                             2 * cp.JOB_WORDS + 6]
    p0, p1 = slots.anchor_positions
    blocks = -(-(p1 - p0) // cp.CHUNK)
    assert words[:, cp.W_BLOCK0].tolist() == [0, blocks]
    assert jt.n_blocks == 2 * blocks
    assert words[:, cp.W_OUT].tolist() == [0, n_pad]
    assert words[:, cp.W_FLAGS].tolist() == [cp.SCORED, 0]
    assert words[0, :4].tolist() == [t.data_ptr() for t in (
        cols.doc_ids, cols.pos_offsets, cols.positions, cols.doc_lens)]
    assert words[0, cp.W_SCORING: cp.W_SCORING + 1].view(
        np.float32).tolist() == [1.5, 7.0]
    last = len(pf.doc_ids)
    whole = tphrase.PositionSlots(np.asarray([[0, last]]), np.zeros(1, int),
                                  anchor_positions=(0, len(pf.positions)),
                                  limits=cols.limits)
    cp.job_table([leaf._replace(slots=whole)], "phrase")
    for rows, shifts, span in (([[0, last + 1]], [0], (0, 8)),
                               ([[3, 2]], [0], (0, 8)),
                               ([[-1, 2]], [0], (0, 8)),
                               ([[0, 2]], [0], (0, len(pf.positions) + 1)),
                               ([[0, 5]], [0], (0, 3)),
                               ([[0, 2], [3, 4]], [0, 1 << 30], (0, 8))):
        with pytest.raises(ValueError):
            tphrase.PositionSlots(np.asarray(rows), np.asarray(shifts),
                                  anchor_positions=span, limits=cols.limits)
    for limits in (None, (last, len(pf.positions) - 1)):
        other = tphrase.PositionSlots(slots.rows, slots.shifts,
                                      anchor_positions=(p0, p1),
                                      limits=limits)
        with pytest.raises(ValueError):
            cp.job_table([leaf._replace(slots=other)], "phrase")
    with pytest.raises(ValueError):
        cp.phrase_scores_cuda([leaf])
    with pytest.raises(TypeError):
        tphrase.stage_positions(cols.doc_ids.long(), cols.pos_offsets,
                                cols.positions, cols.doc_lens, last,
                                len(pf.positions))
    with pytest.raises(ValueError):
        tphrase.stage_positions(*cols.cols, cols.doc_lens, last,
                                len(pf.positions), 0)
    with pytest.raises(ValueError):
        tphrase.stage_positions(*cols.cols, cols.doc_lens, last,
                                cols.positions.numel() + 1)


# -- the request-wide entries and a model of K8 / K9's work split -----------

def _leaves(kind, sets, scored_first=True):
    """Every case of ``sets`` as ``PositionalLeaf`` jobs over CPU columns,
    each set's first case again unscored."""
    out = []
    for _name, pf, cases in sets:
        cols = tphrase.stage_host_positions(pf, "cpu")
        n_pad = pad_pow2(len(pf.doc_lens) + 1)
        avgdl = float(np.float32(np.mean(pf.doc_lens)))
        for i, case in enumerate(cases + cases[:1]):
            scored = i < len(cases)
            if kind == "phrase":
                slots = tphrase.phrase_slots(pf, *case)
                out.append(tphrase.PositionalLeaf(cols, slots, n_pad, 2.5,
                                                  avgdl, scored))
            else:
                terms, ordered, slop, end = case
                out.append(tphrase.PositionalLeaf(
                    cols, tspan.span_slots(pf, terms), n_pad, 2.5, avgdl,
                    scored, ordered, slop, end))
    return out


def kernel_model(leaves, kind, *, chunk, threads, tile, sparse, paths):
    """K8 / K9 (``csrc/positions.cu``) step by step in numpy, over
    ``cuda_positions.job_table``'s table: blocks of ``chunk`` anchor
    positions (taken in a shuffled order), their entries, each other
    slot's entries from a window of the slot's doc ids (searched doc by
    doc past ``sparse`` times the entries and ``tile`` ids, else walked in
    tiles: ``paths`` counts each), each
    thread's ``chunk // threads`` positions walked with one cursor per
    entry, counts per entry, entries that span blocks finished by the
    last block to arrive, BM25 in float32."""
    from opensearch_tpu_torch.ops import cuda_positions as cp

    span = kind == "span"
    jt = cp.job_table(leaves, kind)
    jobs = [leaf for leaf in leaves if cp._has_work(leaf, span)]
    n_out = int(jt.offsets[-1])
    scores = np.zeros(n_out, np.float32)
    matched = np.zeros(n_out, bool)
    scratch = np.zeros(2 * jt.n_blocks, np.int64)
    words = jt.table[: jt.n_jobs * cp.JOB_WORDS].reshape(-1, cp.JOB_WORDS)
    per_thread = chunk // threads
    rng = np.random.default_rng(5)
    for b in rng.permutation(jt.n_blocks):
        j = int(np.searchsorted(words[:, cp.W_BLOCK0], b, side="right")) - 1
        w, leaf = words[j], jobs[j]
        doc_ids = leaf.cols.doc_ids.numpy().astype(np.int64)
        po = leaf.cols.pos_offsets.numpy().astype(np.int64)
        pos = leaf.cols.positions.numpy().astype(np.int64)
        slots = jt.table[w[cp.W_SLOTS]: w[cp.W_SLOTS]
                         + 3 * w[cp.W_NSLOTS]].reshape(-1, 3)
        m = len(slots)
        e0, e1 = int(slots[0, 0]), int(slots[0, 1])
        flags = int(w[cp.W_FLAGS])
        ordered = bool(flags & cp.ORDERED)
        slop, end = int(w[cp.W_SLOP]), int(w[cp.W_END])
        p_begin = int(w[cp.W_PBEGIN])
        p_lo = p_begin + (int(b) - int(w[cp.W_BLOCK0])) * chunk
        p_hi = min(p_lo + chunk, p_begin + int(w[cp.W_PCOUNT]))
        row_off = po[e0: e1 + 1]
        ea = e0 + int(np.searchsorted(row_off, p_lo, side="right")) - 1
        eb = e0 + int(np.searchsorted(row_off, p_hi - 1, side="right")) - 1
        n_ent = eb - ea + 1
        assert 1 <= n_ent <= chunk
        sdoc, soff = doc_ids[ea: eb + 1], po[ea: eb + 2]
        n_pos = p_hi - p_lo
        v = pos[p_lo: p_hi]
        own = np.searchsorted(soff, np.arange(p_lo, p_hi), side="right") - 1
        prev = v.copy()
        alive = v < end if span else np.ones(n_pos, bool)
        for g in range(1, m):
            for r0, r1, shift in slots[g: g + 1]:
                same = r0 == e0 and r1 == e1
                if same:
                    ent = ea + np.arange(n_ent)
                else:
                    lo = r0 + np.searchsorted(doc_ids[r0:r1], sdoc[0])
                    hi = r0 + np.searchsorted(doc_ids[r0:r1], sdoc[-1] + 1)
                    if hi - lo > tile and hi - lo > sparse * n_ent:
                        paths["sparse"] += 1
                    elif hi > lo:
                        paths["tiles"] += -(-(hi - lo) // tile)
                    k = lo + np.searchsorted(doc_ids[lo:hi], sdoc)
                    found = (k < hi) & (doc_ids[np.minimum(k, len(doc_ids)
                                                           - 1)] == sdoc)
                    ent = np.where(found, k, -1)
                for t in range(threads):
                    cur, q, q0, q1 = -1, 0, 0, 0
                    for k in range(t * per_thread,
                                   min((t + 1) * per_thread, n_pos)):
                        if not alive[k]:
                            continue
                        tgt = (int(v[k]) + int(shift) if not span else
                               int(prev[k]) + 1 if ordered else int(v[k]))
                        if own[k] != cur:
                            cur = int(own[k])
                            e = int(ent[cur])
                            q0, q1 = (0, 0) if e < 0 else (int(po[e]),
                                                           int(po[e + 1]))
                            q = q0 + int(np.searchsorted(pos[q0:q1], tgt))
                        else:
                            while q < q1 and pos[q] < tgt:
                                q += 1
                        if not span:
                            ok = q < q1 and pos[q] == tgt
                        elif ordered:
                            ok = q < q1
                            if ok:
                                prev[k] = pos[q]
                        else:
                            best = tphrase.POS_BASE
                            for c in (q - 1, q, q + 1):
                                if q0 <= c < q1 and not (
                                        flags & cp.SAME_TERM
                                        and pos[c] == v[k]):
                                    best = min(best, abs(int(pos[c])
                                                         - int(v[k])) - 1)
                            ok = best <= slop
                        alive[k] &= ok
        if span and ordered and m > 1:
            alive &= prev - v - (m - 1) <= slop
        counts = np.bincount(own, weights=alive, minlength=n_ent)
        for e in range(n_ent):
            c = int(counts[e])
            bf = (int(soff[e]) - p_begin) // chunk
            bl = (int(soff[e + 1]) - 1 - p_begin) // chunk
            if bf != bl:
                key = 2 * (int(w[cp.W_BLOCK0]) + bf)
                scratch[key] += c
                scratch[key + 1] += 1
                if scratch[key + 1] - 1 != bl - bf:
                    continue
                c = int(scratch[key])
            if c > 0:
                d = int(w[cp.W_OUT]) + int(sdoc[e])
                matched[d] = True
                if flags & cp.SCORED:
                    s, _m = tphrase.positional_scores(
                        torch.tensor([float(c)]),
                        leaf.cols.doc_lens[int(sdoc[e]): int(sdoc[e]) + 1],
                        True, leaf.weight, leaf.avgdl)
                    scores[d] = s.item()
    return [(scores[a:z], matched[a:z])
            for a, z in zip(jt.offsets[:-1], jt.offsets[1:])]


def _assert_views_equal(got, want, what=""):
    assert len(got) == len(want)
    for i, ((gs, gm), (ws, wm)) in enumerate(zip(got, want)):
        gs, gm = np.asarray(gs), np.asarray(gm)
        np.testing.assert_array_equal(gm, wm.numpy(), err_msg=f"{what} {i}")
        np.testing.assert_array_equal(gs.view(np.int32),
                                      ws.numpy().view(np.int32),
                                      err_msg=f"{what} {i}")


MODEL_SHAPES = {
    "small": dict(chunk=16, threads=4, tile=16, sparse=2),
    "card": dict(chunk=1024, threads=256, tile=1024, sparse=8),
}


@pytest.mark.parametrize("shape", sorted(MODEL_SHAPES))
@pytest.mark.parametrize("kind", ["phrase", "span"])
def test_kernel_model_equals_plain_entry(kind, shape, monkeypatch):
    """A numpy model of K8 / K9's work split (``kernel_model``) gives the
    request-wide plain entry's scores and matched masks byte for byte on
    every set of ``testing/positions.py`` in one call; at 16-position
    blocks the sets cover entries over several blocks and both ways of
    finding a slot's entries."""
    from opensearch_tpu_torch.ops import cuda_positions as cp

    cfg = MODEL_SHAPES[shape]
    monkeypatch.setattr(cp, "CHUNK", cfg["chunk"])
    sets = phrase_sets() if kind == "phrase" else span_sets()
    leaves = _leaves(kind, sets)
    plain = tphrase.phrase_scores if kind == "phrase" else tspan.span_scores
    paths = {"sparse": 0, "tiles": 0}
    got = kernel_model(leaves, kind, paths=paths, **cfg)
    _assert_views_equal(got, plain(leaves), kind)
    if shape == "small":
        assert paths["sparse"] > 0 and paths["tiles"] > 0


def _segments_postings():
    """Three segments' postings: a phrase's term ``w11`` only in the
    first, ``w12`` in none."""
    out = []
    for seed in (21, 22, 23):
        docs = draw_docs(seed, n_docs=70, gaps=seed == 22)
        extra = ((11, 3, 1000), (0, 3, 999)) if seed == 21 else ()
        out.append(postings_of(docs, extra))
    return out


REQUEST_CASES = {
    "phrase": [(["w0", "w1"], [0, 1]), (["w1", "w0", "w2"], [0, 1, 3]),
               (["w0", "w11"], [0, 1]), (["w12", "w0"], [0, 1])],
    "span": [(["w0", "w1"], True, 2, _SPAN_NO_END),
             (["w2", "w0"], False, 1, _SPAN_NO_END),
             (["w0", "w11"], False, KEY_BASE, _SPAN_NO_END),
             (["w12", "w0"], True, 0, _SPAN_NO_END), (["w1"], True, 0, 4)],
}


@pytest.mark.parametrize("kind", ["phrase", "span"])
def test_request_entry_equals_per_segment(kind):
    """The request-wide plain entry over three segments (a term in one of
    them only, a term in none: an empty anchor or a missing slot; every
    case scored and unscored) equals ``phrase_freqs`` /
    ``span_near_freqs`` then ``positional_scores`` segment by segment,
    byte for byte."""
    leaves, want = [], []
    for pf in _segments_postings():
        cols = tphrase.stage_host_positions(pf, "cpu")
        n_pad = pad_pow2(len(pf.doc_lens) + 1)
        avgdl = float(np.float32(pf.total_len / len(pf.doc_lens)))
        for case in REQUEST_CASES[kind]:
            for scored in (True, False):
                if kind == "phrase":
                    slots = tphrase.phrase_slots(pf, *case)
                    tf = tphrase.phrase_freqs(*cols.cols, slots, n_pad)
                    leaf = tphrase.PositionalLeaf(cols, slots, n_pad, 1.75,
                                                  avgdl, scored)
                else:
                    terms, ordered, slop, end = case
                    slots = tspan.span_slots(pf, terms)
                    tf = tspan.span_near_freqs(*cols.cols, slots, n_pad,
                                               ordered=ordered, slop=slop,
                                               end=end)
                    leaf = tphrase.PositionalLeaf(cols, slots, n_pad, 1.75,
                                                  avgdl, scored, ordered,
                                                  slop, end)
                leaves.append(leaf)
                want.append(tphrase.positional_scores(
                    tf, cols.doc_lens, scored, 1.75, avgdl))
    entry = tphrase.phrase_scores if kind == "phrase" else tspan.span_scores
    got = entry(leaves)
    _assert_views_equal([(s.numpy(), m.numpy()) for s, m in got], want, kind)
    assert sum(int(m.sum()) for _s, m in got) > 0
    assert any(not leaf.slots.complete for leaf in leaves)
    assert any(leaf.slots.n_anchor == 0 for leaf in leaves)
    for (s, m), leaf in zip(got, leaves):
        if not leaf.scored:
            assert not s.any()


@pytest.mark.parametrize("kind", ["phrase", "span"])
def test_request_with_no_job(kind):
    """Jobs none of which can match (an absent anchor, a missing slot):
    zeros, no table words, no block."""
    from opensearch_tpu_torch.ops import cuda_positions as cp

    pf = _segments_postings()[1]
    cols = tphrase.stage_host_positions(pf, "cpu")
    n_pad = pad_pow2(len(pf.doc_lens) + 1)
    if kind == "phrase":
        leaves = [tphrase.PositionalLeaf(
            cols, tphrase.phrase_slots(pf, terms, [0, 1]), n_pad, 1.0, 5.0)
            for terms in (["w0", "w12"], ["w11", "w1"])]
    else:
        leaves = [tphrase.PositionalLeaf(
            cols, tspan.span_slots(pf, terms), n_pad, 1.0, 5.0, True,
            ordered, 1, _SPAN_NO_END)
            for terms, ordered in ((["w12", "w0"], False),
                                   (["w0", "w11"], True))]
    jt = cp.job_table(leaves, kind)
    assert (jt.n_jobs, jt.n_blocks, jt.table.size) == (0, 0, 0)
    assert jt.offsets.tolist() == [0, n_pad, 2 * n_pad]
    entry = tphrase.phrase_scores if kind == "phrase" else tspan.span_scores
    for s, m in entry(leaves):
        assert not s.any() and not m.any() and s.shape == (n_pad,)
