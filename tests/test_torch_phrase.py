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
    """K8 / K9's wrapper checks every slot's row against the staged
    columns (padded as ``DeviceSegment.ensure_positions`` pads them), and
    its table holds ``{row start, row end, shift}`` per slot."""
    from opensearch_tpu_torch.ops import cuda_positions

    docs = draw_docs(2, n_docs=40)
    pf = postings_of(docs)
    _ref, (doc_ids, pos_offsets, _pos), _n_pad = staged(pf, len(docs))
    slots = tphrase.phrase_slots(pf, ["w0", "w1"], [0, 1])
    cuda_positions.check_slots(slots, doc_ids, pos_offsets)
    table = cuda_positions.slot_table(slots).reshape(-1, 3)
    assert table[:, :2].tolist() == slots.rows.tolist()
    assert table[:, 2].tolist() == slots.shifts.tolist()
    last = len(pf.doc_ids)
    whole = tphrase.PositionSlots(np.asarray([[0, last]]), np.zeros(1, int))
    cuda_positions.check_slots(whole, doc_ids, pos_offsets)
    for rows in ([[0, doc_ids.shape[0] + 1]], [[3, 2]], [[-1, 2]]):
        with pytest.raises(ValueError):
            cuda_positions.check_slots(tphrase.PositionSlots(
                np.asarray(rows), np.zeros(1, int)), doc_ids, pos_offsets)
    with pytest.raises(ValueError):
        cuda_positions.phrase_freqs_cuda(doc_ids, pos_offsets, _pos, slots,
                                         _n_pad)
