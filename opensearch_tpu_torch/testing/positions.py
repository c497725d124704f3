"""Seeded postings with positions for holding K8 / K9 to their plain
versions (``ops/phrase.py``, ``ops/span.py``): ``tests/test_torch_phrase.py``
against the JAX package on the CPU, and ``chip_smoke.py`` phase 2 on the
card.  Pure numpy; the segments' postings are this package's
``PostingsField``."""

from __future__ import annotations

import numpy as np

from opensearch_tpu_torch.index.segment import PostingsField
from opensearch_tpu_torch.ops.phrase import POS_BASE as KEY_BASE
from opensearch_tpu_torch.search.compiler import _SPAN_NO_END

VOCAB = 10


def draw_docs(seed: int, n_docs: int = 180, gaps: bool = False,
              base: int = 0) -> list:
    """Per doc a list of (term id, position): zipf-ish term ids over
    ``VOCAB``, positions ascending from ``base``, a skipped position (a
    stopword hole) after some tokens when ``gaps``."""
    rng = np.random.default_rng(seed)
    docs = []
    for _ in range(n_docs):
        n = int(rng.integers(1, 30))
        terms = (rng.zipf(1.5, size=n) - 1) % VOCAB
        step = 1 + (rng.random(n) < 0.2) if gaps else np.ones(n, int)
        pos = base + np.cumsum(step) - step[0]
        docs.append(list(zip(terms.tolist(), pos.tolist())))
    return docs


def postings_of(docs, extra=()) -> PostingsField:
    """The ``PostingsField`` of ``docs`` (term ``w<id>``), plus the one-off
    (term id, doc, position) occurrences ``extra``."""
    occ = {}
    for d, toks in enumerate(docs):
        for t, p in toks:
            occ.setdefault((t, d), []).append(p)
    for t, d, p in extra:
        occ.setdefault((t, d), []).append(p)
    keys = sorted(occ)
    n_terms = max(t for t, _d in keys) + 1
    df = np.bincount([t for t, _d in keys], minlength=n_terms).astype(
        np.int32)
    offsets = np.zeros(n_terms + 1, np.int32)
    offsets[1:] = np.cumsum(df)
    counts = [len(occ[k]) for k in keys]
    pos_offsets = np.zeros(len(keys) + 1, np.int32)
    pos_offsets[1:] = np.cumsum(counts)
    lens = np.asarray([max(1, len(t)) for t in docs], np.float32)
    return PostingsField(
        terms={f"w{t}": t for t in range(n_terms) if df[t]}, df=df,
        offsets=offsets,
        doc_ids=np.asarray([d for _t, d in keys], np.int32),
        tfs=np.asarray(counts, np.float32), pos_offsets=pos_offsets,
        positions=np.asarray([p for k in keys for p in sorted(occ[k])],
                             np.int32),
        doc_lens=lens, total_len=float(lens.sum()),
        docs_with_field=len(docs), has_norms=True,
        present=np.ones(len(docs), bool))


def runs(docs, length: int, n: int, seed: int) -> list:
    """``n`` seeded runs of ``length`` consecutive tokens of ``docs``:
    (terms, analyzer offsets), each occurring at least once."""
    rng = np.random.default_rng(seed)
    long_docs = [d for d in docs if len(d) >= length]
    out = []
    for _ in range(n):
        doc = long_docs[int(rng.integers(0, len(long_docs)))]
        a = int(rng.integers(0, len(doc) - length + 1))
        toks = doc[a: a + length]
        out.append(([f"w{t}" for t, _p in toks],
                    [p - toks[0][1] for _t, p in toks]))
    return out


def bucket_docs() -> list:
    """1,024 positions of ``w1`` (a power-of-two gather budget filled
    exactly) around ``w2``, and a doc ``w2 w1``."""
    docs = [[(1, 0), (1, 1), (1, 2), (2, 3)] for _ in range(256)]
    docs.append([(2, 0), (1, 1)])
    return docs + [[(1, 0), (1, 1), (1, 2)]] * 85


def trap_docs() -> list:
    """The reference's full-bucket trap: 1,023 ``w2`` then a doc ``w2
    w1``, so an ordered w1 -> w2 has no w2 after any w1."""
    return ([[(2, 0), (2, 1), (2, 2)] for _ in range(341)]
            + [[(2, 0), (1, 1)]])


TWELVE = [3, 1, 4, 1, 5, 9, 2, 6, 5, 3, 5, 8]


def twelve_docs() -> list:
    """``draw_docs(3)`` with a 12-token run (``TWELVE``) planted whole in
    three docs and with its last token changed in a fourth."""
    docs = draw_docs(3)
    near = TWELVE[:-1] + [7]
    for d, run in ((5, TWELVE), (60, TWELVE), (61, near), (170, TWELVE)):
        base = docs[d][-1][1] + 1
        docs[d] = docs[d] + [(t, base + i) for i, t in enumerate(run)]
    return docs


def heavy_docs() -> list:
    """``draw_docs(4)`` and a doc of 12,000 tokens, ``w7 w8`` 6,000 times:
    the anchor's heaviest entry spans several of K8 / K9's blocks."""
    return draw_docs(4) + [[(7 + (p % 2), p) for p in range(12_000)]]


def sparse_docs() -> list:
    """3,000 docs of ``draw_docs``, ``w0 w12`` appended to every 100th
    and ``w13`` to every 7th: a rare anchor whose docs spread over many of
    ``w0``'s (a slot's window searched doc by doc), and a commoner one
    (its window walked in several tiles)."""
    docs = draw_docs(6, n_docs=3_000)
    for d in range(0, len(docs), 7):
        docs[d] = docs[d] + [(13, docs[d][-1][1] + 1)]
    for d in range(0, len(docs), 100):
        p = docs[d][-1][1]
        docs[d] = docs[d] + [(0, p + 1), (12, p + 2)]
    return docs


def phrase_sets() -> list:
    """(name, PostingsField, [(terms, offsets)]) of the phrase cases:
    2 to 6 and 12 slots, stopword holes, duplicated terms ("to be or not
    to be"), a missing term, a one-posting term, a slot filling its
    bucket exactly, positions just below ``KEY_BASE``, an anchor entry of
    6,000 positions, and rare anchors beside a common term."""
    docs = draw_docs(3)
    planted = docs + [[(t, p) for p, t in enumerate(d)]
                      for d in ([2, 1, 0, 3, 2, 1, 7, 2, 1, 0, 3, 2, 1],
                                [2, 1, 0, 3, 2, 2])]
    gaps = draw_docs(3, gaps=True)
    near_base = draw_docs(9, n_docs=60, base=KEY_BASE - 40)
    out = []
    for length in range(2, 7):
        out.append((f"{length}_slots", postings_of(docs),
                    runs(docs, length, 6, seed=length)))
    out.append(("stopword_holes", postings_of(gaps),
                runs(gaps, 3, 6, seed=9) + [(["w0", "w1"], [0, 2])]))
    out.append(("duplicated", postings_of(planted),
                [(["w1", "w1"], [0, 1]),
                 (["w2", "w1", "w0", "w3", "w2", "w1"], list(range(6)))]))
    out.append(("missing_and_one_posting",
                postings_of(docs, ((0, 7, 1000), (11, 7, 1001))),
                [(["w0", f"w{VOCAB + 5}"], [0, 1]), (["w0", "w11"], [0, 1])]))
    out.append(("full_bucket", postings_of(bucket_docs()),
                [(["w1", "w2"], [0, 1]), (["w2", "w1"], [0, 1]),
                 (["w1", "w1", "w2"], [0, 1, 2])]))
    out.append(("near_key_base", postings_of(near_base),
                runs(near_base, 2, 8, seed=4)))
    twelve = [f"w{t}" for t in TWELVE]
    out.append(("twelve_slots", postings_of(twelve_docs()),
                [(twelve, list(range(12))), (twelve[:11], list(range(11))),
                 (twelve[1:], list(range(11)))]))
    out.append(("heavy_entry", postings_of(heavy_docs()),
                [(["w7", "w8"], [0, 1]), (["w8", "w7"], [0, 1]),
                 (["w7", "w8", "w7"], [0, 1, 2]), (["w7", "w7"], [0, 1]),
                 (["w8", "w7"], [0, 2])]))
    out.append(("sparse_windows", postings_of(sparse_docs()),
                [(["w0", "w12"], [0, 1]), (["w12", "w0"], [0, 1]),
                 (["w13", "w0"], [0, 1]), (["w1", "w13"], [0, 1]),
                 (["w0", "w12", "w1"], [0, 1, 2])]))
    return out


def span_sets() -> list:
    """(name, PostingsField, [(terms, ordered, slop, end)]) of the span
    cases: ordered at slop 0 / 1 / 3 / large, unordered of one term and of
    two (and past the key base's gap), span_first ends 0 / 1 / 5 / none,
    the full-bucket trap, positions just below ``KEY_BASE``, an anchor
    entry of 6,000 positions, rare anchors beside a common term."""
    no_end = _SPAN_NO_END
    pf = postings_of(draw_docs(5, gaps=True))
    rng = np.random.default_rng(17)

    def terms(k):
        return [f"w{int(t)}" for t in rng.integers(0, 4, size=k)]

    cases = [(terms(k), True, slop, no_end)
             for k, slop in ((2, 0), (2, 1), (3, 3), (4, 1000))
             for _ in range(3)]
    cases += [(terms(2), True, 2, 5), (["w0", "w0"], True, 1, no_end)]
    cases += [(t, False, slop, no_end)
              for t in (["w0", "w0"], ["w1", "w1"], ["w0", "w2"],
                        ["w3", "w1"], ["w0", f"w{VOCAB + 3}"])
              for slop in (0, 2, KEY_BASE + 1)]
    cases += [(["w0"], True, 0, end) for end in (0, 1, 5, no_end)]
    near = postings_of(draw_docs(9, n_docs=60, base=KEY_BASE - 40))
    return [("spans", pf, cases),
            ("trap", postings_of(trap_docs()),
             [(["w1", "w2"], True, slop, no_end) for slop in (0, 5, 1000)]),
            ("near_key_base", near,
             [(["w0", "w1"], True, 2, no_end), (["w1", "w0"], False, 2,
                                                no_end)]),
            ("heavy_entry", postings_of(heavy_docs()),
             [(["w7", "w8"], True, 0, no_end), (["w8", "w7", "w8"], True, 1,
                                                no_end),
              (["w7", "w8"], False, 0, no_end), (["w7", "w7"], False, 1,
                                                 no_end),
              (["w8"], True, 0, 9_000), (["w7", "w9"], False, 3, no_end)]),
            ("sparse_windows", postings_of(sparse_docs()),
             [(["w12", "w0"], True, 2, no_end), (["w13", "w0"], False, 1,
                                                 no_end),
              (["w12", "w0"], False, 0, no_end)])]
