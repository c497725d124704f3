"""Quantized device index codec: int8/int16 impacts + bit-packed doc ids
(the port of the JAX package's ``index/codec.py``, its numpy verbatim).

The f32 device layout spends 12 bytes per posting on the scored
term-bag path: 4 (doc_ids) + 4 (tfs, unused by impact scoring) + 4
(f32 impacts).  This codec is the compressed alternative, after the
Lucene quantized-impacts line (arxiv 0911.5046) and BM25S's eager
impact layout (arxiv 2407.03618):

- **Quantized impacts** — per-posting impacts become int8 (or int16)
  codes with a per-term scale factor ``scales[t] = mx[t] / qmax`` where
  ``mx`` is the per-term block-max metadata.  Quantization is
  truncating (``floor``) with a floor of 1, so a dequantized impact
  never exceeds the term's block max — ``plan.max_score_bound``'s
  pruning bounds stay conservative unchanged — and never hits exact
  zero, so ``scores > 0 == matched`` fast-path semantics survive.
- **Exact-rank-parity guard** — every term block is dequantized and
  compared against the f32 ranking (score-desc, doc-asc — the top-k's
  tie-break).  A term whose quantized ranking diverges falls back to
  exact f32 storage for that block (CSR ``exact_vals``/``exact_offsets``),
  so single-term rankings are rank-identical to f32 by construction.
- **Bit-packed doc ids** — postings store ``doc - base[term]`` deltas
  at a fixed segment-granular bit width, decoded on the device with two
  aligned uint32 reads per posting (random access preserved, no
  prefix-sum decode).

The lowering policy (``use_quantized``) decides per segment: "auto"
quantizes segments at/above ``QUANTIZED_MIN_DOCS``, "on"/"off" force
either path.  Scored term bags on a quantized segment are scored from
these tables by the quantized instantiation of the term-bag kernel
(``csrc/bm25.cu``; plain versions in ``ops/quantized.py``), as the
reference scores them.  The arrays must equal the reference's byte for
byte: the floor and clip in f32, the f64 ``lexsort`` and the guard word
all matter.  ``quantized_arrays`` / ``quantized_from_arrays`` carry a
table set between packages as numpy.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

# Lowering policy knobs (module globals, as in the reference): "auto"
# quantizes only large segments, "on"/"off" force the path.
# QUANTIZED_MIN_DOCS keeps small corpora on the f32 layout.
QUANTIZED_MODE = "auto"            # "auto" | "on" | "off"
QUANTIZED_MIN_DOCS = 65536
QUANTIZED_DTYPE = "int8"           # "int8" | "int16"

_QMAX = {"int8": 127, "int16": 32767}
_NP_DTYPE = {"int8": np.int8, "int16": np.int16}


def use_quantized(seg) -> bool:
    """Per-segment lowering decision: does this segment's scored
    term-bag path run on the quantized/paged layout?  Deterministic
    from segment size + module policy, so the device kernel and the
    byte-identical host fallback always agree on which table to read."""
    if QUANTIZED_MODE == "on":
        return True
    if QUANTIZED_MODE == "off":
        return False
    return int(getattr(seg, "n_docs", 0)) >= int(QUANTIZED_MIN_DOCS)


def quantized_segments(segments) -> list:
    """``[seg for seg in segments if use_quantized(seg)]``, the policy
    read once for all of them (the prefetch oracle asks for every segment
    of every scored request)."""
    if QUANTIZED_MODE == "on":
        return list(segments)
    if QUANTIZED_MODE == "off":
        return []
    floor = int(QUANTIZED_MIN_DOCS)
    return [seg for seg in segments if getattr(seg, "n_docs", 0) >= floor]


def _rank_order(vals: np.ndarray, docs: np.ndarray) -> np.ndarray:
    """Ranking a scorer induces on one postings list: score desc, then
    doc id asc — exactly ``lax.top_k``'s lower-index tie-break."""
    return np.lexsort((docs, -vals.astype(np.float64)))


@dataclass
class QuantizedPostings:
    """One (segment, field, avgdl) quantized table set.

    ``qvals``/``scales`` are the quantized impact column; terms whose
    quantized ranking broke parity store their f32 impacts sparsely in
    ``exact_vals`` at ``exact_offsets[t]:exact_offsets[t+1]`` (same
    in-list order as the postings CSR).  ``packed``/``base``/``width``
    are the bit-packed doc ids.  Everything is host numpy; staging to
    the device goes through ``DeviceSegment.quantized``."""

    qvals: np.ndarray                  # int8/int16 [P]
    scales: np.ndarray                 # f32 [T]
    exact_vals: np.ndarray             # f32 [E]
    exact_offsets: np.ndarray          # int32 [T+1]
    packed: np.ndarray                 # uint32 [W]
    base: np.ndarray                   # int32 [T]
    width: int
    dtype: str = "int8"
    avgdl: float = 0.0
    stats: dict = field(default_factory=dict)
    _deq: np.ndarray | None = None

    @property
    def nbytes(self) -> int:
        # an int attribute (numpy-style), not a method: cache weighers
        # read ``.nbytes`` off cached values directly
        return int(self.qvals.nbytes + self.scales.nbytes
                   + self.exact_vals.nbytes + self.exact_offsets.nbytes
                   + self.packed.nbytes + self.base.nbytes)

    def dequantized(self) -> np.ndarray:
        """Per-posting f32 impacts as the DEVICE kernel reconstructs
        them (``q.astype(f32) * scale``, exact blocks overridden): the
        kernel over the quantized tables equals the f32 kernel over this
        column, byte for byte.  Cached."""
        if self._deq is None:
            T = len(self.scales)
            lens = np.diff(self.exact_offsets)
            scale_of = np.repeat(self.scales,
                                 self._df()) if T else np.zeros(
                0, np.float32)
            deq = self.qvals.astype(np.float32) * scale_of
            if lens.sum():
                starts = self._offsets[:-1]
                for t in np.nonzero(lens)[0]:
                    e0, e1 = (int(self.exact_offsets[t]),
                              int(self.exact_offsets[t + 1]))
                    p0 = int(starts[t])
                    deq[p0: p0 + (e1 - e0)] = self.exact_vals[e0:e1]
            self._deq = deq
        return self._deq

    def _df(self) -> np.ndarray:
        return np.diff(self._offsets)

    # set by quantize_postings (not persisted; reload recomputes from
    # the segment's own offsets)
    _offsets: np.ndarray = None


def quantize_impacts(imp: np.ndarray, mx: np.ndarray,
                     offsets: np.ndarray, doc_ids: np.ndarray,
                     dtype: str = "int8"):
    """Quantize one field's per-posting impact column with the
    exact-rank-parity guard.

    Returns ``(qvals, scales, exact_vals, exact_offsets, stats)``.
    Truncating quantization with a floor of 1: ``q = clip(floor(imp /
    scale), 1, qmax)`` so (a) ``q * scale <= mx[t]`` — the block-max
    pruning bound holds unchanged — and (b) matched docs never decode
    to a zero contribution.  Terms whose dequantized ranking (score
    desc, doc asc) differs from f32 fall back to exact storage."""
    qmax = _QMAX[dtype]
    np_dt = _NP_DTYPE[dtype]
    T = len(offsets) - 1
    P = len(imp)
    scales = np.where(mx > 0, mx / np.float32(qmax), 1.0
                      ).astype(np.float32)
    scale_of = np.repeat(scales, np.diff(offsets)) if P else np.zeros(
        0, np.float32)
    q = np.clip(np.floor(imp / scale_of), 1, qmax) if P else np.zeros(
        0, np.float64)
    qvals = q.astype(np_dt)
    deq = qvals.astype(np.float32) * scale_of
    exact_lens = np.zeros(T, np.int32)
    exact_terms = []
    for t in range(T):
        e0, e1 = int(offsets[t]), int(offsets[t + 1])
        if e1 - e0 < 2:
            continue                # a 0/1-entry list cannot misrank
        docs = doc_ids[e0:e1]
        if np.array_equal(_rank_order(imp[e0:e1], docs),
                          _rank_order(deq[e0:e1], docs)):
            continue
        exact_lens[t] = e1 - e0
        exact_terms.append(t)
    exact_offsets = np.zeros(T + 1, np.int32)
    exact_offsets[1:] = np.cumsum(exact_lens)
    exact_vals = np.zeros(int(exact_offsets[-1]), np.float32)
    for t in exact_terms:
        e0, e1 = int(offsets[t]), int(offsets[t + 1])
        x0 = int(exact_offsets[t])
        exact_vals[x0: x0 + (e1 - e0)] = imp[e0:e1]
    stats = {"terms": T, "postings": P,
             "exact_terms": len(exact_terms),
             "exact_postings": int(exact_offsets[-1]),
             "dtype": dtype}
    return qvals, scales, exact_vals, exact_offsets, stats


def pack_doc_ids(doc_ids: np.ndarray, offsets: np.ndarray):
    """Delta-from-term-base + fixed-width bit pack at segment
    granularity.

    ``base[t]`` is the term's first doc id (doc ids ascend within one
    postings list, so every delta is non-negative); ``width`` is one
    segment-wide bit width — the max delta's bit length — so any
    posting decodes with two aligned uint32 reads (random access, no
    prefix-sum chain).  Returns ``(packed uint32 [W], base int32 [T],
    width)``; ``packed`` carries one guard word so lane ``w+1`` reads
    never go out of bounds."""
    T = len(offsets) - 1
    P = len(doc_ids)
    base = np.zeros(T, np.int32)
    lens = np.diff(offsets)
    nz = lens > 0
    base[nz] = doc_ids[offsets[:-1][nz]]
    deltas = (doc_ids.astype(np.int64)
              - np.repeat(base, lens).astype(np.int64)) if P else \
        np.zeros(0, np.int64)
    if P and deltas.min() < 0:
        raise ValueError("doc ids must ascend within a postings list")
    max_delta = int(deltas.max()) if P else 0
    width = max(1, int(max_delta).bit_length())
    if width > 31:
        raise ValueError(f"doc-id delta needs {width} bits (> 31)")
    n_words = (P * width + 31) // 32 + 1     # +1 guard word
    packed = np.zeros(n_words, np.uint32)
    if P:
        bitpos = np.arange(P, dtype=np.int64) * width
        word = (bitpos >> 5).astype(np.int64)
        off = (bitpos & 31).astype(np.uint64)
        val = deltas.astype(np.uint64) << off      # spans <= 2 words
        lo = (val & np.uint64(0xFFFFFFFF)).astype(np.uint32)
        hi = (val >> np.uint64(32)).astype(np.uint32)
        np.bitwise_or.at(packed, word, lo)
        np.bitwise_or.at(packed, word + 1, hi)
    return packed, base, width


def unpack_doc_ids(packed: np.ndarray, base: np.ndarray,
                   offsets: np.ndarray, width: int) -> np.ndarray:
    """Host-side full decode (tests): the numpy mirror of the device
    decode in ops/quantized.py and csrc/bm25.cu."""
    T = len(offsets) - 1
    P = int(offsets[-1])
    if P == 0:
        return np.zeros(0, np.int32)
    idx = np.arange(P, dtype=np.int64)
    bitpos = idx * width
    w = (bitpos >> 5).astype(np.int64)
    off = (bitpos & 31).astype(np.uint64)
    pair = (packed[w].astype(np.uint64)
            | (packed[w + 1].astype(np.uint64) << np.uint64(32)))
    mask = np.uint64((1 << width) - 1)
    deltas = ((pair >> off) & mask).astype(np.int64)
    tid_of = np.repeat(np.arange(T, dtype=np.int64), np.diff(offsets))
    return (base[tid_of].astype(np.int64) + deltas).astype(np.int32)


def quantize_postings(pf, imp: np.ndarray, mx: np.ndarray,
                      avgdl: float,
                      dtype: str | None = None) -> QuantizedPostings:
    """Build the full quantized table set for one field's postings
    (``pf`` is a ``PostingsField``) from its f32 impact table."""
    dtype = dtype or QUANTIZED_DTYPE
    qvals, scales, exact_vals, exact_offsets, stats = quantize_impacts(
        imp, mx, pf.offsets, pf.doc_ids, dtype)
    packed, base, width = pack_doc_ids(pf.doc_ids, pf.offsets)
    f32_bytes = int(pf.doc_ids.nbytes + pf.tfs.nbytes + imp.nbytes)
    qt = QuantizedPostings(
        qvals=qvals, scales=scales, exact_vals=exact_vals,
        exact_offsets=exact_offsets, packed=packed, base=base,
        width=width, dtype=dtype, avgdl=float(np.float32(avgdl)),
        stats=stats)
    qt._offsets = pf.offsets
    qt.stats.update({"width": width, "f32_bytes": f32_bytes,
                     "quant_bytes": qt.nbytes})
    return qt


_ARRAY_NAMES = ("qvals", "scales", "exact_vals", "exact_offsets", "packed",
                "base")


def quantized_arrays(qt) -> dict:
    """The numpy state of a ``QuantizedPostings`` (this package's or the
    JAX package's; attributes only): its six tables, ``width``,
    ``avgdl`` and the postings offsets it decodes against."""
    out = {name: np.asarray(getattr(qt, name)) for name in _ARRAY_NAMES}
    out["width"] = np.asarray(int(qt.width), np.int32)
    out["avgdl"] = np.asarray(qt.avgdl, np.float32)
    out["offsets"] = np.asarray(qt._offsets)
    return out


def quantized_from_arrays(arrays: dict) -> QuantizedPostings:
    """Inverse of ``quantized_arrays``; the dtype follows ``qvals``."""
    qvals = np.asarray(arrays["qvals"])
    dtype = {np.dtype(v): k for k, v in _NP_DTYPE.items()}[qvals.dtype]
    qt = QuantizedPostings(
        qvals=qvals, **{name: np.asarray(arrays[name])
                        for name in _ARRAY_NAMES[1:]},
        width=int(arrays["width"]), dtype=dtype,
        avgdl=float(arrays["avgdl"]))
    qt._offsets = np.asarray(arrays["offsets"])
    return qt
