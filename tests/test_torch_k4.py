"""K4's staging arithmetic on the CPU: what ``csrc/quant_topk.cu`` copies
of a run of postings into shared memory, and how it decodes them there.

A numpy model of the kernel's ``window_of`` and of its scatter's decode
(packed words from a window whose start is rounded down to 16 bytes and
whose length is a whole number of 16 bytes; the delta of posting p by a
funnel shift of two neighbouring words of the window; the code or the
exact impact from the value window) is held, byte for byte, against the
codec's own decode (``codec.unpack_doc_ids``) and impacts
(``QuantizedPostings.dequantized()``) at every width from 1 to 31, for
int8 and int16 codes, on runs of length 0, 1, a tile and a whole row and
on runs that touch the first and the last word of ``packed``, ``qvals``
and ``exact_vals``.  Another test pins the padding the copies rely on:
no window ever reaches past a column as ``DeviceSegment.quantized``
stages it.  The kernel itself runs only on the card (``chip_smoke.py``
phase 2, ``testing/k4_sweep.py``).  Tolerance 0.
"""

import numpy as np
import pytest
import torch

from opensearch_tpu_torch.index import codec
from opensearch_tpu_torch.index.segment import (DeviceSegment, SegmentWriter,
                                                _pad1, _pad16)
from opensearch_tpu_torch.mapping.mapper import DocumentMapper
from opensearch_tpu_torch.ops import cuda_bm25, cuda_build
from opensearch_tpu_torch.testing import k4_sweep

TILE = cuda_bm25.TILE_DOCS
WIN_WORDS = TILE * 31 // 32 + 16     # quant_topk.cu's kWinWords
VAL_BYTES = TILE * 4 + 32            # ... kValBytes
THREADS = 256                        # ... kThreads


# -- the model ------------------------------------------------------------------

def word_of(p: int, width: int) -> int:
    return (p >> 5) * width + (((p & 31) * width) >> 5)


def window(lo: int, hi: int, width: int, size: int, first: int):
    """``window_of``: ``(word0, words, val0, vbytes)`` of a run [lo, hi)
    whose first value is element ``first`` of a column of ``size``-byte
    values."""
    last = word_of(hi, width) - (1 if ((hi & 31) * width) & 31 == 0 else 0)
    word0 = word_of(lo, width) & ~3
    words = ((last + 2 + 3) & ~3) - word0
    per16 = 16 // size
    end = first + (hi - lo)
    val0 = first & ~(per16 - 1)
    vbytes = (((end + per16 - 1) & ~(per16 - 1)) - val0) * size
    return word0, words, val0, vbytes


def stage_and_decode(staged: dict, qt, row: int, lo: int, hi: int):
    """The kernel's copies of the run [lo, hi) (absolute posting indices)
    of row ``row`` out of the staged columns, then its decode: (docs
    int32, impacts float32).  Asserts that both windows lie inside their
    columns and fit a stage buffer."""
    width = int(qt.width)
    start = int(qt._offsets[row])
    e0, e1 = int(qt.exact_offsets[row]), int(qt.exact_offsets[row + 1])
    exact = e1 > e0
    column = staged["exact_vals"] if exact else staged["qvals"]
    size = column.itemsize
    exact0 = e0 - start
    first = exact0 + lo if exact else lo
    word0, words, val0, vbytes = window(lo, hi, width, size, first)
    assert word0 % 4 == 0 and words % 4 == 0 and vbytes % 16 == 0
    assert (val0 * size) % 16 == 0
    assert (word0 + words) * 4 <= staged["packed"].nbytes
    assert val0 * size + vbytes <= column.nbytes
    assert words <= WIN_WORDS and vbytes <= VAL_BYTES or hi - lo > TILE
    win = staged["packed"].view(np.uint32)[word0: word0 + words]
    vals = column.view(np.uint8)[val0 * size: val0 * size + vbytes].view(
        column.dtype)
    # thread t takes postings lo + t, lo + t + THREADS, ...: one bit offset
    # in the word, the word index stepping by THREADS / 32 * width
    p = np.arange(lo, hi, dtype=np.int64)
    first_p = lo + (p - lo) % THREADS
    bit = (first_p & 31) * width
    i = ((first_p >> 5) * width + (bit >> 5) - word0
         + (p - first_p) // THREADS * (THREADS // 32 * width))
    pair = (win[i].astype(np.uint64)
            | (win[i + 1].astype(np.uint64) << np.uint64(32)))
    funnel = (pair >> (bit & 31).astype(np.uint64)) & np.uint64(0xFFFFFFFF)
    delta = (funnel & np.uint64((1 << width) - 1)).astype(np.int64)
    docs = (int(qt.base[row]) + delta).astype(np.int32)
    v = vals[(exact0 + p if exact else p) - val0]
    imp = v if exact else v.astype(np.float32) * qt.scales[row]
    return docs, imp


def staged_columns(qt) -> dict:
    """``packed``, ``qvals`` and ``exact_vals`` padded as
    ``DeviceSegment.quantized`` stages them."""
    return {name: _pad1(getattr(qt, name), _pad16(getattr(qt, name)), 0)
            for name in ("packed", "qvals", "exact_vals")}


# -- synthetic rows at each width ------------------------------------------------

def synthetic_table(width: int, dtype: str, seed: int):
    """A quantized table whose widest delta takes ``width`` bits, rows:
    a short unguarded row (first in ``qvals`` and ``packed``), a row the
    parity guard keeps exact (first in ``exact_vals``), a long unguarded
    row, a second exact row (last in ``exact_vals``) and a short unguarded
    row (last in ``qvals`` and ``packed``)."""
    rng = np.random.default_rng(seed)
    top = (1 << width) - 1
    near = {"int8": 0.501, "int16": 0.50001}[dtype]

    def falling(lo, hi, n):
        # impacts that fall as the doc id rises rank alike quantized or
        # not (ties go to the lower doc either way): the guard keeps the
        # row quantized
        return np.sort(rng.uniform(lo, hi, n))[::-1]

    def spread(n):
        if top + 1 <= n:
            return np.arange(top + 1)
        mid = (rng.choice(np.arange(1, top), size=n - 2, replace=False)
               if top < 1 << 16 else rng.integers(1, top, size=n - 2))
        return np.unique(np.concatenate([[0, top], mid]))

    long_n = min(top + 1, 700)
    rows = [(spread(min(top + 1, 5)), falling(0.1, 2.0, 5)),
            (np.array([0, 1, min(2, top)])[: 3 if top >= 2 else 2],
             np.array([0.5, near, 1.0])[: 3 if top >= 2 else 2]),
            (spread(long_n), falling(0.1, 4.0, long_n)),
            (np.array([0, 1, min(3, top)])[: 3 if top >= 2 else 2],
             np.array([1.5, 1.5 * near / 0.5, 3.0])[: 3 if top >= 2 else 2]),
            (spread(min(top + 1, 3)), falling(0.1, 2.0, 3))]
    doc_ids, imps, lens = [], [], []
    for r, (deltas, imp) in enumerate(rows):
        n = min(len(deltas), len(imp))
        doc_ids.append(min(r * 7, 2**31 - 1 - int(deltas[n - 1])) + deltas[:n])
        imps.append(imp[:n])
        lens.append(n)
    offsets = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
    doc_ids = np.concatenate(doc_ids).astype(np.int32)
    imp = np.concatenate(imps).astype(np.float32)
    mx = np.array([imp[a:b].max() for a, b in zip(offsets[:-1],
                                                   offsets[1:])], np.float32)
    qvals, scales, exact_vals, exact_offsets, _st = codec.quantize_impacts(
        imp, mx, offsets, doc_ids, dtype)
    packed, base, w = codec.pack_doc_ids(doc_ids, offsets)
    assert w == width
    qt = codec.QuantizedPostings(qvals=qvals, scales=scales,
                                 exact_vals=exact_vals,
                                 exact_offsets=exact_offsets, packed=packed,
                                 base=base, width=w, dtype=dtype)
    qt._offsets = offsets
    return qt


def runs_of(qt, row: int, rng) -> list:
    """Runs [lo, hi) of a row to stage: empty ones, length 1 at both ends,
    a tile's worth of docs, the whole row and random sub-runs."""
    a, b = int(qt._offsets[row]), int(qt._offsets[row + 1])
    runs = [(a, a), (b, b), (a, a + 1), (b - 1, b), (a, b)]
    if b - a > 2:
        lo = int(rng.integers(a, b - 1))
        runs += [(lo, int(rng.integers(lo + 1, b + 1))) for _ in range(6)]
    return runs


@pytest.mark.parametrize("dtype", ["int8", "int16"])
@pytest.mark.parametrize("width", range(1, 32))
def test_staged_windows_decode_like_the_codec(width, dtype):
    qt = synthetic_table(width, dtype, seed=width)
    staged = staged_columns(qt)
    ids = codec.unpack_doc_ids(qt.packed, qt.base, qt._offsets, width)
    deq = qt.dequantized()
    rng = np.random.default_rng(100 + width)
    exact_rows = np.flatnonzero(np.diff(qt.exact_offsets) > 0)
    assert list(exact_rows) == ([1, 3] if width >= 2 else [])
    P = int(qt._offsets[-1])
    touched = set()
    for row in range(len(qt._offsets) - 1):
        for lo, hi in runs_of(qt, row, rng):
            if lo >= hi:      # an empty run is never copied
                continue
            docs, imp = stage_and_decode(staged, qt, row, lo, hi)
            assert docs.tobytes() == ids[lo:hi].tobytes()
            assert imp.tobytes() == deq[lo:hi].tobytes()
            if lo == 0:
                touched.add("packed first")
            if word_of(hi, width) >= len(qt.packed) - 2:
                touched.add("packed last")
            if row not in exact_rows:
                touched |= {"qvals first"} if lo == 0 else set()
                touched |= {"qvals last"} if hi == P else set()
            else:
                e = int(qt.exact_offsets[row]) - int(qt._offsets[row])
                touched |= {"exact first"} if e + lo == 0 else set()
                touched |= ({"exact last"} if e + hi == len(qt.exact_vals)
                            else set())
    want = {"packed first", "packed last", "qvals first", "qvals last"}
    if width >= 2:
        want |= {"exact first", "exact last"}
    assert want <= touched


@pytest.mark.parametrize("width", [17, 31])
def test_a_tile_of_postings_fits_one_stage_buffer(width):
    """A run of ``TILE`` postings (a tile's docs, each once in a row) at
    any alignment fits the stage buffer: its packed words with the guard
    word and the slack, its values as exact f32 with theirs."""
    for lo in range(0, 64, 3):
        hi = lo + TILE
        word0, words, val0, vbytes = window(lo, hi, width, 4, lo + 5)
        assert words <= WIN_WORDS and vbytes <= VAL_BYTES
        word0, words, val0, vbytes = window(lo, hi, width, 1, lo)
        assert words <= WIN_WORDS and vbytes <= VAL_BYTES


# -- the padding the copies rely on ---------------------------------------------

def tiny_segments(monkeypatch, dtype):
    monkeypatch.setattr(codec, "QUANTIZED_MODE", "on")
    monkeypatch.setattr(codec, "QUANTIZED_DTYPE", dtype)
    mapper = DocumentMapper({"properties": {"body": {"type": "text"}}})
    rng = np.random.default_rng(7)
    writer = SegmentWriter()
    out = []
    for n_docs in (1, 2, 3, 9, 40):
        docs = [mapper.parse(str(i), {"body": " ".join(
            f"w{t}" for t in rng.integers(0, 6, size=int(rng.integers(1, 4))))})
            for i in range(n_docs)]
        out.append(writer.build(docs, f"tiny{n_docs}"))
    return out


@pytest.mark.parametrize("dtype", ["int8", "int16"])
def test_no_window_reaches_past_a_staged_column(dtype, monkeypatch):
    """Every column K4 copies spans whole 16-byte units as
    ``DeviceSegment.quantized`` stages it, so every run of every row (all
    of them, on segments of 1 to 40 docs, where the padding is least)
    stays inside its columns, and the wrapper's check passes."""
    for seg in tiny_segments(monkeypatch, dtype):
        dseg = DeviceSegment(seg, "cpu")
        assert dseg.quantized_mode
        q = dseg.quantized("body", 2.0)
        qt = seg.quantized_table("body", 2.0)
        staged = {name: q[name].numpy() for name in ("packed", "qvals",
                                                     "exact_vals")}
        for name, t in staged.items():
            assert t.nbytes % cuda_bm25.STAGE_ALIGN == 0, name
            cuda_bm25._check_staged(q[name], name)
        ids = codec.unpack_doc_ids(qt.packed, qt.base, qt._offsets,
                                   qt.width)
        deq = qt.dequantized()
        for row in range(len(qt._offsets) - 1):
            a, b = int(qt._offsets[row]), int(qt._offsets[row + 1])
            for lo in range(a, b):
                for hi in range(lo + 1, b + 1):
                    docs, imp = stage_and_decode(staged, qt, row, lo, hi)
                    assert docs.tobytes() == ids[lo:hi].tobytes()
                    assert imp.tobytes() == deq[lo:hi].tobytes()


def test_k4_refuses_columns_it_cannot_copy_whole():
    """A column that does not span whole 16-byte units (a view cut from
    a padded one) is refused before any launch."""
    padded = torch.zeros(32, dtype=torch.int8)
    cuda_bm25._check_staged(padded, "qvals")
    with pytest.raises(ValueError, match="16-byte"):
        cuda_bm25._check_staged(padded[:24], "qvals")
    with pytest.raises(ValueError, match="16-byte"):
        cuda_bm25._check_staged(padded[8:], "qvals")


# -- the launch table and the build ----------------------------------------------

def quant_table(n_pads):
    """A quantized ``launch_table`` of three segments, the second with no
    active slot (its tiles are launched all the same)."""
    return cuda_bm25.launch_table(
        [(1, 2, 3)] * 3, n_pads, [1, 0, 2], np.arange(6).reshape(3, 2),
        np.ones(3, np.float32), np.ones(3, np.float32), [1, 1, 1],
        [True] * 3, quant=(np.arange(6).reshape(3, 2),
                           np.arange(6).reshape(3, 2)))


def test_k4_tiles_its_segments_by_its_own_tile_size():
    """K4's table is tiled at ``TILE_DOCS``, the size its library is built
    with, and a segment without an active slot still gets its tiles."""
    n_pads = [131_072, 8, TILE + 1]
    table, n_blocks, n_slots = quant_table(n_pads)
    assert cuda_bm25.quant_defines()["QUANT_TILE_DOCS"] == TILE
    tiles = [cuda_bm25.n_tiles(n) for n in n_pads]
    assert tiles == [131_072 // TILE, 1, 2] and n_blocks == sum(tiles)
    head = table[: 3 * cuda_bm25.QSEG_WORDS].reshape(3, -1)
    assert list(head[:, 4]) == [0, tiles[0], tiles[0] + 1]
    assert list(head[:, 5]) == tiles
    work = table[3 * cuda_bm25.QSEG_WORDS + cuda_bm25.QSLOT_WORDS * n_slots:
                 ][:n_blocks]
    assert list(work >> 32) == [0] * tiles[0] + [1, 2, 2]
    assert list(work & 0xFFFFFFFF) == list(range(tiles[0])) + [0, 0, 1]


@pytest.mark.parametrize("tile", k4_sweep.TILES)
def test_sweep_lays_out_the_table_at_each_candidate_tile(tile, monkeypatch):
    """``k4_sweep.retile`` gives the table ``launch_table`` would build at
    tiles of ``tile`` docs, the slots untouched."""
    n_pads = [131_072, 8, 3 * tile + 1]
    table, _blocks, n_slots = quant_table(n_pads)
    got, n_blocks = k4_sweep.retile(table, 3, n_slots, tile)
    monkeypatch.setattr(cuda_bm25, "TILE_DOCS", tile)
    want, want_blocks, _slots = quant_table(n_pads)
    assert n_blocks == want_blocks and got.tobytes() == want.tobytes()


def test_k4_layout_constants_reach_the_kernel_as_macros():
    assert cuda_bm25.quant_defines() == {
        "QUANT_TILE_DOCS": cuda_bm25.TILE_DOCS,
        "QUANT_K_MAX": cuda_bm25.K_MAX,
        "QUANT_SEG_WORDS": cuda_bm25.QSEG_WORDS,
        "QUANT_SLOT_WORDS": cuda_bm25.QSLOT_WORDS}
    src = (cuda_build.CSRC / "quant_topk.cu").read_text()
    for macro in cuda_bm25.quant_defines():
        assert f"= {macro};" in src
    for header in ('#include "topk.cuh"', '#include "phases.cuh"'):
        assert header in src
    base = cuda_build.library_path("quant_topk", cuda_bm25.quant_defines())
    assert base != cuda_build.library_path("quant_topk",
                                           k4_sweep.k4_defines(2048))
    assert base == cuda_build.library_path("quant_topk",
                                           k4_sweep.k4_defines(TILE))


# -- the row searches -------------------------------------------------------------

def lower_bound(docs, lo, hi, target):
    """``warp_lower_bound``, lane by lane: ``(first p in [lo, hi) with
    docs[p] >= target else hi, dependent probe rounds)``."""
    rounds = 0
    while hi - lo > 32:
        step = (hi - lo + 31) // 32
        ge = [p >= hi or docs[p] >= target
              for p in (lo + (lane + 1) * step - 1 for lane in range(32))]
        rounds += 1
        if not any(ge):
            return hi, rounds
        f = ge.index(True)
        hi = min(hi, lo + (f + 1) * step - 1)
        lo += f * step
    ge = [lo + lane >= hi or docs[lo + lane] >= target for lane in range(32)]
    rounds += 1
    return (hi if not any(ge) else min(hi, lo + ge.index(True))), rounds


@pytest.mark.parametrize("n,n_pad,max_rounds", [
    (40, 64, 2), (1_000, 4_096, 2), (20_000, 131_072, 3),
    (124_000, 131_072, 4)])
def test_row_searches_find_each_tile_boundary(n, n_pad, max_rounds):
    """A warp finds where a row enters and leaves a tile, 32 evenly spaced
    ids a round: every answer equals ``searchsorted``, from any start, in
    about log32(n) + 1 dependent rounds (4 at 124,000 postings where 16
    lanes took 5)."""
    rng = np.random.default_rng(n)
    docs = np.sort(rng.choice(n_pad - 7, size=n, replace=False)) + 7
    targets = sorted({0, int(docs[0]), int(docs[-1]), int(docs[-1]) + 1,
                      n_pad, *range(0, n_pad + 1, TILE),
                      *rng.integers(0, n_pad + 1, 40).tolist()})
    for target in targets:
        want = int(np.searchsorted(docs, target, "left"))
        got, rounds = lower_bound(docs, 0, n, target)
        assert got == want, target
        assert rounds <= max_rounds, (target, rounds)
        lo = int(rng.integers(0, n))
        assert lower_bound(docs, lo, n, target)[0] == max(want, lo)
