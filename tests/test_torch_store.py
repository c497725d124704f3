"""The segment store of the PyTorch port
(``opensearch_tpu_torch/index/store.py``) and its ``.quant`` sidecars, on
the CPU.

- A segment saved by either package's ``save_segment`` loads in the
  other's ``load_segment`` with equal arrays, and the files the two write
  for the same docs hold the same bytes (the ``.npz`` the same arrays:
  its zip entries carry the time of writing).
- The store-level cases of ``tests/test_storage_faults.py`` on the port's
  store and engine: manifests, bit flips naming the file, truncation,
  legacy directories, the ``.liv`` checksum, a corrupt store refusing to
  open, wire-blob checksums, and a crash at each commit step.
- Under ``QUANTIZED_MODE = "on"`` on both codec modules: a sidecar
  written by either package opens in the other with equal tables; a
  reopened port engine serves quantized ``match`` without quantizing; a
  corrupt, stale or unwritable sidecar degrades to a rebuild.
- A searcher held across 6 refreshes with deletes answers as it did when
  it was acquired, although the 4-entry live-mask cache dropped its
  snapshot's masks (they are staged again).
- ``tools/check_durable_writes.py`` passes over the port's ``index/``.
"""

import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from opensearch_tpu.common.device_ledger import device_ledger
from opensearch_tpu.index import codec as jcodec
from opensearch_tpu.index import store as jstore
from opensearch_tpu.index.segment import SegmentWriter as JaxWriter
from opensearch_tpu.mapping.mapper import DocumentMapper as JaxMapper
from opensearch_tpu_torch.index import codec as tcodec
from opensearch_tpu_torch.index import store
from opensearch_tpu_torch.index.engine import InternalEngine
from opensearch_tpu_torch.index.segment import (SegmentWriter,
                                                segment_arrays,
                                                segment_from_arrays)
from opensearch_tpu_torch.index.store import CorruptIndexError
from opensearch_tpu_torch.index.translog import Translog
from opensearch_tpu_torch.mapping.mapper import DocumentMapper
from opensearch_tpu_torch.search.executor import ShardSearcher
from opensearch_tpu_torch.testing.parity import bm25_mismatch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

MAPPING = {"properties": {"body": {"type": "text"},
                          "n": {"type": "long"}}}
RICH_MAPPING = {"properties": {
    "body": {"type": "text"},
    "tag": {"type": "keyword"},
    "n": {"type": "long"},
    "price": {"type": "double"},
    "vec": {"type": "knn_vector", "dimension": 3},
}}


@pytest.fixture(autouse=True)
def _clean_pager_state():
    led = device_ledger()
    led.reset()
    yield
    led.reset()


def make_engine(path) -> InternalEngine:
    return InternalEngine(str(path), DocumentMapper(MAPPING), device="cpu")


def seed_engine(engine, n=6, offset=0):
    for i in range(offset, offset + n):
        engine.index(str(i), {"body": f"event t{i}", "n": i})


def committed_segment(path):
    commit = json.load(open(os.path.join(str(path), "commit.json")))
    return commit["segments"][0]


# -- one format for both packages --------------------------------------------

def rich_docs(seed: int, n: int = 40) -> list:
    rng = np.random.default_rng(seed)
    return [{"body": " ".join(f"w{int(w)}" for w in rng.zipf(
                1.5, size=int(rng.integers(1, 9))) % 30),
             "tag": ["red", "blue", "gold"][i % 3],
             "n": int(rng.integers(-50, 50)),
             "price": float(rng.random() * 10),
             "vec": rng.standard_normal(3).round(3).tolist()}
            for i in range(n)]


def both_segments(seed: int):
    """(JAX segment, port segment) built by each package's own mapper and
    writer from the same docs, with the same deletes."""
    docs = rich_docs(seed)
    jm, tm = JaxMapper(RICH_MAPPING), DocumentMapper(RICH_MAPPING)
    jseg = JaxWriter().build([jm.parse(str(i), d) for i, d in
                              enumerate(docs)], "s0",
                             vector_meta={"vec": {"dims": 3}})
    tseg = SegmentWriter().build([tm.parse(str(i), d) for i, d in
                                  enumerate(docs)], "s0",
                                 vector_meta={"vec": {"dims": 3}})
    for seg in (jseg, tseg):
        seg.apply_deletes([2, 11])
    return jseg, tseg


def npz_arrays(data: bytes) -> dict:
    z = np.load(io.BytesIO(data))
    return {k: z[k] for k in z.files}


def assert_same_segment(a, b):
    (arr_a, meta_a), (arr_b, meta_b) = segment_arrays(a), segment_arrays(b)
    assert meta_a == meta_b
    assert sorted(arr_a) == sorted(arr_b)
    for k in arr_a:
        assert arr_a[k].dtype == arr_b[k].dtype, k
        assert arr_a[k].tobytes() == arr_b[k].tobytes(), k
    for col in ("numeric_dv", "ordinal_dv"):
        assert sorted(getattr(a, col)) == sorted(getattr(b, col))
        for f, dv in getattr(a, col).items():
            other = getattr(b, col)[f]
            for k, v in vars(dv).items():
                if isinstance(v, np.ndarray):
                    assert v.tobytes() == getattr(other, k).tobytes(), k
                else:
                    assert v == getattr(other, k), k


@pytest.mark.parametrize("direction", ["port_to_reference",
                                       "reference_to_port"])
def test_segment_opens_in_the_other_package(tmp_path, direction):
    jseg, tseg = both_segments(5)
    d = str(tmp_path / "segments")
    if direction == "port_to_reference":
        store.save_segment(tseg, d)
        store.save_live(tseg, d)
        back = jstore.load_segment(d, "s0")
        assert jstore.verify_segment(d, "s0") is True
    else:
        jstore.save_segment(jseg, d)
        jstore.save_live(jseg, d)
        back = store.load_segment(d, "s0")
        assert store.verify_segment(d, "s0") is True
        assert back.quant_dir == d
    assert_same_segment(back, tseg)
    assert_same_segment(back, jseg)
    assert back.live_count() == 38


@pytest.mark.parametrize("codec", ["default", "best_compression"])
def test_segment_files_equal_the_reference(tmp_path, codec):
    jseg, tseg = both_segments(8)
    jd, td = str(tmp_path / "jax"), str(tmp_path / "torch")
    jstore.save_segment(jseg, jd, codec=codec)
    store.save_segment(tseg, td, codec=codec)
    for seg, d, mod in ((jseg, jd, jstore), (tseg, td, store)):
        mod.save_live(seg, d)
    assert sorted(os.listdir(jd)) == sorted(os.listdir(td))
    for name in sorted(os.listdir(jd)):
        a = open(os.path.join(jd, name), "rb").read()
        b = open(os.path.join(td, name), "rb").read()
        if name.endswith(".manifest"):
            a, b = json.loads(a)["files"], json.loads(b)["files"]
            a.pop("s0.npz"), b.pop("s0.npz")
        if not name.endswith(".npz"):   # zip entries carry a time
            assert a == b, name
    za = npz_arrays(open(os.path.join(jd, "s0.npz"), "rb").read())
    zb = npz_arrays(open(os.path.join(td, "s0.npz"), "rb").read())
    assert sorted(za) == sorted(zb)
    for k in za:
        assert za[k].dtype == zb[k].dtype and \
            za[k].tobytes() == zb[k].tobytes(), k
    blobs_a, blobs_b = jstore.segment_to_blobs(jseg), \
        store.segment_to_blobs(tseg)
    assert blobs_a["json"] == blobs_b["json"]
    assert blobs_a["src"] == blobs_b["src"]
    assert_same_segment(store.segment_from_blobs(blobs_a), tseg)


# -- checksummed segment commits (tests/test_storage_faults.py) ---------------

def test_save_segment_writes_manifest_and_verifies(tmp_path):
    e = make_engine(tmp_path)
    seed_engine(e)
    e.flush()
    e.close()
    seg_dir = str(tmp_path / "segments")
    sid = committed_segment(tmp_path)
    m = store.read_segment_manifest(seg_dir, sid)
    assert set(m["files"]) == {sid + ".json", sid + ".npz", sid + ".src"}
    for entry in m["files"].values():
        assert entry["length"] > 0 and "crc32" in entry
    assert store.verify_segment(seg_dir, sid) is True


@pytest.mark.parametrize("suffix", [".json", ".npz", ".src"])
def test_bit_flip_detected_and_names_file(tmp_path, suffix):
    e = make_engine(tmp_path)
    seed_engine(e)
    e.flush()
    e.close()
    seg_dir = str(tmp_path / "segments")
    sid = committed_segment(tmp_path)
    p = os.path.join(seg_dir, sid + suffix)
    data = bytearray(open(p, "rb").read())
    data[len(data) // 2] ^= 0xFF
    open(p, "wb").write(bytes(data))
    with pytest.raises(CorruptIndexError, match=sid + suffix.replace(
            ".", r"\.")):
        store.load_segment(seg_dir, sid)
    with pytest.raises(CorruptIndexError):
        store.verify_segment(seg_dir, sid)


def test_truncation_detected(tmp_path):
    e = make_engine(tmp_path)
    seed_engine(e)
    e.flush()
    e.close()
    seg_dir = str(tmp_path / "segments")
    sid = committed_segment(tmp_path)
    p = os.path.join(seg_dir, sid + ".npz")
    data = open(p, "rb").read()
    open(p, "wb").write(data[: len(data) // 2])
    with pytest.raises(CorruptIndexError, match="length mismatch"):
        store.load_segment(seg_dir, sid)


def test_legacy_directory_without_manifest_still_loads(tmp_path):
    e = make_engine(tmp_path)
    seed_engine(e)
    e.flush()
    e.close()
    seg_dir = str(tmp_path / "segments")
    sid = committed_segment(tmp_path)
    os.remove(os.path.join(seg_dir, sid + store.MANIFEST_SUFFIX))
    # pre-manifest stores load (unverifiable) instead of refusing
    seg = store.load_segment(seg_dir, sid)
    assert seg.n_docs == 6
    assert store.verify_segment(seg_dir, sid) is False


def test_liv_sidecar_self_checksum(tmp_path):
    e = make_engine(tmp_path)
    seed_engine(e)
    e.flush()
    e.delete("2")
    e.flush()                              # save_live rewrite
    e.close()
    seg_dir = str(tmp_path / "segments")
    sid = committed_segment(tmp_path)
    p = os.path.join(seg_dir, sid + ".liv")
    assert os.path.exists(p)
    seg = store.load_segment(seg_dir, sid)
    assert seg.live_count() == 5
    data = bytearray(open(p, "rb").read())
    data[-1] ^= 0xFF
    open(p, "wb").write(bytes(data))
    with pytest.raises(CorruptIndexError, match=r"\.liv"):
        store.load_segment(seg_dir, sid)


def test_corrupt_store_refuses_to_open_and_serves_nothing(tmp_path):
    e = make_engine(tmp_path)
    seed_engine(e)
    e.flush()
    e.close()
    seg_dir = str(tmp_path / "segments")
    sid = committed_segment(tmp_path)
    p = os.path.join(seg_dir, sid + ".src")
    data = bytearray(open(p, "rb").read())
    data[0] ^= 0xFF
    open(p, "wb").write(bytes(data))
    e2 = make_engine(tmp_path)
    assert e2.corruption is not None
    # the verdict persisted as a corrupted_<seg> marker
    markers = store.find_corruption_markers(seg_dir)
    assert markers and markers[0]["segment"] == sid
    with pytest.raises(CorruptIndexError):
        e2.get("1")
    with pytest.raises(CorruptIndexError):
        e2.index("x", {"body": "y", "n": 1})
    with pytest.raises(CorruptIndexError):
        e2.acquire_searcher()
    e2.close()
    # marker alone (even with the file healed) blocks reopen until the
    # copy is dropped — Store.failIfCorrupted
    data[0] ^= 0xFF
    open(p, "wb").write(bytes(data))
    e3 = make_engine(tmp_path)
    assert e3.corruption is not None
    e3.close()
    store.clear_corruption_markers(seg_dir)
    e4 = make_engine(tmp_path)
    assert e4.corruption is None and e4.doc_count() == 6
    e4.close()


def test_wire_blob_checksums_detect_inflight_damage(tmp_path):
    e = make_engine(tmp_path)
    seed_engine(e)
    e.refresh()
    blobs = store.segment_to_blobs(e.segments[0])
    assert set(blobs["checksums"]) == {"json", "npz", "src"}
    roundtrip = store.segment_from_blobs(blobs)
    assert roundtrip.n_docs == 6
    damaged = dict(blobs)
    b = bytearray(damaged["npz"])
    b[len(b) // 3] ^= 0xFF
    damaged["npz"] = bytes(b)
    with pytest.raises(CorruptIndexError, match="npz"):
        store.segment_from_blobs(damaged)
    e.close()


class _Killed(Exception):
    pass


class _ReplaceKiller:
    """Raise on the k-th os.replace whose destination lives under
    ``within`` — the deterministic 'kill -9 between commit steps'."""

    def __init__(self, k: int, within: str):
        self.k = k
        self.within = str(within)
        self.calls = 0
        self._real = os.replace

    def __enter__(self):
        def fake(src, dst):
            if str(dst).startswith(self.within):
                if self.calls == self.k:
                    self.calls += 1
                    raise _Killed(f"killed at replace #{self.k}: {dst}")
                self.calls += 1
            return self._real(src, dst)
        os.replace = fake
        return self

    def __exit__(self, *exc):
        os.replace = self._real
        return False


def test_crash_at_every_segment_commit_step_never_mixes(tmp_path):
    """Kill between EACH rename of the segment-commit sequence: reopen
    must see a loadable commit (complete old or complete new segment
    set) and recover every acked doc via the translog."""
    root = tmp_path / "shard"
    e = make_engine(root)
    seed_engine(e, 4)                      # docs 0-3
    e.flush()                              # committed baseline
    e.close()

    k = 0
    while True:
        e = make_engine(root)
        seed_engine(e, 3, offset=100 + 10 * k)   # fresh uncommitted docs
        new_ids = {str(100 + 10 * k + j) for j in range(3)}
        killed = False
        with _ReplaceKiller(k, str(root)) as killer:
            try:
                e.flush()
            except _Killed:
                killed = True
        e.close()
        e2 = make_engine(root)
        assert e2.corruption is None, f"crash point {k} corrupted store"
        have = set()
        for seg in e2.segments:
            have.update(seg.doc_ids)
        have.update(d for d, entry in e2._version_map.items()
                    if not entry.deleted)
        assert set(map(str, range(4))) <= have, \
            f"crash point {k} lost committed docs"
        assert new_ids <= have, f"crash point {k} lost acked (translog) docs"
        e2.verify_store()                  # checksums hold at every point
        e2.flush()                         # leave a clean commit behind
        e2.close()
        if not killed:
            assert killer.calls >= 1
            break
        k += 1
    assert k >= 4        # 3 data files + manifest + translog ckp + commit


def test_crash_at_translog_roll_and_checkpoint_replace(tmp_path):
    root = tmp_path / "tl"
    k = 0
    while True:
        tl = Translog(str(root / f"case{k}"))
        for i in range(3):
            tl.add({"op": "index", "id": str(i), "source": {"n": i},
                    "seq_no": i, "version": 1})
        tl.sync()                          # acked high-water mark
        killed = False
        with _ReplaceKiller(k, str(root / f"case{k}")) as killer:
            try:
                tl.roll_generation()
                tl.add({"op": "index", "id": "9", "source": {"n": 9},
                        "seq_no": 3, "version": 1})
                tl.sync()
            except _Killed:
                killed = True
        tl._file.close()
        tl2 = Translog(str(root / f"case{k}"))
        acked = {op["id"] for op in tl2.read_ops()}
        assert {"0", "1", "2"} <= acked, f"crash point {k} lost acked ops"
        tl2.close()
        if not killed:
            assert killer.calls >= 1
            break
        k += 1
    assert k >= 2


# -- the .quant sidecars ------------------------------------------------------

def set_lowering(monkeypatch, mode="on", dtype="int8"):
    for mod in (jcodec, tcodec):
        monkeypatch.setattr(mod, "QUANTIZED_MODE", mode)
        monkeypatch.setattr(mod, "QUANTIZED_DTYPE", dtype)


def count_quantize(monkeypatch) -> list:
    """Counts the port's ``quantize_postings`` calls (one entry each)."""
    calls = []
    real = tcodec.quantize_postings

    def counted(*args, **kw):
        calls.append(1)
        return real(*args, **kw)

    monkeypatch.setattr(tcodec, "quantize_postings", counted)
    return calls


def same_tables(a, b):
    for name in ("qvals", "scales", "exact_vals", "exact_offsets", "packed",
                 "base"):
        x, y = getattr(a, name), getattr(b, name)
        assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), name
    assert (a.width, a.dtype, a.avgdl, a.stats) == \
        (b.width, b.dtype, b.avgdl, b.stats)


def body_avgdl(seg) -> float:
    pf = seg.postings["body"]
    return pf.total_len / pf.docs_with_field


@pytest.mark.parametrize("dtype", ["int8", "int16"])
@pytest.mark.parametrize("direction", ["port_to_reference",
                                       "reference_to_port"])
def test_quant_sidecar_opens_in_the_other_package(tmp_path, monkeypatch,
                                                  dtype, direction):
    set_lowering(monkeypatch, dtype=dtype)
    jseg, tseg = both_segments(13)
    d = str(tmp_path / "segments")
    avgdl = body_avgdl(tseg)
    if direction == "port_to_reference":
        store.save_segment(tseg, d)
        mine = tseg.quantized_table("body", avgdl)     # writes the sidecar
        got = jstore.load_quantized_tables(d, "s0", "body", avgdl=avgdl)
        ref = jseg.quantized_table("body", avgdl)
    else:
        jstore.save_segment(jseg, d)
        ref = jseg.quantized_table("body", avgdl)
        got = store.load_quantized_tables(d, "s0", "body", avgdl=avgdl)
        mine = tseg.quantized_table("body", avgdl)
    assert os.path.exists(os.path.join(d, store.quant_sidecar_name(
        "s0", "body")))
    assert got is not None
    same_tables(got, mine)
    same_tables(got, ref)
    assert got.dtype == dtype


def quant_engine(path, n=120, seed=3):
    eng = InternalEngine(str(path), DocumentMapper(MAPPING), device="cpu")
    rng = np.random.default_rng(seed)
    for i in range(n):
        words = rng.zipf(1.3, size=int(rng.integers(3, 15))) % 50
        eng.index(str(i), {"body": " ".join(f"w{int(w)}" for w in words),
                           "n": i})
        if i % 50 == 49:
            eng.refresh()
    return eng


MATCHES = [{"query": {"match": {"body": "w0 w3"}}, "size": 10},
           {"query": {"match": {"body": "w1 w7 w20"}}, "size": 5},
           {"query": {"term": {"body": "w2"}}, "size": 20}]


def test_reopened_engine_serves_from_sidecars(tmp_path, monkeypatch):
    set_lowering(monkeypatch)
    eng = quant_engine(tmp_path)
    eng.flush()
    eng.close()
    eng = make_engine(tmp_path)
    calls = count_quantize(monkeypatch)
    first = [eng.acquire_searcher().search(b) for b in MATCHES]
    n_segs = len(eng.segments)
    assert n_segs == 3 and len(calls) == n_segs      # built, written
    assert all(seg.device("cpu").quantized_mode for seg in eng.segments)
    eng.close()
    eng = make_engine(tmp_path)
    calls.clear()
    again = [eng.acquire_searcher().search(b) for b in MATCHES]
    assert calls == []                               # read back
    for a, b in zip(first, again):
        assert bm25_mismatch(a, b) is None
    eng.close()


def test_reopen_keeps_sidecars_and_drops_strays(tmp_path, monkeypatch):
    """Recovery deletes the files of segments the commit does not name
    and unfinished temp files, and keeps a named segment's sidecars."""
    set_lowering(monkeypatch)
    eng = quant_engine(tmp_path, n=60)
    eng.flush()
    eng.acquire_searcher().search(MATCHES[0])      # writes the sidecars
    eng.close()
    seg_dir = tmp_path / "segments"
    sid = committed_segment(tmp_path)
    strays = ["seg_gone_7.npz", "seg_gone_7.body.quant", sid + ".json.tmp"]
    for name in strays:
        (seg_dir / name).write_bytes(b"x")
    kept = sorted(n for n in os.listdir(seg_dir) if n not in strays)
    assert sid + ".body.quant" in kept
    make_engine(tmp_path).close()
    assert sorted(os.listdir(seg_dir)) == kept


@pytest.mark.parametrize("fault", ["corrupt", "stale", "unwritable"])
def test_bad_sidecar_degrades_to_a_rebuild(tmp_path, monkeypatch, fault):
    set_lowering(monkeypatch)
    eng = quant_engine(tmp_path, n=60)
    eng.flush()
    expect = [eng.acquire_searcher().search(b) for b in MATCHES]
    eng.close()
    eng = make_engine(tmp_path)
    [eng.acquire_searcher().search(b) for b in MATCHES]   # sidecars written
    eng.close()
    seg_dir = str(tmp_path / "segments")
    sid = committed_segment(tmp_path)
    path = os.path.join(seg_dir, store.quant_sidecar_name(sid, "body"))
    if fault == "corrupt":
        data = bytearray(open(path, "rb").read())
        data[len(data) // 2] ^= 0xFF
        open(path, "wb").write(bytes(data))
        with pytest.raises(CorruptIndexError, match=r"\.quant"):
            store.load_quantized_tables(seg_dir, sid, "body")
    elif fault == "unwritable":
        os.remove(path)

        def refuse(*args, **kw):
            raise OSError("read-only file system")
        monkeypatch.setattr(store, "save_quantized_tables", refuse)
    eng = make_engine(tmp_path)
    calls = count_quantize(monkeypatch)
    if fault == "stale":
        eng.index("new", {"body": "w0 w0 w0 w0 w0 w0 w0 w0 w3", "n": 0})
        eng.refresh()                    # the shard's avgdl moves
        avgdl = eng.acquire_searcher().ctx.field_stats("body").avgdl
        assert store.load_quantized_tables(seg_dir, sid, "body",
                                           avgdl=avgdl) is None
    got = [eng.acquire_searcher().search(b) for b in MATCHES]
    assert len(calls) >= 1
    if fault != "stale":
        for a, b in zip(expect, got):
            assert bm25_mismatch(a, b) is None
    if fault == "unwritable":
        assert not os.path.exists(path)
    else:
        avgdl = eng.acquire_searcher().ctx.field_stats("body").avgdl
        back = store.load_quantized_tables(seg_dir, sid, "body", avgdl=avgdl)
        seg = next(s for s in eng.segments if s.seg_id == sid)
        same_tables(back, seg.quantized_table("body", avgdl))
    # copies of the segments without a store quantize afresh: the same
    fresh = ShardSearcher([segment_from_arrays(*segment_arrays(s))
                           for s in eng.segments],
                          DocumentMapper(MAPPING), device="cpu")
    for body, resp in zip(MATCHES, got):
        assert bm25_mismatch(fresh.search(body), resp) is None
    eng.close()


# -- point-in-time searchers --------------------------------------------------

def test_searcher_held_across_six_refreshes_keeps_its_snapshot(tmp_path):
    """Each refresh with deletes gives the first segments a new live
    bitmap; once six newer snapshots were staged, the held searcher's
    masks are gone from the 4-entry cache and are staged again, from its
    own bitmaps, never another snapshot's."""
    eng = InternalEngine(str(tmp_path), DocumentMapper(MAPPING),
                         device="cpu")
    seed_engine(eng, 80)
    eng.refresh()
    seed_engine(eng, 60, offset=80)
    eng.refresh()
    held = eng.acquire_searcher()
    frozen = ShardSearcher([segment_from_arrays(*segment_arrays(s))
                            for s in eng.segments],
                           DocumentMapper(MAPPING), device="cpu")
    bodies = [{"query": {"match": {"body": "event"}}, "size": 200},
              {"query": {"match": {"body": "t3 t70 t99"}}, "size": 10},
              {"query": {"bool": {"must": [{"match": {"body": "event"}}],
                                  "filter": [{"term": {"body": "t5"}}]}}}]
    before = [held.search(b) for b in bodies[:2]]
    rng = np.random.default_rng(0)
    live = 140
    for r in range(6):
        for doc in rng.choice(140, size=7, replace=False):
            live -= eng.delete(str(doc)).result == "deleted"
        seed_engine(eng, 5, offset=1000 + 10 * r)
        live += 5
        eng.refresh()
        eng.acquire_searcher().search(bodies[0])   # stages the new masks
    dseg = held.segments[0].device("cpu")
    assert len(dseg._live_cache) == 4
    assert id(held.ctx.lives[id(held.segments[0])]) not in dseg._live_cache
    for body, resp in zip(bodies, before):
        assert bm25_mismatch(held.search(body), resp) is None
    for body in bodies:
        assert bm25_mismatch(held.search(body), frozen.search(body)) is None
        assert held.count(body["query"]) == frozen.count(body["query"])
    assert held.search(bodies[0])["hits"]["total"]["value"] == 140
    assert live < 140 + 30 - 30
    assert eng.acquire_searcher().search(bodies[0])["hits"]["total"][
        "value"] == live
    eng.close()


def test_durable_writes_lint_passes_over_the_port():
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", "check_durable_writes.py"),
         os.path.join(REPO, "opensearch_tpu_torch", "index")],
        capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
