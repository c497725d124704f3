"""The write path of the PyTorch port
(``opensearch_tpu_torch/index/engine.py`` and its translog) on the CPU.

Two parts:

- one seeded op sequence through the JAX package's ``InternalEngine`` and
  the port's ``InternalEngine(device="cpu")`` in two directories: index,
  update, delete, stale ``if_seq_no`` / ``if_primary_term``, external
  versions, refresh, flush, ``force_merge``, close and reopen, and a kill
  (the engine dropped without ``close``) followed by translog replay.
  Every op's result (or error type), realtime ``get``, ``doc_count``,
  ``max_seq_no``, ``checkpoint_info``, ``replication_digest`` and, after
  every lifecycle step, ``search`` / ``count`` (``match``, ``bool``,
  ``term``) must be equal; BM25 byte for byte, with the reference's
  device scoring path (``HOST_SCORING`` off, as ``tests/test_impacts.py``
  runs it);
- the cases of ``tests/test_engine.py`` run on the port's engine, the
  torn-tail and the corrupt-acked-record cases each as one parametrised
  test.
"""

import gc
import re
import weakref

import numpy as np
import pytest
import torch

from opensearch_tpu.common.device_ledger import device_ledger
from opensearch_tpu.index.engine import InternalEngine as JaxEngine
from opensearch_tpu.mapping.mapper import DocumentMapper as JaxMapper
from opensearch_tpu.ops import bm25 as jbm25
from opensearch_tpu_torch.common.errors import VersionConflictError
from opensearch_tpu_torch.common.torchenv import DeviceUnavailableError
from opensearch_tpu_torch.index.engine import InternalEngine
from opensearch_tpu_torch.index.translog import (Translog,
                                                 TranslogCorruptedError)
from opensearch_tpu_torch.mapping.mapper import DocumentMapper
from opensearch_tpu_torch.testing.parity import bm25_mismatch

MAPPING = {"properties": {
    "title": {"type": "text"},
    "n": {"type": "long"},
    "tag": {"type": "keyword"},
}}


@pytest.fixture(autouse=True)
def _reference_device_scoring(monkeypatch):
    """The reference scores on its device path (not the host shortcut),
    and its pager state starts and ends empty."""
    monkeypatch.setattr(jbm25, "HOST_SCORING", False)
    led = device_ledger()
    led.reset()
    yield
    led.reset()


def new_engine(path, durability="request"):
    return InternalEngine(str(path), DocumentMapper(MAPPING),
                          index_name="idx", durability=durability,
                          device="cpu")


def search_ids(engine, query=None):
    s = engine.acquire_searcher()
    resp = s.search({"query": query or {"match_all": {}}, "size": 100})
    return sorted(h["_id"] for h in resp["hits"]["hits"])


# -- the port against the reference over one seeded op sequence --------------

TAGS = ("red", "green", "blue")
WORDS = [f"w{i}" for i in range(40)]


def op_sequence(seed: int, n_ops: int = 260) -> list:
    """Seeded ops over a pool of 50 ids: writes with and without
    concurrency checks (some stale), external versions, deletes, and the
    lifecycle steps, ending with a flush and a kill."""
    rng = np.random.default_rng(seed)
    ops = []
    for i in range(n_ops):
        doc = f"d{int(rng.integers(50))}"
        r = rng.random()
        if r < 0.55:
            words = rng.zipf(1.4, size=int(rng.integers(2, 12))) - 1
            src = {"title": " ".join(WORDS[int(w) % 40] for w in words),
                   "n": int(rng.integers(1000)),
                   "tag": TAGS[int(rng.integers(3))]}
            kw = {}
            c = rng.random()
            if c < 0.1:
                kw = {"if_seq_no": "current"}
            elif c < 0.18:
                kw = {"if_seq_no": int(rng.integers(-1, i + 1))}
            elif c < 0.22:
                kw = {"if_seq_no": "current", "if_primary_term": 2}
            elif c < 0.3:
                kw = {"version": int(rng.integers(1, 40)),
                      "version_type": "external"}
            elif c < 0.33:
                kw = {"version": int(rng.integers(1, 40)),
                      "version_type": "external_gte"}
            elif c < 0.36:
                kw = {"version": int(rng.integers(1, 4))}
            ops.append(("index", doc, src, kw))
        elif r < 0.72:
            kw = {}
            if rng.random() < 0.2:
                kw = {"if_seq_no": int(rng.integers(-1, i + 1))}
            ops.append(("delete", doc, None, kw))
        elif r < 0.84:
            ops.append(("refresh", None, None, {}))
        elif r < 0.88:
            ops.append(("flush", None, None, {}))
        elif r < 0.91:
            ops.append(("force_merge", None, None,
                        {"max_num_segments": int(rng.integers(1, 3))}))
        elif r < 0.94:
            ops.append(("reopen", None, None, {}))
        elif r < 0.97:
            ops.append(("kill", None, None, {}))
        else:
            ops.append(("sync", None, None, {}))
    ops += [("flush", None, None, {}), ("index", "d0", {"title": "w1 w2",
                                                         "n": 1,
                                                         "tag": "red"}, {}),
            ("kill", None, None, {}), ("refresh", None, None, {})]
    return ops


def queries(seed: int) -> list:
    rng = np.random.default_rng(seed)
    w = [WORDS[int(x)] for x in rng.integers(0, 12, size=8)]
    return [
        {"query": {"match": {"title": f"{w[0]} {w[1]}"}}, "size": 10},
        {"query": {"match": {"title": {"query": f"{w[2]} {w[3]}",
                                       "operator": "and"}}}, "size": 20},
        {"query": {"bool": {"must": [{"match": {"title": f"{w[4]} w0"}}],
                            "filter": [{"term": {"tag": "red"}}]}},
         "size": 15},
        {"query": {"term": {"tag": "blue"}}, "size": 30},
        {"query": {"term": {"title": w[5]}}, "size": 5},
        {"query": {"match_all": {}}, "size": 60},
    ]


def _norm_segments(value):
    """``value`` with the engine-unique part of segment ids taken out
    (``seg_<uid>_<n>`` -> ``seg_<n>``): each engine draws its own uid."""
    if isinstance(value, str):
        return re.sub(r"^seg_[0-9a-f]{6}_", "seg_", value)
    if isinstance(value, dict):
        return {_norm_segments(k): _norm_segments(v)
                for k, v in value.items()}
    if isinstance(value, list):
        return [_norm_segments(v) for v in value]
    return value


def _result(fn):
    try:
        r = fn()
    except Exception as e:                     # the error's type is compared
        return ("error", type(e).__name__)
    return (r.doc_id, r.seq_no, r.version, r.result, r.primary_term)


class Pair:
    """The reference engine and the port's over two directories, driven
    op by op."""

    def __init__(self, root):
        self.paths = (str(root / "jax"), str(root / "torch"))
        self.last_seq: dict = {}
        self.outcomes: dict = {}      # result or error name -> count
        self.open()

    def open(self):
        self.ref = JaxEngine(self.paths[0], JaxMapper(MAPPING),
                             index_name="idx")
        self.port = InternalEngine(self.paths[1], DocumentMapper(MAPPING),
                                   index_name="idx", device="cpu")

    def both(self, name, *args, **kw):
        return (getattr(self.ref, name)(*args, **kw),
                getattr(self.port, name)(*args, **kw))

    def write(self, kind, doc, src, kw):
        kw = dict(kw)
        if kw.get("if_seq_no") == "current":
            kw["if_seq_no"] = self.last_seq.get(doc, -1)
        args = (doc, src) if kind == "index" else (doc,)
        a = _result(lambda: getattr(self.ref, kind)(*args, **kw))
        b = _result(lambda: getattr(self.port, kind)(*args, **kw))
        assert a == b, (kind, doc, kw)
        outcome = a[1] if a[0] == "error" else a[3]
        self.outcomes[outcome] = self.outcomes.get(outcome, 0) + 1
        if a[0] != "error":
            self.last_seq[doc] = a[1]

    def check_state(self, ids):
        ref, port = self.ref, self.port
        for doc in ids:
            assert ref.get(doc) == port.get(doc), doc
            assert ref.get(doc, realtime=False) == \
                port.get(doc, realtime=False), doc
        assert ref.doc_count() == port.doc_count()
        assert ref.max_seq_no == port.max_seq_no
        assert ref.local_checkpoint == port.local_checkpoint
        assert _norm_segments(ref.checkpoint_info()) == \
            _norm_segments(port.checkpoint_info())
        assert ref.replication_digest() == port.replication_digest()
        assert ref.stats() == port.stats()

    def check_search(self, seed):
        rs, ps = self.ref.acquire_searcher(), self.port.acquire_searcher()
        for body in queries(seed):
            a, b = rs.search(body), ps.search(body)
            bad = bm25_mismatch(a, b)
            assert bad is None, (body, bad)
            assert a["hits"]["max_score"] == b["hits"]["max_score"], body
            assert [h.get("_source") for h in a["hits"]["hits"]] == \
                [h.get("_source") for h in b["hits"]["hits"]], body
            assert rs.count(body["query"]) == ps.count(body["query"]), body


@pytest.mark.parametrize("seed", [4, 19])
def test_op_sequence_matches_the_reference_engine(tmp_path, seed):
    pair = Pair(tmp_path)
    ids = [f"d{i}" for i in range(50)]
    lifecycle = 0
    for step, (kind, doc, src, kw) in enumerate(op_sequence(seed)):
        if kind in ("index", "delete"):
            pair.write(kind, doc, src, kw)
            continue
        lifecycle += 1
        if kind == "refresh":
            a, b = pair.both("refresh")
            assert a == b
        elif kind == "flush":
            a, b = pair.both("flush")
            assert _norm_segments(a) == _norm_segments(b)
        elif kind == "force_merge":
            a, b = pair.both("force_merge", **kw)
            assert a == b
        elif kind == "sync":
            pair.both("ensure_synced")
        elif kind == "reopen":
            pair.both("close")
            pair.open()
        elif kind == "kill":
            pair.both("ensure_synced")
            pair.ref = pair.port = None
            gc.collect()
            pair.open()
        pair.check_state(ids)
        pair.check_search(seed * 1000 + step)
    assert lifecycle >= 20
    assert all(pair.outcomes.get(k, 0) >= 3 for k in (
        "created", "updated", "deleted", "not_found",
        "VersionConflictError")), pair.outcomes
    pair.check_state(ids)
    pair.check_search(seed)
    pair.both("close")


# -- the device the engine serves on -----------------------------------------

def test_engine_without_device_asks_for_cuda(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(DeviceUnavailableError):
        InternalEngine(str(tmp_path), DocumentMapper(MAPPING))
    with pytest.raises(DeviceUnavailableError):
        InternalEngine(str(tmp_path), DocumentMapper(MAPPING),
                       device="cuda")
    eng = new_engine(tmp_path)
    assert eng.acquire_searcher().device == torch.device("cpu")
    eng.close()


def test_merged_away_segments_are_released(tmp_path):
    """Once the searchers that held them are gone, nothing keeps the
    segments a merge replaced, nor their staged views."""
    eng = new_engine(tmp_path)
    for i in range(40):
        eng.index(str(i), {"title": f"w{i % 7} w{i % 3}", "n": i})
        if i % 10 == 9:
            eng.refresh()
    before = search_ids(eng, {"match": {"title": "w1"}})
    searcher = eng.acquire_searcher()
    old = [weakref.ref(s) for s in eng.segments]
    staged = [weakref.ref(s.device("cpu")) for s in eng.segments]
    assert eng.force_merge(1) == 1
    assert eng._searcher is None
    del searcher
    gc.collect()
    assert all(r() is None for r in old + staged)
    assert search_ids(eng, {"match": {"title": "w1"}}) == before
    eng.close()


# -- the cases of tests/test_engine.py on the port's engine ------------------

def test_index_refresh_search_cycle(tmp_path):
    eng = new_engine(tmp_path)
    r = eng.index("1", {"title": "hello world", "n": 1})
    assert (r.result, r.version, r.seq_no) == ("created", 1, 0)
    # NRT semantics: invisible to search before refresh, visible to GET
    assert search_ids(eng) == []
    assert eng.get("1")["_source"]["title"] == "hello world"
    assert eng.get("1", realtime=False) is None
    eng.refresh()
    assert search_ids(eng) == ["1"]
    assert eng.get("1", realtime=False)["found"]
    eng.close()


def test_update_and_delete_cycle(tmp_path):
    eng = new_engine(tmp_path)
    eng.index("1", {"title": "old text", "n": 1})
    eng.refresh()
    r = eng.index("1", {"title": "new text", "n": 2})
    assert (r.result, r.version) == ("updated", 2)
    # pre-refresh: search still sees the old doc, GET sees the new one
    assert search_ids(eng, {"match": {"title": "old"}}) == ["1"]
    assert eng.get("1")["_source"]["title"] == "new text"
    eng.refresh()
    assert search_ids(eng, {"match": {"title": "old"}}) == []
    assert search_ids(eng, {"match": {"title": "new"}}) == ["1"]

    r = eng.delete("1")
    assert (r.result, r.version) == ("deleted", 3)
    assert eng.get("1") is None
    assert search_ids(eng) == ["1"]     # unrefreshed delete still visible
    eng.refresh()
    assert search_ids(eng) == []
    assert eng.delete("1").result == "not_found"
    assert eng.doc_count() == 0
    eng.close()


def test_versioning_conflicts(tmp_path):
    eng = new_engine(tmp_path)
    r = eng.index("1", {"n": 1})
    with pytest.raises(VersionConflictError):
        eng.index("1", {"n": 2}, if_seq_no=99, if_primary_term=1)
    r2 = eng.index("1", {"n": 2}, if_seq_no=r.seq_no, if_primary_term=1)
    assert r2.version == 2
    with pytest.raises(VersionConflictError):
        eng.index("1", {"n": 3}, version=1)       # internal: must match current
    # external versioning: must strictly increase
    eng.index("2", {"n": 1}, version=10, version_type="external")
    with pytest.raises(VersionConflictError):
        eng.index("2", {"n": 2}, version=10, version_type="external")
    r3 = eng.index("2", {"n": 2}, version=20, version_type="external")
    assert r3.version == 20
    with pytest.raises(VersionConflictError):
        eng.delete("2", if_seq_no=0, if_primary_term=1)
    eng.close()


def test_kill9_recovery_from_translog(tmp_path):
    eng = new_engine(tmp_path)
    for i in range(20):
        eng.index(str(i), {"title": f"doc number {i}", "n": i})
    eng.delete("5")
    eng.index("7", {"title": "updated doc", "n": 700})
    eng.ensure_synced()
    # kill -9: drop the engine without close/flush
    del eng

    eng2 = new_engine(tmp_path)
    assert eng2.doc_count() == 19
    assert eng2.get("5") is None
    assert eng2.get("7")["_source"]["n"] == 700
    assert eng2.get("7")["_version"] == 2
    assert eng2.max_seq_no == 21
    eng2.refresh()
    assert len(search_ids(eng2)) == 19
    # new writes continue from the recovered seq_no
    r = eng2.index("new", {"n": 1})
    assert r.seq_no == 22
    eng2.close()


@pytest.mark.parametrize("append_after", [False, True],
                         ids=["discarded", "truncated_before_append"])
def test_torn_translog_tail(tmp_path, append_after):
    """A torn final write (kill -9 mid-append) is discarded at open, and
    truncated there, so an op appended after reopening survives the
    next recovery instead of merging with the garbage."""
    eng = new_engine(tmp_path)
    eng.index("1", {"n": 1})
    if not append_after:
        eng.index("2", {"n": 2})
    eng.ensure_synced()
    gen = eng.translog.generation
    del eng
    log = tmp_path / "translog" / f"translog-{gen}.log"
    with open(log, "ab") as f:
        f.write(b'deadbeef{"op":"index","id":"3"')   # no newline, bad crc
    eng2 = new_engine(tmp_path)
    if append_after:
        eng2.index("2", {"n": 2})                 # appended after truncation
        eng2.ensure_synced()
        del eng2
        eng2 = new_engine(tmp_path)
        assert eng2.get("2")["found"]
    assert eng2.doc_count() == 2
    assert eng2.get("3") is None
    eng2.close()


def test_flush_commit_and_reopen(tmp_path):
    eng = new_engine(tmp_path)
    for i in range(10):
        eng.index(str(i), {"title": "flushed doc", "n": i})
    commit = eng.flush()
    assert commit["max_seq_no"] == 9
    assert len(commit["segments"]) == 1
    # translog trimmed: no ops to replay
    assert eng.translog.ops_count() == 0
    eng.index("10", {"title": "post flush", "n": 10})
    eng.ensure_synced()
    del eng

    eng2 = new_engine(tmp_path)
    assert eng2.doc_count() == 11            # 10 from segments + 1 replayed
    eng2.refresh()
    assert len(search_ids(eng2)) == 11
    eng2.close()


def test_delete_survives_flush_cycle(tmp_path):
    eng = new_engine(tmp_path)
    eng.index("a", {"n": 1})
    eng.index("b", {"n": 2})
    eng.flush()
    eng.delete("a")
    eng.flush()                               # persists the live bitmap
    del eng
    eng2 = new_engine(tmp_path)
    assert eng2.doc_count() == 1
    assert eng2.get("a") is None
    assert eng2.get("b")["found"]
    eng2.close()


def test_force_merge(tmp_path):
    eng = new_engine(tmp_path)
    for i in range(30):
        eng.index(str(i), {"title": f"merge doc {i}", "n": i, "tag": "t"})
        if i % 10 == 9:
            eng.refresh()
    eng.delete("3")
    eng.refresh()
    assert len(eng.segments) == 3
    before = search_ids(eng, {"term": {"tag": "t"}})
    n = eng.force_merge(1)
    assert n == 1
    after = search_ids(eng, {"term": {"tag": "t"}})
    assert before == after
    assert eng.doc_count() == 29
    eng.close()


def test_merge_cleans_persisted_files(tmp_path):
    eng = new_engine(tmp_path)
    for i in range(10):
        eng.index(str(i), {"n": i})
        if i % 5 == 4:
            eng.flush()
    assert len(list((tmp_path / "segments").iterdir())) > 3
    eng.force_merge(1)
    eng.flush()
    del eng
    eng2 = new_engine(tmp_path)
    assert eng2.doc_count() == 10
    eng2.close()


def test_force_merge_crash_before_flush_keeps_data(tmp_path):
    """Merged-away segment files must survive until the NEXT commit —
    a crash right after force_merge recovers the pre-merge state."""
    eng = new_engine(tmp_path)
    for i in range(10):
        eng.index(str(i), {"n": i})
    eng.flush()
    eng.force_merge(1)
    del eng                                   # crash: no flush after merge
    eng2 = new_engine(tmp_path)
    assert eng2.doc_count() == 10
    eng2.refresh()
    assert len(search_ids(eng2)) == 10
    eng2.flush()                              # now the old files may go
    eng2.close()


def test_searcher_is_point_in_time(tmp_path):
    """An acquired searcher must not see deletes applied by a later
    refresh (Lucene reader snapshot semantics)."""
    eng = new_engine(tmp_path)
    for i in range(5):
        eng.index(str(i), {"n": i})
    eng.refresh()
    old = eng.acquire_searcher()
    assert len(old.search({"size": 10})["hits"]["hits"]) == 5
    eng.delete("2")
    eng.refresh()
    # old snapshot unchanged; new searcher sees the delete
    assert len(old.search({"size": 10})["hits"]["hits"]) == 5
    new = eng.acquire_searcher()
    assert len(new.search({"size": 10})["hits"]["hits"]) == 4
    eng.close()


def test_sequence_numbers_monotonic(tmp_path):
    eng = new_engine(tmp_path)
    seqs = [eng.index(str(i), {"n": i}).seq_no for i in range(5)]
    seqs.append(eng.delete("0").seq_no)
    assert seqs == list(range(6))
    assert eng.stats()["seq_no"]["max_seq_no"] == 5
    eng.close()


def _corrupt_mid_file(tmp_path):
    """Two fsynced records with a byte of the FIRST flipped: corruption
    followed by a valid record is mid-file, not a torn tail."""
    eng = new_engine(tmp_path)
    eng.index("1", {"n": 1})
    eng.index("2", {"n": 2})
    eng.ensure_synced()
    gen = eng.translog.generation
    del eng
    log = tmp_path / "translog" / f"translog-{gen}.log"
    lines = log.read_bytes().split(b"\n")
    assert len(lines) >= 3          # two records + trailing empty
    first = bytearray(lines[0])
    first[-1] ^= 0xFF
    lines[0] = bytes(first)
    log.write_bytes(b"\n".join(lines))
    return lambda: new_engine(tmp_path)


def _corrupt_last_acked(tmp_path):
    """One fsynced record, corrupted, with NO valid record after it."""
    tl = Translog(str(tmp_path / "tl"))
    tl.add({"op": "index", "id": "1", "seq_no": 0})
    tl.sync()
    path = tl._gen_path(tl.generation)
    tl._file.close()
    data = bytearray(open(path, "rb").read())
    data[10] ^= 0xFF                       # corrupt the acked record
    open(path, "wb").write(bytes(data))
    return lambda: Translog(str(tmp_path / "tl"))


@pytest.mark.parametrize("corrupt", [_corrupt_mid_file, _corrupt_last_acked],
                         ids=["mid_file", "last_acked_record"])
def test_corruption_below_fsync_mark_raises(tmp_path, corrupt):
    """Corruption below the fsync high-water mark is acked-data loss:
    opening raises, whether or not valid records follow it, and never
    truncates acked ops away (reference: TranslogCorruptedException)."""
    reopen = corrupt(tmp_path)
    with pytest.raises(TranslogCorruptedError):
        reopen()


def test_delete_tombstones_pruned_on_flush(tmp_path):
    """Delete tombstones must not outlive the commit that made the
    deletes durable (GC-deletes analog) or delete-heavy workloads grow
    the version map without bound."""
    eng = new_engine(tmp_path)
    for i in range(20):
        eng.index(str(i), {"n": i})
    for i in range(15):
        eng.delete(str(i))
    eng.refresh()
    tombstones = sum(1 for v in eng._version_map.values() if v.deleted)
    assert tombstones == 15         # retained until the flush commit
    eng.flush()
    tombstones = sum(1 for v in eng._version_map.values() if v.deleted)
    assert tombstones == 0
    # deleted docs stay deleted after the prune + reopen
    assert eng.get("3") is None or eng.get("3").get("found") is False
    eng.close()
    eng2 = new_engine(tmp_path)
    eng2.refresh()
    assert len(search_ids(eng2)) == 5
    eng2.close()


def test_unacked_garbage_then_valid_record_truncated(tmp_path):
    """Out-of-order page writeback can persist a later UNACKED op but not
    an earlier one.  Corruption at/past the fsync high-water mark is
    unacked garbage — truncate it (and any unacked valid ops after it),
    never raise."""
    import zlib

    tl = Translog(str(tmp_path / "tl"))
    tl.add({"op": "index", "id": "1", "seq_no": 0})
    tl.sync()                               # high-water mark: op 1 acked
    path = tl._gen_path(tl.generation)
    tl._file.close()
    payload = b'{"op":"index","id":"3","seq_no":2}'
    crc = zlib.crc32(payload) & 0xFFFFFFFF
    with open(path, "ab") as f:
        f.write(b"deadbeefGARBAGE\n")
        f.write(f"{crc:08x}".encode() + payload + b"\n")
    tl2 = Translog(str(tmp_path / "tl"))    # must truncate, not raise
    ops = list(tl2.read_ops())
    assert [o["id"] for o in ops] == ["1"]
    tl2.close()


def test_replica_op_stale_primary_term_fenced(tmp_path):
    """Ops from a deposed primary (lower term) must be rejected — the
    operation-permit/primary-term fencing analog."""
    eng = new_engine(tmp_path)
    eng.apply_replica_op({"op": "index", "id": "a", "source": {"n": 1},
                          "routing": None, "seq_no": 0, "version": 1,
                          "primary_term": 2})
    with pytest.raises(VersionConflictError):
        eng.apply_replica_op({"op": "index", "id": "b", "source": {"n": 2},
                              "routing": None, "seq_no": 1, "version": 1,
                              "primary_term": 1})
    # realtime GET from the replica op buffer
    doc = eng.get("a")
    assert doc["found"] and doc["_source"] == {"n": 1}
    # promotion replays the buffered op into the indexing path
    eng.promote_to_primary(term=3)
    eng.refresh()
    assert len(search_ids(eng)) == 1
    assert eng.primary_term == 3
    eng.close()


def test_retention_leases_pin_translog_and_serve_ops(tmp_path):
    """A lease keeps op history through flush so ops_since() can serve a
    partitioned replica; removing it lets the translog trim again."""
    mapper = DocumentMapper({"properties": {"n": {"type": "long"}}})
    e = InternalEngine(str(tmp_path / "sh"), mapper, device="cpu")
    for i in range(5):
        e.index(f"d{i}", {"n": i})
    e.add_retention_lease("replica-1", 2)
    e.flush()                        # leases pin history past the commit
    ops = e.ops_since(2)
    assert [op["seq_no"] for op in ops] == [3, 4]
    assert all(op["op"] == "index" for op in ops)
    # no lease + flush -> history trimmed -> ops-based recovery refused
    e.remove_retention_lease("replica-1")
    e.index("d9", {"n": 9})
    e.flush()
    assert e.ops_since(2) is None
    e.close()
