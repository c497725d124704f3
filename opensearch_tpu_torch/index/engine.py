"""Per-shard engine: versioned CRUD with seq-nos, translog durability,
NRT refresh, commits, realtime GET (the port of the JAX package's
``index/engine.py``).

Analog of ``index/engine/InternalEngine.java`` (index :845, plan branches
:909-920, indexIntoLucene :1107) + ``LiveVersionMap``: documents buffer in
a host-side "hot" list and become an immutable array segment on refresh
(the incremental-NRT-vs-immutable-device-arrays design from SURVEY §7.3);
deletes tombstone the owning segment's live bitmap at refresh; the version
map serves realtime GET and optimistic concurrency between refreshes.

The engine serves its searches on ``device``: ``cuda`` unless the caller
asks for ``"cpu"``; without CUDA an engine that did not ask for the CPU
raises ``DeviceUnavailableError`` when it is built.  ``refresh``,
``force_merge`` and the checkpoint installs drop the cached searcher and
never change a searcher's segments in place: a searcher is a
point-in-time view (its own live bitmaps, impact columns and launch
tables), and a merged-away segment is released, with what it staged on
the device, once the searchers that hold it are gone.  The reference's
telemetry spans and metrics are not ported.
"""

from __future__ import annotations

import json
import os
import threading
import uuid
from dataclasses import dataclass
from typing import Optional

import numpy as np

from opensearch_tpu_torch.common.errors import (
    EngineClosedError,
    IllegalArgumentError,
    MapperParsingError,
    VersionConflictError,
)
from opensearch_tpu_torch.common.torchenv import resolve_device
from opensearch_tpu_torch.index.segment import Segment, SegmentWriter
from opensearch_tpu_torch.index.store import (
    CorruptIndexError,
    delete_segment_files,
    find_corruption_markers,
    load_segment,
    save_live,
    save_segment,
    segment_from_blobs,
    segment_to_blobs,
    verify_segment,
    write_corruption_marker,
)
from opensearch_tpu_torch.index.translog import Translog
from opensearch_tpu_torch.mapping.mapper import DocumentMapper, ParsedDocument
from opensearch_tpu_torch.search.executor import ShardSearcher


@dataclass
class VersionEntry:
    seq_no: int
    version: int
    deleted: bool
    hot_idx: int = -1                # >=0 while the doc lives in the hot buffer


@dataclass
class OpResult:
    doc_id: str
    seq_no: int
    version: int
    result: str                      # created | updated | deleted | not_found
    primary_term: int = 1            # the term the op executed under


class InternalEngine:
    """Single-writer-per-shard engine (writes serialized by a lock, like
    the reference's per-shard indexing semantics under operation permits),
    whose searchers serve on ``device`` (``cuda`` by default)."""

    COMMIT_FILE = "commit.json"

    def __init__(self, data_path: str, mapper: DocumentMapper,
                 index_name: str = "index", shard_id: int = 0,
                 durability: str = "request", codec: str = "default",
                 device=None):
        self.device = resolve_device(device)
        self.data_path = data_path
        self.mapper = mapper
        self.codec = codec
        self.index_name = index_name
        self.shard_id = shard_id
        self.primary_term = 1
        self._lock = threading.RLock()
        self._closed = False
        # search-only replica engine (the ingest/search tier split):
        # segments arrive exclusively via remote-store checkpoint
        # installs — every write entry point refuses, keeping searchers
        # stateless and out of the replication stream entirely
        self.search_only = False
        # set when the on-disk store failed verification (marker found or
        # checksum mismatch): the engine refuses reads/writes so a corrupt
        # copy can never serve wrong data (Store.failIfCorrupted)
        self.corruption: Optional[CorruptIndexError] = None
        self.segments: list[Segment] = []
        self._hot: list[Optional[ParsedDocument]] = []
        self._version_map: dict[str, VersionEntry] = {}
        self._pending_deletes: list[tuple[Segment, int]] = []
        self._seq_no = -1
        # local checkpoint: highest seq_no below which EVERY op has been
        # processed on this copy (LocalCheckpointTracker analog) — the
        # value replicas report back so the primary can compute the
        # global checkpoint.  Non-contiguous arrivals park in
        # _pending_seqs until the gap fills.
        self._local_ckpt = -1
        self._pending_seqs: set[int] = set()
        # global checkpoint: highest seq_no known durable on EVERY
        # in-sync copy (GlobalCheckpointTracker analog).  Computed by the
        # primary, piggybacked to replicas on replication ops; ops above
        # it are the rollback set on demotion.
        self.global_checkpoint = -1
        # doc id -> primary term of the op that last touched it; the
        # (primary_term, seq_no) half of the durability audit's per-copy
        # digest.  Terms == 1 are implicit (kept out of commits).
        self._doc_terms: dict[str, int] = {}
        # replica mode: primary-replicated ops not yet covered by an
        # installed segment checkpoint, keyed by seq_no
        self._replica_ops: dict[int, dict] = {}
        self._persisted_segments: set[str] = set()
        self._live_dirty: set[str] = set()
        # files superseded by a merge: deleted only AFTER the next commit
        # point lands (Lucene keeps old files until commit)
        self._obsolete_files: set[str] = set()
        self._seg_counter = 0
        # lease id (replica node) -> lowest retained seq_no; leases pin
        # translog generations past flush (RetentionLease analog)
        self.retention_leases: dict[str, int] = {}
        # generation -> max seq_no it contains (recorded at roll time) so
        # lease-aware trimming deletes exactly the generations every
        # lease has moved past
        self._gen_max_seq: dict[int, int] = {}
        # engine-unique segment-id prefix: segments INSTALLED from another
        # engine (segment replication / recovery) keep their foreign ids,
        # so locally-built ids must never collide with them — a promoted
        # replica builds segments alongside ids minted by the old primary
        self._engine_uid = uuid.uuid4().hex[:6]
        self._searcher: Optional[ShardSearcher] = None
        self._writer = SegmentWriter()

        os.makedirs(data_path, exist_ok=True)
        self.translog = Translog(os.path.join(data_path, "translog"),
                                 durability=durability)
        self._recover()

    # -- lifecycle --------------------------------------------------------

    def _recover(self):
        """Load the last commit point, then replay translog ops newer than
        it (RecoverySourceHandler phase-2 analog for the local shard).

        A store with a corruption marker, or one whose checksums fail on
        load, does NOT open: ``self.corruption`` carries the verdict and
        every read/write raises it until the copy is dropped and
        re-recovered (Store.failIfCorrupted / CorruptedFileException)."""
        commit_path = os.path.join(self.data_path, self.COMMIT_FILE)
        seg_dir = os.path.join(self.data_path, "segments")
        markers = find_corruption_markers(seg_dir)
        if markers:
            self.corruption = CorruptIndexError(
                f"[{self.index_name}][{self.shard_id}] store is marked "
                f"corrupted: {markers[0].get('reason', 'unknown')}")
            return
        committed_seq = -1
        if os.path.exists(commit_path):
            with open(commit_path) as f:
                commit = json.load(f)
            committed_seq = commit["max_seq_no"]
            self._seg_counter = commit.get("seg_counter", 0)
            self.primary_term = max(self.primary_term,
                                    int(commit.get("primary_term", 1)))
            self._doc_terms = {str(k): int(v) for k, v in
                               (commit.get("doc_terms") or {}).items()}
            for seg_id in commit["segments"]:
                try:
                    seg = load_segment(seg_dir, seg_id)
                except CorruptIndexError as e:
                    write_corruption_marker(seg_dir, seg_id, str(e))
                    self.corruption = e
                    self.segments = []
                    self._persisted_segments.clear()
                    return
                self.segments.append(seg)
                self._persisted_segments.add(seg_id)
            self._seq_no = committed_seq
            self._advance_local_ckpt_to(committed_seq)
            # GC segment files the commit doesn't reference (a crash
            # between commit write and obsolete-file deletion leaks them)
            # and unfinished temp files.  A file belongs to the segment
            # named before its first dot, so a referenced segment keeps
            # its ``<seg>.<field>.quant`` sidecars (the reference keyed
            # files by the name before the LAST dot and so deleted every
            # sidecar on each reopen).
            if os.path.isdir(seg_dir):
                referenced = set(commit["segments"])
                for fname in os.listdir(seg_dir):
                    if fname.split(".", 1)[0] not in referenced or \
                            fname.endswith(".tmp"):
                        os.remove(os.path.join(seg_dir, fname))
        for op in self.translog.read_ops(committed_seq):
            self._replay(op)

    def _replay(self, op: dict):
        if op["op"] == "index":
            self._do_index(op["id"], op["source"], routing=op.get("routing"),
                           seq_no=op["seq_no"], version=op["version"],
                           record=False)
        elif op["op"] == "delete":
            self._do_delete(op["id"], seq_no=op["seq_no"],
                            version=op["version"], record=False)
        # an op recorded under an older primary keeps that term across
        # replay — replayed history must digest identically on every copy
        if op.get("primary_term") is not None:
            self._doc_terms[str(op["id"])] = int(op["primary_term"])
        self._seq_no = max(self._seq_no, op["seq_no"])
        self._mark_seq_processed(int(op["seq_no"]))

    # -- checkpoint trackers ----------------------------------------------

    def _mark_seq_processed(self, seq: int):
        """Advance the local checkpoint past ``seq`` once contiguous
        (LocalCheckpointTracker.markSeqNoAsProcessed analog)."""
        if seq == self._local_ckpt + 1:
            self._local_ckpt = seq
            while self._local_ckpt + 1 in self._pending_seqs:
                self._local_ckpt += 1
                self._pending_seqs.discard(self._local_ckpt)
        elif seq > self._local_ckpt:
            self._pending_seqs.add(seq)

    def _advance_local_ckpt_to(self, seq: int):
        """A checkpoint install covers EVERY op <= seq: jump the tracker
        forward even over gaps this copy never saw individually."""
        if seq > self._local_ckpt:
            self._local_ckpt = int(seq)
        self._pending_seqs = {s for s in self._pending_seqs
                              if s > self._local_ckpt}
        while self._local_ckpt + 1 in self._pending_seqs:
            self._local_ckpt += 1
            self._pending_seqs.discard(self._local_ckpt)

    @property
    def local_checkpoint(self) -> int:
        with self._lock:
            return self._local_ckpt

    def update_global_checkpoint(self, gckpt: int):
        """Monotonic: the global checkpoint only advances (the primary
        recomputes it as min over in-sync local checkpoints; replicas
        learn it piggybacked on replication ops)."""
        with self._lock:
            self.global_checkpoint = max(self.global_checkpoint, int(gckpt))

    def close(self):
        with self._lock:
            if self._closed:
                return
            self._closed = True
            self.translog.close()

    def _ensure_open(self):
        if self._closed:
            raise EngineClosedError(f"engine for [{self.index_name}] is closed")
        if self.corruption is not None:
            raise self.corruption

    def _ensure_writeable(self):
        self._ensure_open()
        if self.search_only:
            raise IllegalArgumentError(
                f"[{self.index_name}][{self.shard_id}] is a search-only "
                "replica: writes are rejected on the search tier")

    def verify_store(self):
        """Full checksum pass over every persisted segment's on-disk
        files (Store.verify analog).  Detected corruption writes a
        ``corrupted_<seg>`` marker, poisons the engine, and raises —
        the caller (ClusterNode) runs the copy-failover protocol."""
        with self._lock:
            if self._closed:
                raise EngineClosedError(
                    f"engine for [{self.index_name}] is closed")
            if self.corruption is not None:
                raise self.corruption
            seg_dir = os.path.join(self.data_path, "segments")
            markers = find_corruption_markers(seg_dir)
            if markers:
                self.corruption = CorruptIndexError(
                    f"[{self.index_name}][{self.shard_id}] store is marked "
                    f"corrupted: {markers[0].get('reason', 'unknown')}")
                raise self.corruption
            for seg_id in sorted(self._persisted_segments):
                try:
                    verify_segment(seg_dir, seg_id)
                except CorruptIndexError as e:
                    write_corruption_marker(seg_dir, seg_id, str(e))
                    self.corruption = e
                    raise

    # -- version plumbing -------------------------------------------------

    def _current_entry(self, doc_id: str) -> Optional[VersionEntry]:
        e = self._version_map.get(doc_id)
        if e is not None:
            return e
        for seg in reversed(self.segments):
            local = seg.id_to_local.get(doc_id)
            if local is not None and seg.live[local]:
                return VersionEntry(seq_no=int(seg.seq_nos[local]),
                                    version=int(seg.versions[local]),
                                    deleted=False)
        return None

    def _check_conflicts(self, doc_id, entry, if_seq_no, if_primary_term,
                         version, version_type):
        if if_seq_no is not None or if_primary_term is not None:
            cur_seq = entry.seq_no if entry is not None and not entry.deleted else -1
            if if_seq_no is not None and cur_seq != if_seq_no:
                raise VersionConflictError(doc_id, f"seq_no [{if_seq_no}]",
                                           f"seq_no [{cur_seq}]")
            if if_primary_term is not None and if_primary_term != self.primary_term:
                raise VersionConflictError(
                    doc_id, f"primary_term [{if_primary_term}]",
                    f"primary_term [{self.primary_term}]")
        if version is not None:
            cur = entry.version if entry is not None and not entry.deleted else 0
            if version_type == "external":
                if version <= cur:
                    raise VersionConflictError(doc_id, f"> [{cur}]", version)
            elif version_type == "external_gte":
                if version < cur:
                    raise VersionConflictError(doc_id, f">= [{cur}]",
                                               version)
            else:
                if cur != version:
                    raise VersionConflictError(doc_id, version, cur)

    # -- write path -------------------------------------------------------

    def index(self, doc_id: str, source: dict, routing: Optional[str] = None,
              if_seq_no: Optional[int] = None,
              if_primary_term: Optional[int] = None,
              version: Optional[int] = None,
              version_type: str = "internal") -> OpResult:
        with self._lock:
            self._ensure_writeable()
            entry = self._current_entry(doc_id)
            self._check_conflicts(doc_id, entry, if_seq_no, if_primary_term,
                                  version, version_type)
            if version_type in ("external", "external_gte"):
                new_version = version
            else:
                new_version = (entry.version + 1
                               if entry is not None and not entry.deleted else 1)
            seq = self._seq_no + 1
            result = self._do_index(doc_id, source, routing=routing,
                                    seq_no=seq, version=new_version,
                                    record=True)
            self._seq_no = seq
            self._mark_seq_processed(seq)
            return result

    def _do_index(self, doc_id, source, routing, seq_no, version,
                  record: bool) -> OpResult:
        doc = self.mapper.parse(str(doc_id), source, routing=routing)
        doc.seq_no = seq_no
        doc.version = version
        encoded = None
        if record:
            # serialize BEFORE mutating any state: a non-JSON source must
            # fail cleanly, not leave hot buffer and translog divergent
            try:
                encoded = self.translog.encode(
                    {"op": "index", "id": str(doc_id), "source": source,
                     "routing": routing, "seq_no": seq_no,
                     "version": version,
                     "primary_term": self.primary_term})
            except (TypeError, ValueError) as e:
                raise MapperParsingError(
                    f"source for [{doc_id}] is not JSON-serializable: {e}")
        prev = self._version_map.get(doc_id)
        cur = self._current_entry(doc_id)        # vm OR live segment doc
        existed = cur is not None and not cur.deleted
        if prev is not None and prev.hot_idx >= 0:
            self._hot[prev.hot_idx] = None       # replaced before refresh
        elif existed:
            self._tombstone_segments(doc_id)
        self._hot.append(doc)
        self._version_map[str(doc_id)] = VersionEntry(
            seq_no=seq_no, version=version, deleted=False,
            hot_idx=len(self._hot) - 1)
        if record:
            self.translog.add_encoded(encoded)
        self._doc_terms[str(doc_id)] = self.primary_term
        return OpResult(str(doc_id), seq_no, version,
                        "updated" if existed else "created",
                        primary_term=self.primary_term)

    def _tombstone_segments(self, doc_id: str):
        for seg in reversed(self.segments):
            local = seg.id_to_local.get(doc_id)
            if local is not None and seg.live[local]:
                self._pending_deletes.append((seg, local))
                return

    def delete(self, doc_id: str, if_seq_no: Optional[int] = None,
               if_primary_term: Optional[int] = None,
               version: Optional[int] = None,
               version_type: str = "internal") -> OpResult:
        with self._lock:
            self._ensure_writeable()
            entry = self._current_entry(doc_id)
            self._check_conflicts(doc_id, entry, if_seq_no, if_primary_term,
                                  version, version_type)
            if entry is None or entry.deleted:
                return OpResult(str(doc_id), self._seq_no, 1, "not_found",
                                primary_term=self.primary_term)
            new_version = (version
                           if version_type in ("external", "external_gte")
                           else entry.version + 1)
            seq = self._seq_no + 1
            result = self._do_delete(doc_id, seq_no=seq, version=new_version,
                                     record=True)
            self._seq_no = seq
            self._mark_seq_processed(seq)
            return result

    def _do_delete(self, doc_id, seq_no, version, record: bool) -> OpResult:
        prev = self._version_map.get(doc_id)
        if prev is not None and prev.hot_idx >= 0:
            self._hot[prev.hot_idx] = None
        else:
            self._tombstone_segments(doc_id)
        self._version_map[str(doc_id)] = VersionEntry(
            seq_no=seq_no, version=version, deleted=True)
        if record:
            self.translog.add({"op": "delete", "id": str(doc_id),
                               "seq_no": seq_no, "version": version,
                               "primary_term": self.primary_term})
        self._doc_terms[str(doc_id)] = self.primary_term
        return OpResult(str(doc_id), seq_no, version, "deleted",
                        primary_term=self.primary_term)

    def ensure_synced(self):
        """Durability barrier before acking (Translog.ensureSynced analog).
        Safe to call from concurrent write RPCs: the translog serializes
        its own sync/checkpoint internally."""
        self.translog.sync()

    # -- replica mode (segment replication, NRTReplicationEngine analog) --
    #
    # A replica does NOT index: replicated ops land in the translog (for
    # durability + realtime GET + promotion replay) and become searchable
    # only when the primary publishes a refresh checkpoint and the replica
    # installs the copied segments (ref index/engine/NRTReplicationEngine.java,
    # indices/replication/SegmentReplicationTargetService.java:208).

    def apply_replica_op(self, op: dict, fence: bool = True):
        """Apply one primary-replicated op: translog append + version-map
        entry + op buffer.  Fenced by primary term (a stale primary's ops
        are rejected, ref IndexShard.applyIndexOperationOnReplica:954).
        ``fence=False`` is for promotion-resync replay only: resync ops
        keep their ORIGINAL terms (which may be below this engine's,
        already bumped by the promotion) — the resync request itself was
        term-validated by the transport handler."""
        with self._lock:
            self._ensure_writeable()
            term = int(op.get("primary_term", 1))
            if fence and term < self.primary_term:
                raise VersionConflictError(
                    str(op.get("id")), f"primary term >= {self.primary_term}",
                    f"stale primary term {term}")
            self.primary_term = max(self.primary_term, term)
            seq = int(op["seq_no"])
            encoded = self.translog.encode(op)
            self.translog.add_encoded(encoded)
            self._replica_ops[seq] = op
            cur = self._version_map.get(op["id"])
            if cur is None or cur.seq_no < seq:
                self._version_map[str(op["id"])] = VersionEntry(
                    seq_no=seq, version=int(op["version"]),
                    deleted=op["op"] == "delete", hot_idx=-1)
                self._doc_terms[str(op["id"])] = term
            self._seq_no = max(self._seq_no, seq)
            self._mark_seq_processed(seq)
            # the primary's view of the global checkpoint rides every
            # replication op (ReplicationOperation piggyback)
            if op.get("global_checkpoint") is not None:
                self.global_checkpoint = max(
                    self.global_checkpoint, int(op["global_checkpoint"]))

    # -- retention leases (index/seqno/RetentionLease.java analog) --------

    def add_retention_lease(self, lease_id: str, retaining_seq_no: int):
        """Primary: retain translog ops from ``retaining_seq_no`` on for
        the lease holder, so a briefly-partitioned replica can recover
        by op replay instead of a full file copy."""
        with self._lock:
            self.retention_leases[str(lease_id)] = int(retaining_seq_no)

    def remove_retention_lease(self, lease_id: str):
        with self._lock:
            self.retention_leases.pop(str(lease_id), None)

    def get_retention_leases(self) -> dict:
        with self._lock:
            return dict(self.retention_leases)

    def ops_since(self, from_seq: int):
        """Every op with seq_no > from_seq, in order — or None when the
        translog no longer retains a contiguous history up to the global
        checkpoint (then only a file copy can recover).  Contiguity is
        checked in O(n) over the RETAINED ops (seq_nos are unique), never
        over the full history."""
        from_seq = int(from_seq)
        with self._lock:
            self._ensure_open()
            ops = sorted({op["seq_no"]: op
                          for op in self.translog.read_ops(from_seq)
                          }.values(), key=lambda o: o["seq_no"])
            expected = self._seq_no - from_seq
            if (len(ops) == expected
                    and (expected == 0
                         or (ops[0]["seq_no"] == from_seq + 1
                             and ops[-1]["seq_no"] == self._seq_no))):
                return ops
            return None

    def checkpoint_info(self) -> dict:
        """Current segment-set checkpoint the primary publishes after a
        refresh (ReplicationCheckpoint analog): segment ids + per-segment
        live bitmaps (deletes travel with the checkpoint) + seq/term."""
        with self._lock:
            self._ensure_open()
            return {"segments": [s.seg_id for s in self.segments],
                    "live": {s.seg_id: s.live.tobytes()
                             for s in self.segments},
                    "max_seq_no": self._seq_no,
                    "primary_term": self.primary_term,
                    # per-doc terms ride the checkpoint so replica and
                    # search-tier digests stay term-comparable (term 1
                    # is implicit)
                    "doc_terms": {k: v for k, v in self._doc_terms.items()
                                  if v > 1}}

    def segments_blobs(self, seg_ids: list) -> dict:
        """Serialize the requested segments for wire copy (recovery
        phase-1 / segrep file transfer)."""
        with self._lock:
            self._ensure_open()
            by_id = {s.seg_id: s for s in self.segments}
            return {sid: segment_to_blobs(by_id[sid]) for sid in seg_ids
                    if sid in by_id}

    def install_checkpoint(self, ckpt: dict, blobs: dict):
        """Replica side: adopt the primary's segment set.  Missing
        segments come from ``blobs``; live bitmaps are overwritten from
        the checkpoint; buffered ops and version-map entries now covered
        by segments are dropped."""
        with self._lock:
            self._ensure_open()
            term = int(ckpt.get("primary_term", 1))
            if term < self.primary_term:
                raise VersionConflictError(
                    "<checkpoint>", f"primary term >= {self.primary_term}",
                    f"stale primary term {term}")
            self.primary_term = term
            have = {s.seg_id: s for s in self.segments}
            new_segments = []
            for sid in ckpt["segments"]:
                seg = have.get(sid)
                if seg is None:
                    seg = segment_from_blobs(blobs[sid])
                live = np.frombuffer(ckpt["live"][sid], dtype=bool)
                if (sid in self._persisted_segments
                        and not np.array_equal(seg.live, live)):
                    # deletes travel with the checkpoint: an already-
                    # persisted segment needs its .liv rewritten on the
                    # next flush or a restart resurrects deleted docs
                    self._live_dirty.add(sid)
                seg.live = live.copy()
                new_segments.append(seg)
            self.segments = new_segments
            covered = int(ckpt["max_seq_no"])
            self._seq_no = max(self._seq_no, covered)
            self._advance_local_ckpt_to(covered)
            for k, v in (ckpt.get("doc_terms") or {}).items():
                self._doc_terms[str(k)] = int(v)
            self._replica_ops = {s: op for s, op in self._replica_ops.items()
                                 if s > covered}
            self._version_map = {k: v for k, v in self._version_map.items()
                                 if v.seq_no > covered}
            self._searcher = None

    def install_remote_checkpoint(self, ckpt: dict,
                                  new_segments: dict):
        """Search-only replica side: adopt a primary-published segment
        set whose missing segments were already materialized from the
        remote store (CRC-verified ``Segment`` objects in
        ``new_segments``).  Unlike ``install_checkpoint`` there is no
        replica op buffer to reconcile — searchers hold no write state
        at all; live bitmaps come from the checkpoint when present
        (push path) or from the segments' own ``.liv`` sidecars (pull /
        recovery path)."""
        with self._lock:
            self._ensure_open()
            term = int(ckpt.get("primary_term", 1))
            if term < self.primary_term:
                raise VersionConflictError(
                    "<checkpoint>", f"primary term >= {self.primary_term}",
                    f"stale primary term {term}")
            self.primary_term = term
            have = {s.seg_id: s for s in self.segments}
            segments = []
            for sid in ckpt["segments"]:
                seg = have.get(sid)
                if seg is None:
                    seg = new_segments[sid]
                live = (ckpt.get("live") or {}).get(sid)
                if live is not None:
                    seg.live = np.frombuffer(live, dtype=bool).copy()
                segments.append(seg)
                # the files backing this segment are on disk (cache
                # links + regenerated manifests): never re-save them
                self._persisted_segments.add(sid)
            self.segments = segments
            self._seq_no = max(self._seq_no, int(ckpt["max_seq_no"]))
            self._advance_local_ckpt_to(int(ckpt["max_seq_no"]))
            for k, v in (ckpt.get("doc_terms") or {}).items():
                self._doc_terms[str(k)] = int(v)
            self._searcher = None

    def promote_to_primary(self, term: int):
        """Replica -> primary on failover: replay buffered (not yet
        segment-covered) ops through the indexing path so they become
        searchable, under the new primary term (the reference's promotion
        + translog replay, ref IndexShard routing-change promotion)."""
        with self._lock:
            self._ensure_open()
            self.primary_term = max(int(term), self.primary_term)
            ops = sorted(self._replica_ops.values(),
                         key=lambda o: o["seq_no"])
            self._replica_ops.clear()
            for op in ops:
                self._version_map.pop(str(op["id"]), None)
            for op in ops:
                self._replay(op)

    def advance_primary_term(self, term: int):
        """Monotonically adopt a (validated) new primary term — the
        replica side of a promotion resync bumps its engine term here
        after replaying the resync ops, which keep their original
        (older) terms."""
        with self._lock:
            self.primary_term = max(self.primary_term, int(term))

    def rollback_above(self, seq: int) -> int:
        """Drop every op with seq_no above ``seq`` from this copy — the
        deposed-primary / divergent-replica rollback (the reference's
        resetEngineToGlobalCheckpoint +
        trimOperationsOfPreviousPrimaryTerms).  Ops above the global
        checkpoint were never acked against a full in-sync set, so
        cancelling them cannot lose an acked write; a doc UPDATED above
        the cut resurrects its newest retained version at or below it.
        Durable: the translog gets a trim marker before in-memory state
        changes, so a restart replays the post-rollback history.
        Returns the number of ops rolled back."""
        with self._lock:
            self._ensure_open()
            seq = int(seq)
            if self._seq_no <= seq:
                return 0
            self.translog.trim_above(seq)
            dropped = len([s for s in self._replica_ops if s > seq])
            self._replica_ops = {s: op for s, op in
                                 self._replica_ops.items() if s <= seq}
            removed: list[str] = []
            for doc_id, e in list(self._version_map.items()):
                if e.seq_no > seq:
                    if e.hot_idx >= 0 and self._hot[e.hot_idx] is not None:
                        self._hot[e.hot_idx] = None
                        dropped += 1
                    del self._version_map[doc_id]
                    self._doc_terms.pop(doc_id, None)
                    removed.append(doc_id)
            # already-refreshed divergent docs: clear their live bits so
            # the newest retained copy (an older segment doc) resurfaces
            for seg in self.segments:
                locals_ = [i for i in range(seg.n_docs)
                           if seg.live[i] and int(seg.seq_nos[i]) > seq]
                if locals_:
                    seg.apply_deletes(locals_)
                    self._live_dirty.add(seg.seg_id)
                    dropped += len(locals_)
            # a rolled-back update/delete queued a tombstone against the
            # doc's OLDER copy — keep it only if a live newer version of
            # that doc still exists, else the old copy must stay live
            kept = []
            for seg, local in self._pending_deletes:
                did = str(seg.doc_ids[local])
                cur = self._current_entry(did)
                if cur is not None and not cur.deleted \
                        and cur.seq_no > int(seg.seq_nos[local]):
                    kept.append((seg, local))
            self._pending_deletes = kept
            # a doc written twice above+below the cut lost its retained
            # in-memory copy when the second write nulled the first's hot
            # slot — re-apply the newest retained translog op for it
            for doc_id in removed:
                best = None
                for op in self.translog.read_ops(-1):
                    if str(op.get("id")) == doc_id and \
                            (best is None
                             or op["seq_no"] > best["seq_no"]):
                        best = op
                cur = self._current_entry(doc_id)
                if best is not None and (cur is None
                                         or cur.seq_no < best["seq_no"]):
                    self._replay(best)
            self._seq_no = seq
            self._local_ckpt = min(self._local_ckpt, seq)
            self._pending_seqs = {s for s in self._pending_seqs
                                  if s <= seq}
            self._searcher = None
            return dropped

    def replication_digest(self) -> dict:
        """Per-doc ``(seq_no, primary_term, version, content-crc)`` over
        every live doc on this copy, plus rolled-up digests — the
        durability audit's cross-copy parity probe.  ``digest`` covers the
        full tuple; ``seq_digest`` leaves the term out, for search-tier
        copies whose pull-path refill cannot recover per-doc terms."""
        import zlib as _zlib
        with self._lock:
            self._ensure_open()
            ids = set(self._version_map)
            for seg in self.segments:
                ids.update(str(i) for i in seg.id_to_local)
            docs: dict[str, list] = {}
            for doc_id in sorted(ids):
                e = self._version_map.get(doc_id)
                src = None
                if e is not None:
                    if e.deleted:
                        continue
                    if e.hot_idx >= 0:
                        d = self._hot[e.hot_idx]
                        src = d.source if d is not None else None
                    else:
                        rop = self._replica_ops.get(e.seq_no)
                        if rop is not None and str(rop["id"]) == doc_id:
                            src = rop["source"]
                if e is None or src is None:
                    for seg in reversed(self.segments):
                        local = seg.id_to_local.get(doc_id)
                        if local is not None and seg.live[local]:
                            if e is None:
                                e = VersionEntry(
                                    seq_no=int(seg.seq_nos[local]),
                                    version=int(seg.versions[local]),
                                    deleted=False)
                            src = seg.source(local)
                            break
                    if e is None:
                        continue
                crc = 0
                if src is not None:
                    crc = _zlib.crc32(json.dumps(
                        src, sort_keys=True,
                        separators=(",", ":")).encode()) & 0xFFFFFFFF
                docs[doc_id] = [int(e.seq_no),
                                int(self._doc_terms.get(doc_id, 1)),
                                int(e.version), crc]
            blob = json.dumps(sorted(docs.items()),
                              separators=(",", ":")).encode()
            seq_blob = json.dumps(
                sorted((k, [v[0], v[2], v[3]]) for k, v in docs.items()),
                separators=(",", ":")).encode()
            return {"docs": docs,
                    "doc_count": len(docs),
                    "digest": _zlib.crc32(blob) & 0xFFFFFFFF,
                    "seq_digest": _zlib.crc32(seq_blob) & 0xFFFFFFFF}

    # -- read path --------------------------------------------------------

    def get(self, doc_id: str, realtime: bool = True) -> Optional[dict]:
        """Realtime GET via the version map + hot buffer (LiveVersionMap /
        ShardGetService analog); realtime=False reads search-visible state."""
        with self._lock:
            self._ensure_open()
            doc_id = str(doc_id)
            if realtime:
                e = self._version_map.get(doc_id)
                if e is not None:
                    if e.deleted:
                        return None
                    if e.hot_idx >= 0:
                        doc = self._hot[e.hot_idx]
                        out = {"_id": doc_id, "_version": e.version,
                               "_seq_no": e.seq_no,
                               "_primary_term": self.primary_term,
                               "_source": doc.source, "found": True}
                        if doc.routing is not None:
                            out["_routing"] = doc.routing
                        return self._finish_get(out)
                    rop = self._replica_ops.get(e.seq_no)
                    if rop is not None and rop["id"] == doc_id:
                        # replica realtime GET from the buffered op (the
                        # reference reads the translog, ShardGetService)
                        out = {"_id": doc_id, "_version": e.version,
                               "_seq_no": e.seq_no,
                               "_primary_term": self.primary_term,
                               "_source": rop["source"], "found": True}
                        if rop.get("routing") is not None:
                            out["_routing"] = rop["routing"]
                        return self._finish_get(out)
                # falls through: doc lives in a segment
            # pending (unrefreshed) deletes stay visible to non-realtime
            # reads, exactly like an unrefreshed Lucene reader
            for seg in reversed(self.segments):
                local = seg.id_to_local.get(doc_id)
                if local is not None and seg.live[local]:
                    out = {"_id": doc_id,
                           "_version": int(seg.versions[local]),
                           "_seq_no": int(seg.seq_nos[local]),
                           "_primary_term": self.primary_term,
                           "_source": seg.source(local), "found": True}
                    routing = seg.routings.get(local)
                    if routing is not None:
                        out["_routing"] = routing
                    return self._finish_get(out)
            return None

    def _finish_get(self, out: dict) -> dict:
        """_source meta-field policy: enabled=false never returns source
        (SourceFieldMapper.enabled)."""
        if not getattr(self.mapper, "source_enabled", True):
            out.pop("_source", None)
        return out

    def acquire_searcher(self) -> ShardSearcher:
        """Search-visible snapshot; refresh() publishes new segments."""
        with self._lock:
            self._ensure_open()
            if self._searcher is None:
                self._searcher = ShardSearcher(
                    list(self.segments), self.mapper,
                    index_name=self.index_name, shard_id=self.shard_id,
                    device=self.device)
            return self._searcher

    # -- refresh / flush / merge -----------------------------------------

    def refresh(self) -> int:
        """Publish buffered writes + pending deletes to searchers
        (OpenSearchReaderManager.refresh analog).  Returns the number of
        docs in the new segment (0 if none was created)."""
        with self._lock:
            self._ensure_open()
            by_seg: dict[int, tuple[Segment, list[int]]] = {}
            for seg, local in self._pending_deletes:
                by_seg.setdefault(id(seg), (seg, []))[1].append(local)
            for seg, locals_ in by_seg.values():
                seg.apply_deletes(locals_)     # copy-on-write live bitmap
                self._live_dirty.add(seg.seg_id)
            self._pending_deletes.clear()
            hot_docs = [d for d in self._hot if d is not None]
            created = 0
            if hot_docs:
                seg_id = f"seg_{self._engine_uid}_{self._seg_counter}"
                self._seg_counter += 1
                seg = self._writer.build(hot_docs, seg_id,
                                         vector_meta=self._vector_meta())
                self.segments.append(seg)
                created = seg.n_docs
            self._hot.clear()
            # entries now resolvable from segments; keep tombstones
            # (deleted-doc versions must survive until trimmed, like the
            # reference's tombstone retention) and entries backed only by
            # the replica op buffer (no local segment holds them until a
            # checkpoint installs)
            self._version_map = {k: v for k, v in self._version_map.items()
                                 if v.deleted
                                 or v.seq_no in self._replica_ops}
            self._searcher = None
            return created

    def _vector_meta(self) -> dict:
        out = {}
        for path, ft in self.mapper.field_types().items():
            if ft.dv_kind == "vector":
                out[path] = {"dims": ft.dims,
                             "similarity": getattr(ft, "space_type", "l2")}
        return out

    def flush(self) -> dict:
        """refresh + persist segments + commit point + translog trim
        (InternalEngine.flush -> Lucene commit analog)."""
        with self._lock:
            self._ensure_open()
            self.refresh()
            seg_dir = os.path.join(self.data_path, "segments")
            for seg in self.segments:
                if seg.seg_id not in self._persisted_segments:
                    save_segment(seg, seg_dir, codec=self.codec)
                    self._persisted_segments.add(seg.seg_id)
                elif seg.seg_id in self._live_dirty:
                    save_live(seg, seg_dir)
            self._live_dirty.clear()
            self._gen_max_seq[self.translog.generation] = self._seq_no
            self.translog.roll_generation()
            commit = {"segments": [s.seg_id for s in self.segments],
                      "max_seq_no": self._seq_no,
                      "seg_counter": self._seg_counter,
                      "translog_generation": self.translog.generation,
                      "primary_term": self.primary_term,
                      # per-doc terms survive restart so the durability
                      # digest stays copy-comparable (term 1 implicit)
                      "doc_terms": {k: v for k, v in
                                    self._doc_terms.items() if v > 1}}
            tmp = os.path.join(self.data_path, self.COMMIT_FILE + ".tmp")
            with open(tmp, "w") as f:
                json.dump(commit, f)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, os.path.join(self.data_path, self.COMMIT_FILE))
            if not self.retention_leases:
                self.translog.trim(self.translog.generation)
                self._gen_max_seq.clear()
            else:
                # trim only the generations EVERY lease has moved past:
                # history stays bounded by the slowest replica's
                # checkpoint, not unbounded (RetentionLease semantics)
                floor = min(self.retention_leases.values())
                keep = self.translog.generation
                for gen in sorted(self._gen_max_seq):
                    if self._gen_max_seq[gen] > floor:
                        keep = min(keep, gen)
                        break
                self.translog.trim(keep)
                for gen in [g for g in self._gen_max_seq if g < keep]:
                    del self._gen_max_seq[gen]
            # Delete tombstones at or below the committed max seq-no are
            # durable in the persisted live bitmaps now — prune them so a
            # delete-heavy workload doesn't grow the version map forever
            # (the reference's GC-deletes keyed on checkpoint advancement).
            committed_seq = commit["max_seq_no"]
            # ...but never prune a tombstone still backed only by the
            # replica op buffer: until a checkpoint installs, no local
            # segment live-bitmap reflects the delete, and dropping the
            # entry would let a replica realtime GET resurrect the doc
            # from an older installed segment (mirrors refresh() above).
            self._version_map = {
                k: v for k, v in self._version_map.items()
                if not (v.deleted and v.seq_no <= committed_seq
                        and v.seq_no not in self._replica_ops)}
            # the new commit no longer references merged-away segments —
            # their files are safe to delete now
            for seg_id in self._obsolete_files:
                delete_segment_files(seg_dir, seg_id)
            self._obsolete_files.clear()
            return commit

    def force_merge(self, max_num_segments: int = 1) -> int:
        """Rewrite live docs into ``max_num_segments`` fresh segments
        (OpenSearchTieredMergePolicy's forced path; renumbers docs like a
        Lucene merge)."""
        with self._lock:
            self._ensure_open()
            self.refresh()
            if len(self.segments) <= max_num_segments:
                return len(self.segments)
            live_docs = []
            for seg in self.segments:
                for local in range(seg.n_docs):
                    if seg.live[local]:
                        doc = self.mapper.parse(seg.doc_ids[local],
                                                seg.source(local),
                                                routing=seg.routings.get(
                                                    local))
                        doc.seq_no = int(seg.seq_nos[local])
                        doc.version = int(seg.versions[local])
                        live_docs.append(doc)
            old = self.segments
            self.segments = []
            if live_docs:
                per = max(1, -(-len(live_docs) // max_num_segments))
                for i in range(0, len(live_docs), per):
                    seg_id = f"seg_{self._engine_uid}_{self._seg_counter}"
                    self._seg_counter += 1
                    self.segments.append(self._writer.build(
                        live_docs[i: i + per], seg_id,
                        vector_meta=self._vector_meta()))
            for seg in old:
                if seg.seg_id in self._persisted_segments:
                    # defer file deletion until the next commit point no
                    # longer references them (crash-safe)
                    self._obsolete_files.add(seg.seg_id)
                    self._persisted_segments.discard(seg.seg_id)
                self._live_dirty.discard(seg.seg_id)
            self._searcher = None
            return len(self.segments)

    # -- stats ------------------------------------------------------------

    def doc_count(self) -> int:
        with self._lock:
            n = sum(1 for d in self._hot if d is not None)
            vm_deleted = 0
            n += sum(s.live_count() for s in self.segments)
            for seg, local in self._pending_deletes:
                if seg.live[local]:
                    vm_deleted += 1
            return n - vm_deleted

    @property
    def max_seq_no(self) -> int:
        return self._seq_no

    def stats(self) -> dict:
        with self._lock:
            return {
                "docs": {"count": self.doc_count()},
                "segments": {"count": len(self.segments)},
                "seq_no": {"max_seq_no": self._seq_no,
                           "local_checkpoint": self._local_ckpt,
                           "global_checkpoint": self.global_checkpoint,
                           "primary_term": self.primary_term},
                "translog": {"generation": self.translog.generation},
            }
