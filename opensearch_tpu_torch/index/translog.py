"""Per-shard write-ahead log (the port of the JAX package's
``index/translog.py``; host only, without the sync-time metric).

Analog of ``index/translog/Translog.java`` (add :541, ensureSynced :821,
rollGeneration :1703) and ``TranslogWriter``/``Checkpoint``: operations are
appended to a generation file before being acknowledged, fsynced per the
durability policy, and replayed on recovery for every op newer than the
last commit's max seq-no.

Format: one op per line — ``<crc32 hex 8>`` + JSON payload.  A checkpoint
file records the current generation and the minimum generation still
needed (everything below was committed into segments).  Torn tails (a
partial last line after kill -9) are detected by the CRC and discarded,
like the reference's checksummed operation framing.
"""

from __future__ import annotations

import json
import os
import threading
import zlib
from typing import Iterator, Optional

from opensearch_tpu_torch.common.errors import OpenSearchTpuError


class TranslogCorruptedError(OpenSearchTpuError):
    status = 500


class Translog:
    CHECKPOINT = "translog.ckp"

    def __init__(self, path: str, durability: str = "request"):
        """durability: ``request`` = fsync on every sync() call (the caller
        syncs before acking), ``async`` = fsync only on roll/close (the
        engine's async fsync interval syncs periodically)."""
        self.path = path
        self.durability = durability
        os.makedirs(path, exist_ok=True)
        ckp = self._read_checkpoint()
        if ckp is None:
            self.generation = 1
            self.min_generation = 1
            self._write_checkpoint()
        else:
            self.generation = ckp["generation"]
            self.min_generation = ckp["min_generation"]
        # a torn tail (kill -9 mid-append) must be truncated BEFORE we
        # append again, or the next op would merge with the garbage bytes
        # into one bad-CRC line and a later recovery would drop it.
        # synced_offset = bytes of the active generation known durable
        # (below it corruption means acked data loss -> raise; at/past it
        # the ops were never acked, so truncation is always safe).
        synced = 0
        if ckp is not None and ckp.get("generation") == self.generation:
            synced = int(ckp.get("synced_offset", 0))
        self._truncate_torn_tail(self._gen_path(self.generation), synced)
        # append-only WAL: durability comes from sync()'s fsync +
        # checkpoint high-water mark, CRC recovery # non-durable-ok
        self._file = open(self._gen_path(self.generation), "ab")
        self._synced_offset = synced
        self._ops_since_sync = 0
        # serializes sync()'s fsync + checkpoint replace: concurrent
        # write RPCs each call ensure_synced() before acking, and two
        # unserialized checkpoint writers race the same .ckp.tmp rename
        # (found by the chaos-soak harness's concurrent bulk workload)
        self._sync_lock = threading.Lock()

    @staticmethod
    def _truncate_torn_tail(path: str, synced_offset: int = 0):
        """Truncate a torn tail so the generation can be appended to again.

        Corruption BELOW ``synced_offset`` (the fsync high-water mark from
        the checkpoint) followed by a later valid record means acked ops
        would be silently discarded by truncation — raise instead
        (reference: TranslogCorruptedException for non-tail corruption).
        Corruption at/past the synced offset was never acked: out-of-order
        page writeback can persist a later unacked op but not an earlier
        one, so truncating from the first bad byte is always safe there."""
        if not os.path.exists(path):
            if synced_offset > 0:
                raise TranslogCorruptedError(
                    f"translog [{path}] is missing but its checkpoint "
                    f"records {synced_offset} fsynced bytes")
            return

        def line_ok(line: bytes) -> bool:
            if len(line) < 8:
                return False
            try:
                expected = int(line[:8], 16)
            except ValueError:
                return False
            return (zlib.crc32(line[8:]) & 0xFFFFFFFF) == expected

        with open(path, "rb") as f:
            data = f.read()
        good_end = 0
        first_bad = None
        pos = 0
        while pos < len(data):
            nl = data.find(b"\n", pos)
            line = data[pos: nl if nl >= 0 else len(data)]
            terminated = nl >= 0
            if not line and terminated:   # blank line, keep walking
                if first_bad is None:
                    good_end = nl + 1
                pos = nl + 1
                continue
            if terminated and line_ok(line):
                if first_bad is None:
                    good_end = nl + 1
                # else: bad region followed by valid ops — handled below
                # (fatal iff the bad region starts below the fsync mark)
            else:
                # bad or unterminated line: candidate torn tail
                if first_bad is None:
                    first_bad = pos
            pos = nl + 1 if terminated else len(data)
        if len(data) < synced_offset:
            raise TranslogCorruptedError(
                f"translog [{path}] is shorter ({len(data)}) than its fsync "
                f"high-water mark ({synced_offset}) — acked ops are missing")
        if first_bad is not None and first_bad < synced_offset:
            # corruption inside the acked region — whether or not valid
            # records follow, truncating would silently drop fsynced ops
            raise TranslogCorruptedError(
                f"translog [{path}] is corrupt at byte [{first_bad}] below "
                f"the fsync high-water mark ({synced_offset}) — acked ops "
                "are corrupt, refusing to truncate them away")
        if good_end < len(data):
            # in-place truncation of an UNACKED tail: the fsync below
            # persists it; rename can't shorten # non-durable-ok
            with open(path, "r+b") as f:
                f.truncate(good_end)
                f.flush()
                os.fsync(f.fileno())

    # -- paths / checkpoint ----------------------------------------------

    def _gen_path(self, gen: int) -> str:
        return os.path.join(self.path, f"translog-{gen}.log")

    def _read_checkpoint(self) -> Optional[dict]:
        p = os.path.join(self.path, self.CHECKPOINT)
        if not os.path.exists(p):
            return None
        with open(p) as f:
            return json.load(f)

    def _write_checkpoint(self):
        p = os.path.join(self.path, self.CHECKPOINT)
        tmp = p + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"generation": self.generation,
                       "min_generation": self.min_generation,
                       "synced_offset": getattr(self, "_synced_offset", 0)},
                      f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, p)

    # -- write path -------------------------------------------------------

    @staticmethod
    def encode(op: dict) -> bytes:
        """Serialize an op up front so callers can fail BEFORE mutating any
        engine state (write-path atomicity)."""
        return json.dumps(op, separators=(",", ":")).encode()

    def add(self, op: dict):
        """Append one operation (no fsync — call sync() before acking)."""
        self.add_encoded(self.encode(op))

    def add_encoded(self, payload: bytes):
        crc = zlib.crc32(payload) & 0xFFFFFFFF
        self._file.write(f"{crc:08x}".encode() + payload + b"\n")
        self._ops_since_sync += 1

    def sync(self):
        """Durability barrier (ensureSynced analog).  Advances the fsync
        high-water mark in the checkpoint, like the reference's per-sync
        Checkpoint file — recovery uses it to tell acked-data corruption
        (fatal) from unacked-tail garbage (truncatable)."""
        with self._sync_lock:
            if self._ops_since_sync == 0 and \
                    self._synced_offset == self._file.tell():
                return   # already durable: skip the double fsync per op
            self._file.flush()
            os.fsync(self._file.fileno())
            self._synced_offset = self._file.tell()
            self._ops_since_sync = 0
            self._write_checkpoint()

    def roll_generation(self):
        """Start a new generation file (pre-commit, rollGeneration analog)."""
        self.sync()
        self._file.close()
        self.generation += 1
        # non-durable-ok: fresh append-only generation (see __init__)
        self._file = open(self._gen_path(self.generation), "ab")
        self._synced_offset = 0
        self._write_checkpoint()

    def trim_above(self, seq_no: int):
        """Append a trim marker: retained ops with ``seq_no`` ABOVE the cut
        are dropped on replay (Translog.trimOperations /
        trimOperationsOfPreviousPrimaryTerms analog).  Used when a deposed
        primary (or a divergent replica) rolls back ops above the global
        checkpoint before rejoining the new primary's lineage — the WAL
        stays append-only, so the rollback itself is as durable as the ops
        it cancels."""
        self.add({"_trim_above": int(seq_no)})
        self.sync()

    def trim(self, min_generation: int):
        """Delete generations below ``min_generation`` (post-commit)."""
        min_generation = min(min_generation, self.generation)
        for gen in range(self.min_generation, min_generation):
            p = self._gen_path(gen)
            if os.path.exists(p):
                os.remove(p)
        self.min_generation = min_generation
        self._write_checkpoint()

    def close(self):
        if not self._file.closed:
            self.sync()
            self._file.close()

    # -- recovery ---------------------------------------------------------

    def read_ops(self, min_seq_no: int = -1) -> Iterator[dict]:
        """Replay all retained ops with seq_no > min_seq_no, oldest first.
        A corrupt NON-tail line raises; a corrupt tail (torn final write)
        is discarded silently, matching reference recovery semantics.
        ``_trim_above`` markers (see trim_above) cancel earlier retained
        ops above their cut and are never yielded themselves — a resync op
        re-written at the same seq under the new term lands after the
        marker, so replay converges on the post-rollback state."""
        buffered: list[dict] = []
        for gen in range(self.min_generation, self.generation + 1):
            p = self._gen_path(gen)
            if not os.path.exists(p):
                continue
            if gen == self.generation and not self._file.closed:
                self._file.flush()
            with open(p, "rb") as f:
                lines = f.read().split(b"\n")
            for i, line in enumerate(lines):
                if not line:
                    continue
                is_tail = (gen == self.generation and i >= len(lines) - 2)
                if len(line) < 8:
                    if is_tail:
                        break
                    raise TranslogCorruptedError(
                        f"translog generation [{gen}] line [{i}] truncated")
                crc_hex, payload = line[:8], line[8:]
                try:
                    expected = int(crc_hex, 16)
                except ValueError:
                    if is_tail:
                        break
                    raise TranslogCorruptedError(
                        f"translog generation [{gen}] line [{i}] bad header")
                if (zlib.crc32(payload) & 0xFFFFFFFF) != expected:
                    if is_tail:
                        break
                    raise TranslogCorruptedError(
                        f"translog generation [{gen}] line [{i}] checksum mismatch")
                op = json.loads(payload)
                if "_trim_above" in op:
                    cut = int(op["_trim_above"])
                    buffered = [o for o in buffered
                                if o.get("seq_no", -1) <= cut]
                    continue
                buffered.append(op)
        for op in buffered:
            if op.get("seq_no", -1) > min_seq_no:
                yield op

    def ops_count(self) -> int:
        return sum(1 for _ in self.read_ops())
