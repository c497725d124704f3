"""On-disk segment format (the port of the JAX package's
``index/store.py``; the format is the reference's, so a store written by
one package opens in the other).

Analog of the Lucene codec + ``index/store/Store.java``: one ``.npz`` of
flat arrays + one ``.json`` of dictionaries/metadata + one ``.src`` blob of
concatenated _source bytes per segment.  Arrays are written exactly as the
in-memory Segment holds them (the device staging re-pads on load), and the
live-docs bitmap is rewritten in place on delete-commit like Lucene's
``.liv`` files.

Durability + integrity (the ``CodecUtil.checkFooter`` / ``Store.verify``
analogs): every segment commit writes its data files tmp+fsync+rename and
then commits them with ONE atomic rename of a ``<seg_id>.manifest`` file
recording the length and CRC32 of every data file — a crash anywhere in
the sequence leaves either no manifest (the segment never existed) or a
manifest whose files all verify.  ``load_segment`` / ``verify_segment``
check every byte against the manifest before decoding and raise
``CorruptIndexError`` naming the offending file; the ``.liv`` sidecar
(rewritten on delete-commit, so it can't live in the immutable manifest)
carries its own CRC32 footer-style header instead.  A detected corruption
is recorded as a ``corrupted_<seg_id>.json`` marker in the segment
directory (``Store.markStoreCorrupted`` / ``CorruptedFileException``) and
a marked store refuses to open until the copy is dropped and re-recovered.
"""

from __future__ import annotations

import io
import json
import os
import zlib

import numpy as np

from opensearch_tpu_torch.common.errors import OpenSearchTpuError
from opensearch_tpu_torch.index.codec import QuantizedPostings
from opensearch_tpu_torch.index.segment import (
    GeoDV,
    NestedBlock,
    NumericDV,
    OrdinalDV,
    PostingsField,
    Segment,
    VectorDV,
)


class CorruptIndexError(OpenSearchTpuError):
    status = 500


def _segment_encode(seg: Segment):
    """Split a Segment into (arrays, meta, src_bytes) — shared by the
    on-disk writer and the wire serializer (segment replication file copy,
    ref indices/replication/SegmentReplicationTargetService.java:208)."""
    arrays: dict[str, np.ndarray] = {
        "seq_nos": seg.seq_nos, "versions": seg.versions, "live": seg.live,
    }
    meta = {"seg_id": seg.seg_id, "n_docs": seg.n_docs,
            "doc_ids": seg.doc_ids,
            "routings": {str(k): v for k, v in seg.routings.items()},
            "completion_weights": {
                f: {f"{local}\x00{text}": w
                    for (local, text), w in wmap.items()}
                for f, wmap in seg.completion_weights.items()},
            "postings": {}, "numeric": {}, "ordinal": {}, "vector": {},
            "geo": {}, "nested": {}}

    src_offsets = np.zeros(len(seg.sources) + 1, dtype=np.int64)
    for i, b in enumerate(seg.sources):
        src_offsets[i + 1] = src_offsets[i] + len(b)
    arrays["src_offsets"] = src_offsets

    for f, pf in seg.postings.items():
        meta["postings"][f] = {
            "terms": list(pf.terms), "total_len": pf.total_len,
            "docs_with_field": pf.docs_with_field, "has_norms": pf.has_norms,
        }
        for k in ("df", "offsets", "doc_ids", "tfs", "pos_offsets",
                  "positions", "doc_lens", "present"):
            arrays[f"p|{f}|{k}"] = getattr(pf, k)
    for f, dv in seg.numeric_dv.items():
        meta["numeric"][f] = {"kind": dv.kind}
        for k in ("offsets", "values", "value_docs", "minv", "maxv", "exists"):
            arrays[f"n|{f}|{k}"] = getattr(dv, k)
    for f, dv in seg.ordinal_dv.items():
        meta["ordinal"][f] = {"ord_terms": dv.ord_terms}
        for k in ("offsets", "ords", "value_docs", "min_ord", "max_ord",
                  "exists"):
            arrays[f"o|{f}|{k}"] = getattr(dv, k)
    for f, dv in seg.vector_dv.items():
        meta["vector"][f] = {"dim": dv.dim, "similarity": dv.similarity}
        arrays[f"v|{f}|values"] = dv.values
        arrays[f"v|{f}|exists"] = dv.exists
    for f, dv in seg.geo_dv.items():
        meta["geo"][f] = {}
        for k in ("offsets", "lats", "lons", "value_docs", "exists"):
            arrays[f"g|{f}|{k}"] = getattr(dv, k)
    for path, block in seg.nested.items():
        meta["nested"][path] = {
            "numeric_fields": sorted(block.numeric),
            "ordinal_fields": sorted(block.ordinal),
            "ord_terms": {f: block.ordinal[f][0] for f in block.ordinal},
        }
        arrays[f"x|{path}|obj_to_doc"] = block.obj_to_doc
        for f, (values, value_objs) in block.numeric.items():
            arrays[f"x|{path}|n|{f}|values"] = values
            arrays[f"x|{path}|n|{f}|objs"] = value_objs
        for f, (_terms, ords, value_objs) in block.ordinal.items():
            arrays[f"x|{path}|o|{f}|ords"] = ords
            arrays[f"x|{path}|o|{f}|objs"] = value_objs
    return arrays, meta, b"".join(seg.sources)


CODECS = ("default", "best_compression")

MANIFEST_SUFFIX = ".manifest"
_DATA_SUFFIXES = (".json", ".npz", ".src")


def file_checksum(data: bytes) -> dict:
    """The per-file integrity record the manifest carries (CodecUtil
    footer analog: length + CRC32 over the whole payload)."""
    return {"length": len(data), "crc32": zlib.crc32(data) & 0xFFFFFFFF}


def write_durable(path: str, data: bytes):
    """tmp + fsync + atomic rename — the only sanctioned way a file
    reaches its final name in the segment store."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def write_segment_manifest(dirpath: str, seg_id: str, entries: dict):
    """Commit point of a segment: one atomic rename installing the
    manifest that names every data file with its length + CRC32."""
    payload = json.dumps({"seg_id": seg_id, "files": entries},
                         sort_keys=True).encode()
    write_durable(os.path.join(dirpath, seg_id + MANIFEST_SUFFIX), payload)


def read_segment_manifest(dirpath: str, seg_id: str):
    p = os.path.join(dirpath, seg_id + MANIFEST_SUFFIX)
    if not os.path.exists(p):
        return None     # pre-manifest directory (legacy, unverifiable)
    try:
        with open(p, "rb") as f:
            m = json.loads(f.read().decode())
        if not isinstance(m.get("files"), dict):
            raise ValueError("manifest has no [files] map")
        return m
    except (OSError, ValueError) as e:
        raise CorruptIndexError(
            f"segment manifest [{seg_id}{MANIFEST_SUFFIX}] is unreadable: "
            f"{e}") from e


def _verify_bytes(name: str, data: bytes, want: dict):
    got = file_checksum(data)
    if got["length"] != int(want["length"]):
        raise CorruptIndexError(
            f"segment file [{name}] length mismatch: manifest records "
            f"{want['length']} bytes, found {got['length']}")
    if got["crc32"] != int(want["crc32"]):
        raise CorruptIndexError(
            f"segment file [{name}] checksum mismatch: manifest records "
            f"crc32 [{want['crc32']:08x}], found [{got['crc32']:08x}]")


def _read_verified(dirpath: str, name: str, manifest) -> bytes:
    path = os.path.join(dirpath, name)
    try:
        with open(path, "rb") as f:
            data = f.read()
    except OSError as e:
        raise CorruptIndexError(
            f"cannot read segment file [{name}]: {e}") from e
    if manifest is not None:
        want = manifest["files"].get(name)
        if want is None:
            raise CorruptIndexError(
                f"segment file [{name}] is not recorded in its manifest")
        _verify_bytes(name, data, want)
    return data


def _encode_liv(live: np.ndarray) -> bytes:
    buf = io.BytesIO()
    np.save(buf, live)
    payload = buf.getvalue()
    crc = zlib.crc32(payload) & 0xFFFFFFFF
    return f"{crc:08x}".encode() + payload


def _decode_liv(seg_id: str, data: bytes) -> np.ndarray:
    """The .liv sidecar is rewritten on every delete-commit, so it lives
    OUTSIDE the immutable manifest and carries its own CRC32 header
    (8 hex bytes) — legacy raw ``np.save`` payloads (starting with the
    numpy magic, never valid hex) load unverified."""
    head = data[:8]
    try:
        expected = int(head, 16)
    except ValueError:
        return np.load(io.BytesIO(data)).copy()   # legacy, unverifiable
    payload = data[8:]
    if (zlib.crc32(payload) & 0xFFFFFFFF) != expected:
        raise CorruptIndexError(
            f"segment file [{seg_id}.liv] checksum mismatch")
    try:
        return np.load(io.BytesIO(payload)).copy()
    except ValueError as e:
        raise CorruptIndexError(
            f"segment file [{seg_id}.liv] is undecodable: {e}") from e


def quant_sidecar_name(seg_id: str, field: str) -> str:
    return f"{seg_id}.{field}.quant"


def _encode_quant(qt) -> bytes:
    buf = io.BytesIO()
    meta = json.dumps({"width": int(qt.width), "dtype": qt.dtype,
                       "avgdl": float(qt.avgdl), "stats": qt.stats},
                      sort_keys=True).encode()
    np.savez(buf, qvals=qt.qvals, scales=qt.scales,
             exact_vals=qt.exact_vals, exact_offsets=qt.exact_offsets,
             packed=qt.packed, base=qt.base,
             meta=np.frombuffer(meta, dtype=np.uint8))
    payload = buf.getvalue()
    crc = zlib.crc32(payload) & 0xFFFFFFFF
    return f"{crc:08x}".encode() + payload


def save_quantized_tables(dirpath: str, seg_id: str, field: str, qt):
    """Persist one field's quantized tables (index/codec.py) as a
    ``<seg_id>.<field>.quant`` sidecar.  Like ``.liv`` it lives OUTSIDE
    the immutable commit manifest — it is an avgdl-dependent cache a
    refresh/merge can obsolete — so it carries its own CRC32 header and
    the reader treats any mismatch as 'absent', never as a failure."""
    os.makedirs(dirpath, exist_ok=True)
    write_durable(
        os.path.join(dirpath, quant_sidecar_name(seg_id, field)),
        _encode_quant(qt))


def load_quantized_tables(dirpath: str, seg_id: str, field: str,
                          avgdl: float | None = None):
    """Load a ``.quant`` sidecar.  Returns None when the file is absent
    or was built for a different avgdl (stale — the caller rebuilds);
    raises ``CorruptIndexError`` naming the file on checksum/decode
    failure (the caller degrades to recompute-and-rewrite)."""
    name = quant_sidecar_name(seg_id, field)
    path = os.path.join(dirpath, name)
    if not os.path.exists(path):
        return None
    with open(path, "rb") as f:
        data = f.read()
    try:
        expected = int(data[:8], 16)
    except ValueError as e:
        raise CorruptIndexError(
            f"segment file [{name}] has no checksum header") from e
    payload = data[8:]
    if (zlib.crc32(payload) & 0xFFFFFFFF) != expected:
        raise CorruptIndexError(
            f"segment file [{name}] checksum mismatch")
    try:
        z = np.load(io.BytesIO(payload))
        meta = json.loads(z["meta"].tobytes().decode())
        qt = QuantizedPostings(
            qvals=z["qvals"], scales=z["scales"],
            exact_vals=z["exact_vals"], exact_offsets=z["exact_offsets"],
            packed=z["packed"], base=z["base"],
            width=int(meta["width"]), dtype=meta["dtype"],
            avgdl=float(meta["avgdl"]),
            stats=dict(meta.get("stats") or {}))
    except (ValueError, KeyError) as e:
        raise CorruptIndexError(
            f"segment file [{name}] is undecodable: {e}") from e
    if avgdl is not None and float(np.float32(avgdl)) != qt.avgdl:
        return None        # stale (avgdl moved under a refresh/merge)
    return qt


def save_segment(seg: Segment, dirpath: str, codec: str = "default"):
    """``codec`` mirrors the reference's two stored-field codecs (ref
    index/codec/CodecService.java:46 — LZ4 "default" vs zstd/DEFLATE
    "best_compression", the index.codec setting): best_compression
    deflates the arrays (compressed npz) and the _source blob, trading
    write CPU for disk; the read path is self-describing via meta.

    Commit discipline: data files land tmp+fsync+rename (invisible to
    readers — nothing references them yet), then the manifest rename is
    the single atomic commit point.  A crash between any two steps
    leaves the previous committed state fully intact."""
    if codec not in CODECS:
        raise OpenSearchTpuError(f"unknown codec [{codec}]")
    os.makedirs(dirpath, exist_ok=True)
    arrays, meta, src_bytes = _segment_encode(seg)
    compress = codec == "best_compression"
    if compress:
        meta["src_codec"] = "zlib"
        src_bytes = zlib.compress(src_bytes, 6)
    buf = io.BytesIO()
    (np.savez_compressed if compress else np.savez)(buf, **arrays)
    entries = {}
    for suffix, data in ((".src", src_bytes), (".npz", buf.getvalue()),
                         (".json", json.dumps(meta).encode())):
        name = seg.seg_id + suffix
        write_durable(os.path.join(dirpath, name), data)
        entries[name] = file_checksum(data)
    write_segment_manifest(dirpath, seg.seg_id, entries)
    # freshly-saved segments persist quantized sidecars here too, not
    # only after a load (mirrors load_segment)
    seg.quant_dir = dirpath


def save_live(seg: Segment, dirpath: str):
    """Rewrite only the live-docs bitmap (Lucene .liv analog); the CRC
    header makes the file self-verifying (see ``_decode_liv``)."""
    write_durable(os.path.join(dirpath, seg.seg_id + ".liv"),
                  _encode_liv(seg.live))


def load_segment(dirpath: str, seg_id: str) -> Segment:
    """Read, VERIFY (against the commit manifest), then decode — a
    checksum mismatch raises ``CorruptIndexError`` naming the file
    before any bytes are interpreted (Store.verify-on-open)."""
    manifest = read_segment_manifest(dirpath, seg_id)
    try:
        json_b = _read_verified(dirpath, seg_id + ".json", manifest)
        npz_b = _read_verified(dirpath, seg_id + ".npz", manifest)
        src_blob = _read_verified(dirpath, seg_id + ".src", manifest)
        meta = json.loads(json_b.decode())
        z = np.load(io.BytesIO(npz_b))
        if meta.get("src_codec") == "zlib":
            src_blob = zlib.decompress(src_blob)
    except CorruptIndexError:
        raise
    except (OSError, ValueError, zlib.error) as e:
        raise CorruptIndexError(f"cannot read segment [{seg_id}]: {e}") from e
    seg = _segment_decode(seg_id, meta, z, src_blob)
    liv_path = os.path.join(dirpath, seg_id + ".liv")
    if os.path.exists(liv_path):
        with open(liv_path, "rb") as f:
            seg.live = _decode_liv(seg_id, f.read())
    # quantized-table sidecars load lazily from here (and fresh builds
    # write back) — see Segment.quantized_table
    seg.quant_dir = dirpath
    return seg


def verify_segment(dirpath: str, seg_id: str) -> bool:
    """Checksum-only pass over a committed segment's on-disk files —
    the ``Store.verify`` analog (no decoding, no allocation of decoded
    structures).  Returns False when the segment predates manifests
    (nothing to verify against); raises ``CorruptIndexError`` naming
    the first bad file."""
    manifest = read_segment_manifest(dirpath, seg_id)
    liv_path = os.path.join(dirpath, seg_id + ".liv")
    if os.path.exists(liv_path):
        with open(liv_path, "rb") as f:
            _decode_liv(seg_id, f.read())
    if os.path.isdir(dirpath):
        # self-verified sidecars (CRC header, outside the manifest)
        for fname in sorted(os.listdir(dirpath)):
            if fname.startswith(seg_id + ".") and fname.endswith(".quant"):
                field = fname[len(seg_id) + 1: -len(".quant")]
                load_quantized_tables(dirpath, seg_id, field)
    if manifest is None:
        return False
    for name in sorted(manifest["files"]):
        _read_verified(dirpath, name, manifest)
    return True


# -- corruption markers (Store.markStoreCorrupted analog) -------------------

_MARKER_PREFIX = "corrupted_"


def write_corruption_marker(dirpath: str, seg_id: str, reason: str):
    """Persist the verdict so the store refuses to reopen until the copy
    is dropped and re-recovered (Store.failIfCorrupted)."""
    os.makedirs(dirpath, exist_ok=True)
    write_durable(
        os.path.join(dirpath, f"{_MARKER_PREFIX}{seg_id}.json"),
        json.dumps({"segment": seg_id, "reason": reason},
                   sort_keys=True).encode())


def find_corruption_markers(dirpath: str) -> list[dict]:
    out = []
    if not os.path.isdir(dirpath):
        return out
    for fname in sorted(os.listdir(dirpath)):
        if not fname.startswith(_MARKER_PREFIX) \
                or not fname.endswith(".json") or fname.endswith(".tmp"):
            continue
        try:
            with open(os.path.join(dirpath, fname), "rb") as f:
                out.append(json.loads(f.read().decode()))
        except (OSError, ValueError):
            out.append({"segment": fname[len(_MARKER_PREFIX):-len(".json")],
                        "reason": "unreadable corruption marker"})
    return out


def clear_corruption_markers(dirpath: str):
    if not os.path.isdir(dirpath):
        return
    for fname in list(os.listdir(dirpath)):
        if fname.startswith(_MARKER_PREFIX) and fname.endswith(".json"):
            os.remove(os.path.join(dirpath, fname))


# -- wire serialization (recovery / segment replication file copy) ----------


def segment_to_blobs(seg: Segment) -> dict:
    """Serialize a segment to wire-shippable blobs {json, npz, src} — the
    'file copy' unit of segment replication and peer recovery phase 1
    (ref indices/recovery/RecoverySourceHandler.java:105).  Each blob's
    length + CRC32 travels alongside, so the receiving replica verifies
    the copy before installing it (RecoveryTarget's per-chunk checksum)."""
    arrays, meta, src_bytes = _segment_encode(seg)
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    blobs = {"json": json.dumps(meta).encode(), "npz": buf.getvalue(),
             "src": src_bytes}
    blobs["checksums"] = {k: file_checksum(v) for k, v in blobs.items()}
    return blobs


def segment_from_blobs(blobs: dict) -> Segment:
    checksums = blobs.get("checksums")
    try:
        if checksums is not None:
            for part in ("json", "npz", "src"):
                want = checksums.get(part)
                if want is not None:
                    _verify_bytes(f"<wire>.{part}", blobs[part], want)
        meta = json.loads(blobs["json"].decode())
        z = np.load(io.BytesIO(blobs["npz"]))
    except CorruptIndexError:
        raise
    except (KeyError, ValueError) as e:
        raise CorruptIndexError(f"cannot decode segment blobs: {e}") from e
    return _segment_decode(meta["seg_id"], meta, z, blobs["src"])


def _segment_decode(seg_id: str, meta: dict, z, src_blob: bytes) -> Segment:
    seg = Segment(seg_id, meta["n_docs"])
    seg.doc_ids = list(meta["doc_ids"])
    seg.id_to_local = {d: i for i, d in enumerate(seg.doc_ids)}
    seg.routings = {int(k): v
                    for k, v in (meta.get("routings") or {}).items()}
    for f, wmap in (meta.get("completion_weights") or {}).items():
        out = {}
        for key, w in wmap.items():
            local, _, text = key.partition("\x00")
            out[(int(local), text)] = w
        seg.completion_weights[f] = out
    seg.seq_nos = z["seq_nos"]
    seg.versions = z["versions"]
    seg.live = z["live"].copy()
    src_offsets = z["src_offsets"]
    seg.sources = [src_blob[src_offsets[i]: src_offsets[i + 1]]
                   for i in range(meta["n_docs"])]
    for f, m in meta["postings"].items():
        seg.postings[f] = PostingsField(
            terms={t: i for i, t in enumerate(m["terms"])},
            df=z[f"p|{f}|df"], offsets=z[f"p|{f}|offsets"],
            doc_ids=z[f"p|{f}|doc_ids"], tfs=z[f"p|{f}|tfs"],
            pos_offsets=z[f"p|{f}|pos_offsets"],
            positions=z[f"p|{f}|positions"], doc_lens=z[f"p|{f}|doc_lens"],
            total_len=m["total_len"], docs_with_field=m["docs_with_field"],
            has_norms=m["has_norms"], present=z[f"p|{f}|present"])
    for f, m in meta["numeric"].items():
        seg.numeric_dv[f] = NumericDV(
            kind=m["kind"], offsets=z[f"n|{f}|offsets"],
            values=z[f"n|{f}|values"], value_docs=z[f"n|{f}|value_docs"],
            minv=z[f"n|{f}|minv"], maxv=z[f"n|{f}|maxv"],
            exists=z[f"n|{f}|exists"])
    for f, m in meta["ordinal"].items():
        seg.ordinal_dv[f] = OrdinalDV(
            ord_terms=list(m["ord_terms"]),
            term_to_ord={t: i for i, t in enumerate(m["ord_terms"])},
            offsets=z[f"o|{f}|offsets"], ords=z[f"o|{f}|ords"],
            value_docs=z[f"o|{f}|value_docs"], min_ord=z[f"o|{f}|min_ord"],
            max_ord=z[f"o|{f}|max_ord"], exists=z[f"o|{f}|exists"])
    for f, m in meta["vector"].items():
        seg.vector_dv[f] = VectorDV(
            values=z[f"v|{f}|values"], exists=z[f"v|{f}|exists"],
            dim=m["dim"], similarity=m["similarity"])
    for path, m in meta.get("nested", {}).items():
        block = NestedBlock(obj_to_doc=z[f"x|{path}|obj_to_doc"])
        for f in m["numeric_fields"]:
            block.numeric[f] = (z[f"x|{path}|n|{f}|values"],
                                z[f"x|{path}|n|{f}|objs"])
        for f in m["ordinal_fields"]:
            block.ordinal[f] = (list(m["ord_terms"][f]),
                                z[f"x|{path}|o|{f}|ords"],
                                z[f"x|{path}|o|{f}|objs"])
        seg.nested[path] = block
    for f, m in meta["geo"].items():
        seg.geo_dv[f] = GeoDV(
            offsets=z[f"g|{f}|offsets"], lats=z[f"g|{f}|lats"],
            lons=z[f"g|{f}|lons"], value_docs=z[f"g|{f}|value_docs"],
            exists=z[f"g|{f}|exists"])
    return seg


def delete_segment_files(dirpath: str, seg_id: str):
    # manifest first: once it's gone the segment is uncommitted, so a
    # crash mid-deletion can't leave a manifest naming missing files
    for ext in (MANIFEST_SUFFIX, ".npz", ".json", ".src", ".liv"):
        p = os.path.join(dirpath, seg_id + ext)
        if os.path.exists(p):
            os.remove(p)
    if os.path.isdir(dirpath):
        for fname in list(os.listdir(dirpath)):
            if fname.startswith(seg_id + ".") and fname.endswith(".quant"):
                os.remove(os.path.join(dirpath, fname))
