"""Wrappers of K6 and K7, the hand-written IVF / IVF-PQ kernels
(``csrc/ivf.cu``): the counterparts of the JAX package's XLA programs
``ivf_search`` / ``ivf_search_batch`` and ``ivfpq_search_l2``
(``opensearch_tpu/ops/ivf.py``).

- ``ivf_search_segments_cuda`` (K6): every query of ``queries`` against
  every ``ops.ivf.IvfSegment`` (a staged ``IvfIndex``) in one call, the
  probe kernel then the scan kernel.  Plain twin:
  ``ops/ivf.py::ivf_search_segments``.
- ``ivfpq_search_segments_cuda`` (K7): the same over staged
  ``IvfPqIndex``es, l2 ADC scores: the probe, the table pass, the scan.
  Plain twin: ``ops/ivf.py::ivfpq_search_segments``.

Segments returning at most ``K_MAX`` hits keep their top k inside the
scan kernel; the others (``sorted_route_segments`` counts them) take
the same kernels in scores mode over a flat buffer of every probed
slot, then a stable sort on the card.  Neither wrapper falls back to its
plain twin: a CUDA tensor gets the kernels or an exception.
``.launches`` counts the calls that launched (a probe and a scan each,
and K7's table pass).

The work split is built into the library (``defines()`` passes it
with ``-D``; ``testing/k6_sweep.py`` builds variants): ``PROBE_BLOCKS``,
the blocks of the probe's thread-block cluster per (query, segment);
``CHUNK_ROWS`` / ``PQ_CHUNK_ROWS``, the rows a K6 / K7 scan block takes
of its probed cluster (K7's halved above m = 64 so that its codes fit
shared memory; the library's ``ivf_scan_chunk`` says how many, and the
chunks per probe come from the segment's largest cluster,
``StagedIvf.max_rows``); ``STAGE_BYTES``, the size of each of K6's
three row stages; ``SMALL_K``, the largest kp selected in warp
registers; ``PDL``, whether the kernels after the probe are
programmatic dependent launches.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from opensearch_tpu_torch.ops import cuda_build
from opensearch_tpu_torch.ops.cuda_knn import _addr, _expect, _ptr, _upload
from opensearch_tpu_torch.ops.ivf import PQ_CODEWORDS, k_offsets

SPACE_CODES = {"l2": 0, "cosinesimil": 1, "innerproduct": 2}
K_MAX = 256            # largest k kept inside the scan kernel
SEG_WORDS = 16         # int64 words per segment in the launch table
NLIST_MAX = 16_384     # the probe ranks a segment's centroids in shared memory
M_MAX = 128            # K7's LUT: 1 KB of shared memory per subspace
D_MAX = 8_192          # the query in shared memory (float64)
CHUNK_MAX = 1_024      # rows a scan block may take
PROBE_BLOCKS = 8       # the probe's cluster: blocks per (query, segment)
CHUNK_ROWS = 256       # rows a K6 scan block takes
PQ_CHUNK_ROWS = 1_024  # rows a K7 scan block takes up to m = 64
STAGE_BYTES = 16_384   # each of K6's three row stages
SMALL_K = 32           # kp up to this selects in warp registers (0: none)
PDL = 1                # programmatic dependent launches after the probe
# a block's shared memory on sm_90, less the static part
SMEM_MAX = 232_448 - 1_024
# the words of a segment's entry (csrc/ivf.cu)
(W_CENTROIDS, W_ROWS, W_IDS, W_STARTS, W_LIVE, W_CODEBOOKS, W_NLIST,
 W_NPROBE, W_K, W_CPAD, W_PROBE_OFF, W_OUT_COL, W_FLAT_OFF, W_M,
 W_BLOCK_OFF, W_CHUNKS) = range(16)


def defines() -> dict:
    """The macros ``csrc/ivf.cu`` is built with."""
    return {"IVF_K_MAX": K_MAX, "IVF_SEG_WORDS": SEG_WORDS,
            "IVF_NLIST_MAX": NLIST_MAX, "IVF_M_MAX": M_MAX,
            "IVF_D_MAX": D_MAX, "IVF_CHUNK_MAX": CHUNK_MAX,
            "IVF_PROBE_BLOCKS": PROBE_BLOCKS, "IVF_CHUNK_ROWS": CHUNK_ROWS,
            "IVF_PQ_CHUNK_ROWS": PQ_CHUNK_ROWS,
            "IVF_STAGE_BYTES": STAGE_BYTES, "IVF_SMALL_K": SMALL_K,
            "IVF_PDL": PDL}


def _declare(lib):
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.ivf_search_launch.argtypes = [p, i, i, p, i, i, i, i, i, i, i, i, i,
                                      i, i, i, p, p, p, p, p, ll, p, p, p]
    lib.ivf_search_launch.restype = i
    lib.ivf_probe_smem.argtypes = [i, i]
    lib.ivf_scan_smem.argtypes = [i]
    lib.ivfpq_lut_smem.argtypes = [i, i]
    lib.ivfpq_scan_smem.argtypes = [i]
    for name in ("ivf_probe_smem", "ivf_scan_smem", "ivfpq_lut_smem",
                 "ivfpq_scan_smem"):
        getattr(lib, name).restype = ll
    for name in ("ivf_scan_chunk", "ivfpq_lut_cb_floats"):
        getattr(lib, name).argtypes = [i, i]
        getattr(lib, name).restype = i


def _library():
    return cuda_build.library("ivf", _declare, defines())


def k_padded(k: int) -> int:
    """Keys each scan block keeps: ``k`` rounded up to a power of two."""
    return 1 << (int(k) - 1).bit_length()


def chunks_per_probe(staged, chunk: int) -> int:
    """Scan blocks per probe of a segment: its largest cluster's rows in
    chunks of ``chunk`` (at least one)."""
    return max(1, -(-staged.max_rows // chunk))


def _static_words(st) -> np.ndarray:
    """The words of a staged index's table entry that no request changes
    (its arrays, nlist, c_pad, m), kept on the (frozen) index:
    ``launch_table`` copies them, then fills the call's words."""
    words = st.__dict__.get("_table_words")
    if words is None:
        words = np.zeros(SEG_WORDS, np.int64)
        words[W_CENTROIDS] = _addr(st.centroids)
        words[W_ROWS] = _addr(st.codes if st.pq else st.rows)
        words[W_IDS] = _addr(st.ids)
        words[W_STARTS] = _addr(st.starts)
        words[W_CODEBOOKS] = _addr(st.codebooks)
        words[W_NLIST], words[W_CPAD] = st.nlist, st.c_pad
        words[W_M] = st.codes.shape[1] if st.pq else 0
        st.__dict__["_table_words"] = words
    return words


def launch_table(segments, n_queries: int, out_cols, sort_mode: bool,
                 chunk: int):
    """(table int64, p_tot, b_tot, f_tot) of one call over ``segments``
    (``IvfSegment``s; a table entry each, ``SEG_WORDS`` words in the
    order of ``csrc/ivf.cu``'s ``w*`` names), then ``n_queries x
    len(segments)`` pairs of int32 counters (slots posted, blocks done),
    zero.  ``out_cols``: each segment's first output column; ``chunk``:
    rows a scan block takes (the library's ``ivf_scan_chunk``);
    ``p_tot``: the probes of a query over every segment; ``b_tot``: its
    scan blocks (``nprobe`` x the segment's chunks per probe);
    ``f_tot``: in ``sort_mode``, a query's flat slots (``nprobe *
    c_pad`` a segment), else 0."""
    n_seg = len(segments)
    table = np.zeros(n_seg * SEG_WORDS + n_queries * n_seg, np.int64)
    entries = table[: n_seg * SEG_WORDS].reshape(n_seg, SEG_WORDS)
    p_tot = b_tot = f_tot = 0
    for s, (seg, col) in enumerate(zip(segments, out_cols)):
        st = seg.index
        e = entries[s]
        e[:] = _static_words(st)
        e[W_CHUNKS] = chunks_per_probe(st, chunk)
        e[W_LIVE] = _addr(seg.live)
        e[W_NPROBE], e[W_K] = seg.nprobe, seg.k
        e[W_PROBE_OFF], e[W_OUT_COL] = p_tot, col
        e[W_FLAT_OFF] = f_tot if sort_mode else 0
        e[W_BLOCK_OFF] = b_tot
        p_tot += seg.nprobe
        b_tot += seg.nprobe * int(e[W_CHUNKS])
        if sort_mode:
            f_tot += seg.nprobe * st.c_pad
    return table, p_tot, b_tot, f_tot


def _slack(t, name):
    """The scan copies 16-byte windows: ``t`` starts on 16 bytes and its
    storage holds 15 bytes past its end (``ops.ivf.stage_index`` stages
    it so)."""
    storage = t.untyped_storage()
    end = t.data_ptr() + t.numel() * t.element_size()
    if t.data_ptr() % 16 or storage.data_ptr() + storage.nbytes() < end + 15:
        raise ValueError(f"[{name}] must start on 16 bytes with 15 bytes "
                         "of slack past its end (ops.ivf.stage_index)")


def _check_index(st, i: int, dev, d: int, pq: bool, what: str) -> None:
    """A staged index's arrays on ``dev`` at width ``d``.  A (frozen)
    index passes once a device and width: the result is kept on it."""
    key = (dev, d, pq)
    if st.__dict__.get("_checked") == key:
        return
    if st.pq != pq:
        raise TypeError(f"segments[{i}] holds an "
                        f"{'IVF-PQ' if st.pq else 'IVF'} index")
    if not 1 <= st.nlist <= NLIST_MAX:
        raise ValueError(f"{what} takes 1 <= nlist <= {NLIST_MAX}, "
                         f"got {st.nlist}")
    n = st.ids.shape[0]
    _expect(st.centroids, f"segments[{i}].centroids", torch.float32, dev,
            (st.nlist, d))
    _expect(st.ids, f"segments[{i}].ids", torch.int32, dev, (n,))
    _slack(st.ids, f"segments[{i}].ids")
    _expect(st.starts, f"segments[{i}].starts", torch.int32, dev,
            (st.nlist + 1,))
    if pq:
        m = st.codes.shape[1] if st.codes.dim() == 2 else 0
        if not 1 <= m <= M_MAX or d % m:
            raise ValueError(f"{what} takes 1 <= m <= {M_MAX} dividing "
                             f"d={d}, got m={m}")
        _expect(st.codes, f"segments[{i}].codes", torch.uint8, dev, (n, m))
        _slack(st.codes, f"segments[{i}].codes")
        _expect(st.codebooks, f"segments[{i}].codebooks", torch.float32,
                dev, (m, PQ_CODEWORDS, d // m))
        if _addr(st.codebooks) % 16:
            raise ValueError(f"segments[{i}]: codebooks must start on 16 "
                             "bytes")
    else:
        _expect(st.rows, f"segments[{i}].rows", torch.float32, dev, (n, d))
        _slack(st.rows, f"segments[{i}].rows")
        if d % 4 == 0 and _addr(st.centroids) % 16:
            raise ValueError(f"segments[{i}]: centroids must start on 16 "
                             "bytes")
    st.__dict__["_checked"] = key


def _check(segments, queries, pq: bool, what: str):
    """The device, the query width, each segment's request (nprobe, k,
    live mask) and staged index (``_check_index``)."""
    dev = queries.device
    if dev.type != "cuda":
        raise ValueError(f"{what} needs CUDA tensors, got {dev}")
    if queries.dtype != torch.float32 or queries.dim() != 2:
        raise TypeError("queries must be float32 [Q, d]")
    if not queries.is_contiguous():
        raise ValueError("[queries] must be contiguous")
    d = queries.shape[1]
    if not 1 <= d <= D_MAX:
        raise ValueError(f"{what} takes 1 <= d <= {D_MAX}, got d={d}")
    for i, seg in enumerate(segments):
        st = seg.index
        _check_index(st, i, dev, d, pq, what)
        if not 1 <= seg.nprobe <= st.nlist:
            raise ValueError(f"segments[{i}]: nprobe {seg.nprobe} outside "
                             f"1..{st.nlist}")
        if not 1 <= seg.k <= seg.nprobe * st.c_pad or \
                seg.nprobe * st.c_pad >= 2 ** 31:
            raise ValueError(f"segments[{i}]: k {seg.k} outside 1.."
                             f"{seg.nprobe * st.c_pad}")
        live = seg.live
        if live.device != dev or live.dtype != torch.bool or \
                live.dim() != 1 or not live.is_contiguous():
            raise TypeError(f"segments[{i}].live must be a contiguous bool "
                            f"[n] on {dev}")
    return dev, d


def _launch_args(segments, queries, d, pq, space, out=None, cols=None):
    """(library, the arguments of ``ivf_search_launch``, out, the tensors
    the arguments point into) of one call over ``segments``: the launch
    table uploaded, the buffers between the kernels allocated.  Top-k
    mode (``out`` given): each segment's hits into ``out`` = (vals, ids)
    [Q, K] from its column of ``cols``.  Scores mode: ``out`` is made
    here, the flat buffers (vals, ids) [Q, f_tot] of every probed
    slot."""
    dev = queries.device
    lib = _library()
    n_q = queries.shape[0]
    sort_mode = out is None
    nlist_max = max(s.index.nlist for s in segments)
    if pq:
        ms = [s.index.codes.shape[1] for s in segments]
        m_max = max(ms)
        cb_floats = lib.ivfpq_lut_cb_floats(d, min(ms))
        smem = {"probe": lib.ivf_probe_smem(d, nlist_max),
                "table": lib.ivfpq_lut_smem(d, cb_floats),
                "scan": lib.ivfpq_scan_smem(m_max)}
    else:
        m_max = cb_floats = 0
        smem = {"probe": lib.ivf_probe_smem(d, nlist_max),
                "scan": lib.ivf_scan_smem(d)}
    chunk = lib.ivf_scan_chunk(int(pq), m_max)
    if max(smem.values()) > SMEM_MAX:
        raise ValueError(f"a call at d={d}, nlist {nlist_max}, m {m_max} "
                         f"needs {smem} bytes of shared memory a block")
    table, p_tot, b_tot, f_tot = launch_table(
        segments, n_q, cols or [0] * len(segments), sort_mode, chunk)
    table_dev = _upload(table, dev)
    probes = torch.empty((n_q, p_tot), dtype=torch.int32, device=dev)
    lut = (torch.empty(n_q * p_tot * m_max * PQ_CODEWORDS,
                       dtype=torch.float32, device=dev) if pq else None)
    if sort_mode:
        out = (torch.full((n_q, f_tot), -torch.inf, device=dev),
               torch.full((n_q, f_tot), -1, dtype=torch.int32, device=dev))
        kp, k_tot, scratch = 0, 0, None
    else:
        kp = k_padded(max(s.k for s in segments))
        k_tot = out[0].shape[1]
        # freed on return, as the table (``cuda_knn._upload``)
        scratch = torch.empty(n_q * b_tot * kp, dtype=torch.int64,
                              device=dev)
    topk_out = (None, None) if sort_mode else out
    flat_out = out if sort_mode else (None, None)
    args = (_ptr(table_dev), len(segments), n_q, _ptr(queries), d, p_tot,
            b_tot, nlist_max, max(s.nprobe for s in segments), m_max,
            int(pq), space, int(not sort_mode), kp, k_tot, cb_floats,
            _ptr(probes), _ptr(lut),
            _ptr(topk_out[0]), _ptr(topk_out[1]), _ptr(scratch), f_tot,
            _ptr(flat_out[0]), _ptr(flat_out[1]),
            ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    # the tensors behind the pointers live as long as the arguments
    return lib, args, out, (table_dev, probes, lut, scratch)


def _launch(segments, queries, d, pq, space, counter, out=None, cols=None):
    """One call of the kernels over ``segments`` (``_launch_args``);
    returns ``out``."""
    lib, args, out, _keep = _launch_args(segments, queries, d, pq, space,
                                         out, cols)
    rc = lib.ivf_search_launch(*args)
    kernel = ("", " (probe kernel)", " (table pass)", " (scan kernel)")[
        rc // 1000]
    cuda_build.check(lib, rc % 1000, "ivf_search_launch" + kernel)
    cuda_build.count(counter)
    return out


def _search(segments, queries, pq, space, counter, what):
    dev, d = _check(segments, queries, pq, what)
    offs = k_offsets(segments)
    # every column is written: by the scan kernel, or by the sort below
    vals = torch.empty((queries.shape[0], offs[-1]), dtype=torch.float32,
                       device=dev)
    ids = torch.empty((queries.shape[0], offs[-1]), dtype=torch.int32,
                      device=dev)
    fused = [s for s, seg in enumerate(segments) if seg.k <= K_MAX]
    if fused:
        _launch([segments[s] for s in fused], queries, d, pq, space, counter,
                out=(vals, ids), cols=[offs[s] for s in fused])
    by_sort = [s for s, seg in enumerate(segments) if seg.k > K_MAX]
    if by_sort:
        cuda_build.count(counter, len(by_sort), attr="sorted_route_segments")
        part = [segments[s] for s in by_sort]
        fv, fi = _launch(part, queries, d, pq, space, counter)
        a = 0
        for s, seg in zip(by_sort, part):
            b = a + seg.nprobe * seg.index.c_pad
            sv, order = torch.sort(fv[:, a:b], dim=1, descending=True,
                                   stable=True)
            vals[:, offs[s]: offs[s + 1]] = sv[:, : seg.k]
            ids[:, offs[s]: offs[s + 1]] = torch.gather(
                fi[:, a:b], 1, order[:, : seg.k])
            a = b
    return vals, ids


def ivf_search_segments_cuda(segments, queries, *, space: str):
    """K6: the top ``seg.k`` of every ``IvfSegment`` (a staged
    ``IvfIndex``) for every query of ``queries`` f32 [Q, d], scores in
    ``space``: (vals f32 [Q, K], ids i32 [Q, K]), segment s in the columns
    from ``ops.ivf.k_offsets(segments)[s]``, (-inf, -1) past its hits."""
    code = SPACE_CODES.get(space)
    if code is None:
        raise ValueError(f"unknown space [{space}]")
    return _search(segments, queries, False, code, ivf_search_segments_cuda,
                   "ivf_search_segments_cuda")


ivf_search_segments_cuda.launches = 0
ivf_search_segments_cuda.sorted_route_segments = 0


def ivfpq_search_segments_cuda(segments, queries):
    """K7: the l2 ADC top ``seg.k`` of every ``IvfSegment`` (a staged
    ``IvfPqIndex``) for every query; the layout of
    ``ivf_search_segments_cuda``."""
    return _search(segments, queries, True, 0, ivfpq_search_segments_cuda,
                   "ivfpq_search_segments_cuda")


ivfpq_search_segments_cuda.launches = 0
ivfpq_search_segments_cuda.sorted_route_segments = 0
