"""Wrappers of K6 and K7, the hand-written IVF / IVF-PQ kernels
(``csrc/ivf.cu``): the counterparts of the JAX package's XLA programs
``ivf_search`` / ``ivf_search_batch`` and ``ivfpq_search_l2``
(``opensearch_tpu/ops/ivf.py``).

- ``ivf_search_segments_cuda`` (K6): every query of ``queries`` against
  every ``ops.ivf.IvfSegment`` (a staged ``IvfIndex``) in one call, the
  probe kernel then the scan kernel.  Plain twin:
  ``ops/ivf.py::ivf_search_segments``.
- ``ivfpq_search_segments_cuda`` (K7): the same over staged
  ``IvfPqIndex``es, l2 ADC scores.  Plain twin:
  ``ops/ivf.py::ivfpq_search_segments``.

Segments returning at most ``K_MAX`` hits keep their top k inside the
scan kernel; the others (``sorted_route_segments`` counts them) take
the same two kernels in scores mode over a flat buffer of every probed
slot, then a stable sort on the card.  Neither wrapper falls back to its
plain twin: a CUDA tensor gets the kernels or an exception.
``.launches`` counts the calls that launched (a probe and a scan each).
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
NLIST_MAX = 16_384     # the probe sorts a segment's centroids in shared memory
M_MAX = 128            # K7's LUT: 1 KB of shared memory per subspace
D_MAX = 8_192          # the query in shared memory (float64)
# a block's shared memory on sm_90, less the static part
SMEM_MAX = 232_448 - 1_024
# the words of a segment's entry (csrc/ivf.cu)
(W_CENTROIDS, W_ROWS, W_IDS, W_STARTS, W_LIVE, W_CODEBOOKS, W_NLIST,
 W_NPROBE, W_K, W_CPAD, W_PROBE_OFF, W_OUT_COL, W_FLAT_OFF, W_M) = range(14)


def defines() -> dict:
    """The macros ``csrc/ivf.cu`` is built with."""
    return {"IVF_K_MAX": K_MAX, "IVF_SEG_WORDS": SEG_WORDS,
            "IVF_NLIST_MAX": NLIST_MAX, "IVF_M_MAX": M_MAX,
            "IVF_D_MAX": D_MAX}


def _declare(lib):
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.ivf_search_launch.argtypes = [p, i, i, p, i, i, i, i, i, i, i, i, i,
                                      p, p, p, p, ll, p, p, p]
    lib.ivf_search_launch.restype = i
    lib.ivf_probe_smem.argtypes = [i, i]
    lib.ivf_scan_smem.argtypes = [i]
    lib.ivfpq_scan_smem.argtypes = [i, i]
    for name in ("ivf_probe_smem", "ivf_scan_smem", "ivfpq_scan_smem"):
        getattr(lib, name).restype = ll


def _library():
    return cuda_build.library("ivf", _declare, defines())


def k_padded(k: int) -> int:
    """Keys each scan block keeps: ``k`` rounded up to a power of two."""
    return 1 << (int(k) - 1).bit_length()


def launch_table(segments, n_queries: int, out_cols, sort_mode: bool):
    """(table int64, p_tot, f_tot) of one call over ``segments``
    (``IvfSegment``s; a table entry each, ``SEG_WORDS`` words in the order
    of ``csrc/ivf.cu``'s ``w*`` names), then ``n_queries x len(segments)``
    int32 counters, zero.  ``out_cols``: each segment's first output
    column; ``p_tot``: the probes of a query over every segment (its scan
    blocks); ``f_tot``: in ``sort_mode``, a query's flat slots (``nprobe
    * c_pad`` a segment), else 0."""
    n_seg = len(segments)
    table = np.zeros(n_seg * SEG_WORDS + (n_queries * n_seg + 1) // 2,
                     np.int64)
    entries = table[: n_seg * SEG_WORDS].reshape(n_seg, SEG_WORDS)
    p_tot = f_tot = 0
    for s, (seg, col) in enumerate(zip(segments, out_cols)):
        st = seg.index
        e = entries[s]
        e[W_CENTROIDS] = _addr(st.centroids)
        e[W_ROWS] = _addr(st.codes if st.pq else st.rows)
        e[W_IDS] = _addr(st.ids)
        e[W_STARTS] = _addr(st.starts)
        e[W_LIVE] = _addr(seg.live)
        e[W_CODEBOOKS] = _addr(st.codebooks)
        e[W_NLIST], e[W_NPROBE], e[W_K] = st.nlist, seg.nprobe, seg.k
        e[W_CPAD], e[W_PROBE_OFF], e[W_OUT_COL] = st.c_pad, p_tot, col
        e[W_FLAT_OFF] = f_tot if sort_mode else 0
        e[W_M] = st.codes.shape[1] if st.pq else 0
        p_tot += seg.nprobe
        if sort_mode:
            f_tot += seg.nprobe * st.c_pad
    return table, p_tot, f_tot


def _check(segments, queries, pq: bool, what: str):
    """The device, the query width and each segment's staged arrays."""
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
        if st.pq != pq:
            raise TypeError(f"segments[{i}] holds an "
                            f"{'IVF-PQ' if st.pq else 'IVF'} index")
        if not 1 <= st.nlist <= NLIST_MAX:
            raise ValueError(f"{what} takes 1 <= nlist <= {NLIST_MAX}, "
                             f"got {st.nlist}")
        if not 1 <= seg.nprobe <= st.nlist:
            raise ValueError(f"segments[{i}]: nprobe {seg.nprobe} outside "
                             f"1..{st.nlist}")
        if not 1 <= seg.k <= seg.nprobe * st.c_pad or \
                seg.nprobe * st.c_pad >= 2 ** 31:
            raise ValueError(f"segments[{i}]: k {seg.k} outside 1.."
                             f"{seg.nprobe * st.c_pad}")
        n = st.ids.shape[0]
        _expect(st.centroids, f"segments[{i}].centroids", torch.float32, dev,
                (st.nlist, d))
        _expect(st.ids, f"segments[{i}].ids", torch.int32, dev, (n,))
        _expect(st.starts, f"segments[{i}].starts", torch.int32, dev,
                (st.nlist + 1,))
        if seg.live.device != dev or seg.live.dtype != torch.bool or \
                seg.live.dim() != 1 or not seg.live.is_contiguous():
            raise TypeError(f"segments[{i}].live must be a contiguous bool "
                            f"[n] on {dev}")
        if pq:
            m = st.codes.shape[1] if st.codes.dim() == 2 else 0
            if not 1 <= m <= M_MAX or d % m:
                raise ValueError(f"{what} takes 1 <= m <= {M_MAX} dividing "
                                 f"d={d}, got m={m}")
            _expect(st.codes, f"segments[{i}].codes", torch.uint8, dev,
                    (n, m))
            _expect(st.codebooks, f"segments[{i}].codebooks", torch.float32,
                    dev, (m, PQ_CODEWORDS, d // m))
        else:
            _expect(st.rows, f"segments[{i}].rows", torch.float32, dev,
                    (n, d))
            if d % 4 == 0 and (_addr(st.rows) % 16 or
                               _addr(st.centroids) % 16):
                raise ValueError(f"segments[{i}]: rows and centroids must "
                                 "start on 16 bytes")
    return dev, d


def _launch(segments, queries, d, pq, space, counter, out=None, cols=None):
    """One call of the two kernels over ``segments``.  Top-k mode
    (``out`` given): each segment's hits into ``out`` = (vals, ids) [Q,
    K] from its column of ``cols``.  Scores mode: returns the flat
    buffers (vals, ids) [Q, f_tot] of every probed slot."""
    dev = queries.device
    lib = _library()
    n_q = queries.shape[0]
    sort_mode = out is None
    nlist_max = max(s.index.nlist for s in segments)
    m_max = max(s.index.codes.shape[1] for s in segments) if pq else 0
    smem = max(lib.ivf_probe_smem(d, nlist_max),
               lib.ivfpq_scan_smem(d, m_max) if pq else lib.ivf_scan_smem(d))
    if smem > SMEM_MAX:
        raise ValueError(f"a call at d={d}, nlist {nlist_max}, m {m_max} "
                         f"needs {smem} bytes of shared memory a block")
    table, p_tot, f_tot = launch_table(
        segments, n_q, cols or [0] * len(segments), sort_mode)
    table_dev = _upload(table, dev)
    probes = torch.empty((n_q, p_tot), dtype=torch.int32, device=dev)
    if sort_mode:
        out = (torch.full((n_q, f_tot), -torch.inf, device=dev),
               torch.full((n_q, f_tot), -1, dtype=torch.int32, device=dev))
        kp, k_tot, scratch = 0, 0, None
    else:
        kp = k_padded(max(s.k for s in segments))
        k_tot = out[0].shape[1]
        # freed on return, as the table (``cuda_knn._upload``)
        scratch = torch.empty(n_q * p_tot * kp, dtype=torch.int64,
                              device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.ivf_search_launch(
        _ptr(table_dev), len(segments), n_q, _ptr(queries), d, p_tot,
        nlist_max, m_max, int(pq), space, int(not sort_mode), kp, k_tot,
        _ptr(probes), *((_ptr(None), _ptr(None)) if sort_mode
                        else (_ptr(out[0]), _ptr(out[1]))),
        _ptr(scratch), f_tot,
        *((_ptr(out[0]), _ptr(out[1])) if sort_mode
          else (_ptr(None), _ptr(None))),
        ctypes.c_void_p(stream))
    cuda_build.check(lib, rc, "ivf_search_launch")
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
