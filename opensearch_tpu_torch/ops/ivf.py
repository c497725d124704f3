"""IVF (inverted-file) approximate k-NN on torch tensors: the port of the
JAX package's ``ops/ivf.py``.

- Training (``train_kmeans``, ``IvfIndex.build``, ``IvfPqIndex.build``)
  runs on the device it is given: Lloyd's iterations are one ``[n, d] x
  [d, c]`` ``torch.matmul`` for the assignment (an argmin that keeps the
  lower centroid on ties) and a per-cluster mean.  The sums of that
  mean are taken in float64 over the rows sorted (stably) by cluster, by
  a segmented scan in a fixed order, and rounded once: no float atomics,
  so two trainings of one segment give the same bytes on the card
  (``index_add_`` would not).  Init is the reference's
  ``default_rng(seed).choice`` over the valid rows.
- The indexes keep the reference's fields and padded cluster-major
  layout (``grouped [nlist, c_pad, d]``, each cluster's valid rows a
  prefix of its ``c_pad``).  ``ivf_index_from_arrays`` /
  ``ivfpq_index_from_arrays`` carry a JAX-trained index (its numpy
  arrays) across, so both packages can search one trained structure.
- ``ivf_search``, ``ivf_search_batch`` and ``ivfpq_search_l2`` are the
  plain versions with the reference's signatures.  ``stage_index`` lays
  an index out as the kernels read it (``StagedIvf``: the valid rows
  only, cluster after cluster, with per-cluster starts), and
  ``ivf_search_segments`` / ``ivfpq_search_segments`` are the plain twins
  of the kernels K6 / K7 over a list of ``IvfSegment``s (every segment of
  a request, every query of a batch).  The dispatchers
  ``ivf_search_segments_auto`` / ``ivfpq_search_segments_auto`` send
  CUDA tensors to K6 / K7 (``ops/cuda_ivf.py``) and CPU tensors to the
  plain twins.

Numbers.  The probe ranks centroids by ``|c|^2 - 2 c.q`` and the scan
scores rows by ``ops/knn.py``'s translations, both from v.q and |v|^2
summed in float64 in K1's lane order (``row_sums``) and rounded to
float32 once; ties go to the lower centroid, then to the lower flat
index ``probe_rank * c_pad + position`` (``lax.top_k`` over the
reference's flat ``[nprobe * c_pad]`` array), not to the lower doc id.
IVF-PQ's table ``LUT[m, 256]`` sums ``(codeword - r)^2`` in float64 over
a subspace's dims in order (``r = q - centroid`` in float32) and rounds
each entry to float32; a row's distance sums its ``m`` entries in
float64 from subspace 0 up, and its score ``1 / (1 + d2)`` is rounded
once.  The kernels do the same, so they equal these versions byte for
byte; the reference sums in float32, so the port agrees with it within
``ops/knn.py``'s ``RTOL`` / ``ATOL``.
"""

from __future__ import annotations

import dataclasses
import itertools
from dataclasses import dataclass
from typing import NamedTuple, Optional

import numpy as np
import torch

from opensearch_tpu_torch.common import torchenv  # noqa: F401
from opensearch_tpu_torch.index.segment import pad_pow2
from opensearch_tpu_torch.ops.bm25 import topk
from opensearch_tpu_torch.ops.knn import SPACES, row_sums, vector_scores

PQ_CODEWORDS = 256


# -- training ----------------------------------------------------------------

def _segment_sums(x, keys, n_keys: int):
    """Per-key sums of ``x`` (float64 [n, w]) over ``keys`` (int64 [n],
    0 <= key < n_keys): the rows sorted stably by key, then a segmented
    inclusive scan (each step adds the row ``step`` places back when it
    has the same key), read at each key's last row.  The order of the
    additions depends on the keys alone: deterministic on every device.
    Keys with no row sum to 0."""
    out = torch.zeros((n_keys, x.shape[1]), dtype=torch.float64,
                      device=x.device)
    if x.shape[0] == 0:
        return out
    ks, order = torch.sort(keys, stable=True)
    s = x[order]
    step = 1
    while step < s.shape[0]:
        same = (ks[step:] == ks[:-step]).unsqueeze(1)
        s[step:] = s[step:] + torch.where(same, s[:-step],
                                          torch.zeros_like(s[:-step]))
        step *= 2
    last = torch.ones_like(ks, dtype=torch.bool)
    last[:-1] = ks[1:] != ks[:-1]
    out[ks[last]] = s[last]
    return out


def _kmeans_step(vectors, valid, centroids, *, n_clusters: int):
    """One Lloyd iteration: assign (matmul + argmin, the lower centroid on
    ties; invalid rows to the dead slot ``n_clusters``) and update (the
    mean of each cluster's rows, float64 sums rounded once).  Empty
    clusters keep their previous centroid."""
    v2 = torch.sum(vectors * vectors, dim=1, keepdim=True)
    c2 = torch.sum(centroids * centroids, dim=1)[None, :]
    d2 = v2 - 2.0 * (vectors @ centroids.T) + c2
    d2 = torch.where(valid[:, None], d2, torch.full_like(d2, torch.inf))
    assign = torch.argmin(d2, dim=1)
    assign = torch.where(valid, assign, torch.full_like(assign, n_clusters))
    sums = _segment_sums(vectors[valid].to(torch.float64), assign[valid],
                         n_clusters)
    counts = torch.bincount(assign[valid], minlength=n_clusters)
    mean = (sums / counts.clamp(min=1)[:, None].to(torch.float64)).to(
        torch.float32)
    new = torch.where(counts[:, None] > 0, mean, centroids)
    return new, assign


def _on(device, x, dtype):
    """``x`` (numpy or tensor) as a contiguous tensor of ``dtype`` on
    ``device`` (that of ``x`` when None and ``x`` is a tensor, else the
    CPU)."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device or x.device, dtype=dtype).contiguous()
    return torch.from_numpy(np.array(x)).to(device=device or "cpu",
                                            dtype=dtype).contiguous()


def train_kmeans(vectors, valid, n_clusters: int, iters: int = 10,
                 seed: int = 17, device=None):
    """k-means on ``device``: (centroids f32 [c, d], assign int64 [n]),
    tensors.  ``vectors`` [n, d] and ``valid`` bool [n] may be numpy
    arrays or tensors.  Init = ``n_clusters`` random valid rows, drawn as
    the reference draws them."""
    v = _on(device, vectors, torch.float32)
    m = _on(v.device, valid, torch.bool)
    valid_idx = np.flatnonzero(m.cpu().numpy())
    if len(valid_idx) == 0:
        raise ValueError("no valid vectors to train on")
    rng = np.random.default_rng(seed)
    pick = rng.choice(valid_idx, size=n_clusters,
                      replace=len(valid_idx) < n_clusters)
    centroids = v[torch.as_tensor(pick, device=v.device)].clone()
    assign = None
    for _ in range(iters):
        centroids, assign = _kmeans_step(v, m, centroids,
                                         n_clusters=n_clusters)
    return centroids, assign


@dataclass
class IvfIndex:
    """Cluster-major vector layout (the reference's fields), tensors on
    the device it was built on."""

    centroids: torch.Tensor      # [nlist, d] f32
    grouped: torch.Tensor        # [nlist, c_pad, d] f32
    grouped_ids: torch.Tensor    # [nlist, c_pad] i32 (doc local ids; -1 pad)
    grouped_valid: torch.Tensor  # [nlist, c_pad] bool
    nlist: int
    c_pad: int

    @staticmethod
    def build(vectors, valid, nlist: int, iters: int = 10, seed: int = 17,
              device=None) -> "IvfIndex":
        v = _on(device, vectors, torch.float32)
        m = _on(v.device, valid, torch.bool)
        nlist = max(1, min(int(nlist), int(m.sum())))
        centroids, assign = train_kmeans(v, m, nlist, iters, seed)
        # rows stable-sorted by cluster, each cluster's rows a prefix of
        # its c_pad = pad_pow2(largest cluster) slots
        d = v.shape[1]
        rows = torch.nonzero(m).flatten()
        order = torch.sort(assign[rows], stable=True).indices
        ids = rows[order]
        clusters = assign[ids]
        counts = torch.bincount(clusters, minlength=nlist)
        c_pad = pad_pow2(max(int(counts.max()), 1))
        starts = torch.cumsum(counts, 0) - counts
        pos = torch.arange(len(ids), device=v.device) - starts[clusters]
        grouped = torch.zeros((nlist, c_pad, d), dtype=torch.float32,
                              device=v.device)
        grouped_ids = torch.full((nlist, c_pad), -1, dtype=torch.int32,
                                 device=v.device)
        grouped_valid = torch.zeros((nlist, c_pad), dtype=torch.bool,
                                    device=v.device)
        grouped[clusters, pos] = v[ids]
        grouped_ids[clusters, pos] = ids.to(torch.int32)
        grouped_valid[clusters, pos] = True
        return IvfIndex(centroids=centroids, grouped=grouped,
                        grouped_ids=grouped_ids, grouped_valid=grouped_valid,
                        nlist=nlist, c_pad=c_pad)

    def arrays(self) -> tuple:
        """The arguments ``ivf_search`` takes before ``query``."""
        return (self.centroids, self.grouped, self.grouped_ids,
                self.grouped_valid)


@dataclass
class IvfPqIndex:
    """IVF coarse quantizer + PQ codes of the residuals (vector -
    centroid): the reference's fields, tensors on the device it was built
    on."""

    centroids: torch.Tensor      # [nlist, d] f32
    codebooks: torch.Tensor      # [m, 256, dsub] f32
    grouped_codes: torch.Tensor  # [nlist, c_pad, m] uint8
    grouped_ids: torch.Tensor    # [nlist, c_pad] i32
    grouped_valid: torch.Tensor  # [nlist, c_pad] bool
    nlist: int
    c_pad: int
    m: int
    dsub: int

    @staticmethod
    def build(vectors, valid, nlist: int, m: int = 8, iters: int = 10,
              pq_iters: int = 8, seed: int = 17,
              device=None) -> "IvfPqIndex":
        v = _on(device, vectors, torch.float32)
        d = v.shape[1]
        if d % m != 0:
            raise ValueError(f"dim [{d}] not divisible by m [{m}]")
        dsub = d // m
        flat = IvfIndex.build(v, valid, nlist, iters, seed)
        nlist, c_pad = flat.nlist, flat.c_pad
        # residuals of every stored vector against its cluster centroid
        res = (flat.grouped - flat.centroids[:, None, :]).reshape(-1, d)
        vmask = flat.grouped_valid.reshape(-1)
        n_codes = min(PQ_CODEWORDS, max(1, int(vmask.sum())))
        codebooks = torch.zeros((m, PQ_CODEWORDS, dsub), dtype=torch.float32,
                                device=v.device)
        codes = torch.zeros((nlist * c_pad, m), dtype=torch.uint8,
                            device=v.device)
        for sub in range(m):
            block = res[:, sub * dsub: (sub + 1) * dsub].contiguous()
            cb, assign = train_kmeans(block, vmask, n_codes, pq_iters,
                                      seed + sub)
            codebooks[sub, : cb.shape[0]] = cb
            codes[:, sub] = torch.where(vmask, assign,
                                        torch.zeros_like(assign)).to(
                                            torch.uint8)
        return IvfPqIndex(
            centroids=flat.centroids, codebooks=codebooks,
            grouped_codes=codes.reshape(nlist, c_pad, m),
            grouped_ids=flat.grouped_ids, grouped_valid=flat.grouped_valid,
            nlist=nlist, c_pad=c_pad, m=m, dsub=dsub)

    def arrays(self) -> tuple:
        """The arguments ``ivfpq_search_l2`` takes before ``query``."""
        return (self.centroids, self.codebooks, self.grouped_codes,
                self.grouped_ids, self.grouped_valid)


def index_to(index, device):
    """``index`` (an ``IvfIndex`` or ``IvfPqIndex``) with its tensors on
    ``device``."""
    return dataclasses.replace(index, **{
        f.name: getattr(index, f.name).to(device)
        for f in dataclasses.fields(index)
        if isinstance(getattr(index, f.name), torch.Tensor)})


def ivf_index_from_arrays(centroids, grouped, grouped_ids, grouped_valid,
                          device="cpu") -> IvfIndex:
    """An ``IvfIndex`` on ``device`` from an index's numpy arrays (a
    JAX-package ``IvfIndex``'s fields), so both packages search one
    trained structure."""
    g = np.asarray(grouped, np.float32)
    return IvfIndex(
        centroids=_on(device, np.asarray(centroids, np.float32),
                      torch.float32),
        grouped=_on(device, g, torch.float32),
        grouped_ids=_on(device, np.asarray(grouped_ids, np.int32),
                        torch.int32),
        grouped_valid=_on(device, np.asarray(grouped_valid, bool),
                          torch.bool),
        nlist=int(g.shape[0]), c_pad=int(g.shape[1]))


def ivfpq_index_from_arrays(centroids, codebooks, grouped_codes,
                            grouped_ids, grouped_valid,
                            device="cpu") -> IvfPqIndex:
    """An ``IvfPqIndex`` on ``device`` from an index's numpy arrays (a
    JAX-package ``IvfPqIndex``'s fields)."""
    cb = np.asarray(codebooks, np.float32)
    codes = np.asarray(grouped_codes, np.uint8)
    return IvfPqIndex(
        centroids=_on(device, np.asarray(centroids, np.float32),
                      torch.float32),
        codebooks=_on(device, cb, torch.float32),
        grouped_codes=_on(device, codes, torch.uint8),
        grouped_ids=_on(device, np.asarray(grouped_ids, np.int32),
                        torch.int32),
        grouped_valid=_on(device, np.asarray(grouped_valid, bool),
                          torch.bool),
        nlist=int(codes.shape[0]), c_pad=int(codes.shape[1]),
        m=int(cb.shape[0]), dsub=int(cb.shape[2]))


# -- the plain versions (the reference's signatures) ------------------------

def probe(centroids, query, nprobe: int):
    """The ``nprobe`` centroids nearest ``query`` by l2, nearest first
    (int64 [nprobe]): ``|c|^2 - 2 c.q`` summed in float64 in K1's order,
    rounded to float32, ascending, the lower centroid on ties."""
    dot, c2, _q2 = row_sums(centroids, query)
    cd = (c2 - 2.0 * dot).to(torch.float32)
    return torch.sort(cd, stable=True).indices[:nprobe]


def _flat_topk(scores, ids, k: int):
    """(vals f32 [k], ids i32 [k]): the best ``k`` of a probe-ordered
    candidate list, the lower flat index first on equal scores; -1 where
    the score is -inf, and (-inf, -1) past the candidates."""
    vals = torch.full((k,), -torch.inf, device=scores.device)
    out = torch.full((k,), -1, dtype=torch.int32, device=scores.device)
    v, pos = topk(scores, k)
    vals[: v.shape[0]] = v
    out[: v.shape[0]] = torch.where(v > -torch.inf, ids[pos.long()].to(
        torch.int32), torch.full_like(pos, -1))
    return vals, out


def _check_space(space: str) -> None:
    if space not in SPACES:
        raise ValueError(f"unknown space [{space}]")


def ivf_search(centroids, grouped, grouped_ids, grouped_valid, query, live,
               *, space: str, k: int, nprobe: int):
    """Single query -> (scores f32 [k], local doc ids i32 [k]; -1 / -inf
    padding).  ``live`` is the segment's bool [n_docs_pad] mask, applied
    after the gather (deletes need no rebuild)."""
    _check_space(space)
    q = query.to(torch.float32)
    probes = probe(centroids, q, nprobe)
    d = grouped.shape[-1]
    flat_v = grouped[probes].reshape(-1, d)
    flat_ids = grouped_ids[probes].reshape(-1).long()
    ok = (grouped_valid[probes].reshape(-1)
          & live[flat_ids.clamp(0, live.shape[0] - 1)] & (flat_ids >= 0))
    return _flat_topk(vector_scores(flat_v, ok, q, fn=space), flat_ids, k)


def ivf_search_batch(centroids, grouped, grouped_ids, grouped_valid,
                     queries, live, *, space: str, k: int, nprobe: int):
    """Batched queries [Q, d] -> (scores [Q, k], ids [Q, k])."""
    outs = [ivf_search(centroids, grouped, grouped_ids, grouped_valid, q,
                       live, space=space, k=k, nprobe=nprobe)
            for q in queries]
    if not outs:
        return (torch.zeros((0, k), device=queries.device),
                torch.zeros((0, k), dtype=torch.int32,
                            device=queries.device))
    return torch.stack([v for v, _ in outs]), torch.stack([i for _, i in outs])


def pq_lut(codebooks, residuals):
    """``LUT [P, m, 256]`` f32 for residuals ``r = q - centroid`` [P, d]:
    ``sum_t (codeword_t - r_t)^2`` over a subspace's dims in order, in
    float64 (each square exact), rounded once."""
    m, n_codes, dsub = codebooks.shape
    diff = codebooks[None] - residuals.reshape(-1, m, 1, dsub)
    acc = torch.zeros(diff.shape[:-1], dtype=torch.float64,
                      device=diff.device)
    for t in range(dsub):
        x = diff[..., t].to(torch.float64)
        acc += x * x
    return acc.to(torch.float32)


def pq_scores(lut, rank, codes):
    """Scores f32 ``1 / (1 + d2)`` of rows of ``codes`` (uint8 [n, m])
    against the table of their probe, ``lut[rank]`` (``lut`` [P, m,
    256], ``rank`` int64 [n]): ``d2`` sums a row's m entries in float64
    from subspace 0 up, the score rounded once."""
    c = codes.long()
    d2 = torch.zeros(c.shape[0], dtype=torch.float64, device=c.device)
    for sub in range(c.shape[1]):
        d2 += lut[rank, sub, c[:, sub]].to(torch.float64)
    return (1.0 / (1.0 + d2)).to(torch.float32)


def ivfpq_search_l2(centroids, codebooks, grouped_codes, grouped_ids,
                    grouped_valid, query, live, *, k: int, nprobe: int):
    """ADC (asymmetric distance) IVF-PQ search, l2 space: per probe the
    residual ``r = q - centroid``, ``LUT [m, 256]`` (``pq_lut``), a row's
    distance the sum of its codes' entries; opensearch l2 scores
    ``1 / (1 + d2)``.  (scores f32 [k], ids i32 [k]; -1 / -inf
    padding)."""
    q = query.to(torch.float32)
    probes = probe(centroids, q, nprobe)
    lut = pq_lut(codebooks, q[None, :] - centroids[probes])
    c_pad, m = grouped_codes.shape[1:]
    rank = torch.arange(len(probes), device=lut.device).repeat_interleave(
        c_pad)
    scores = pq_scores(lut, rank, grouped_codes[probes].reshape(-1, m))
    flat_ids = grouped_ids[probes].reshape(-1).long()
    ok = (grouped_valid[probes].reshape(-1)
          & live[flat_ids.clamp(0, live.shape[0] - 1)] & (flat_ids >= 0))
    scores = torch.where(ok, scores, torch.full_like(scores, -torch.inf))
    return _flat_topk(scores, flat_ids, k)


# -- the kernels' layout and their plain twins -------------------------------

@dataclass(frozen=True)
class StagedIvf:
    """An index as K6 / K7 read it, on one device: the valid rows only,
    cluster after cluster (no padding row), with per-cluster starts.
    ``rows`` for an ``IvfIndex``; ``codes`` and ``codebooks`` for an
    ``IvfPqIndex``.  ``c_pad`` keeps the reference's padded width: the
    flat index ``probe_rank * c_pad + position`` breaks ties.
    ``max_rows``, the largest cluster's valid rows, sets the scan's
    chunks per probe without a sync.  ``rows``, ``codes`` and ``ids``
    start on 16 bytes and keep 16 bytes of slack past their end: the
    scan copies whole 16-byte windows of them.  Frozen: the kernels'
    wrapper keeps what it checked and its launch-table words on it."""

    centroids: torch.Tensor            # f32 [nlist, d]
    ids: torch.Tensor                  # i32 [n_valid]
    starts: torch.Tensor               # i32 [nlist + 1]
    rows: Optional[torch.Tensor]       # f32 [n_valid, d]
    codes: Optional[torch.Tensor]      # uint8 [n_valid, m]
    codebooks: Optional[torch.Tensor]  # f32 [m, 256, dsub]
    nlist: int
    c_pad: int
    starts_host: np.ndarray            # int64 [nlist + 1]
    max_rows: int                      # the largest cluster's valid rows

    @property
    def pq(self) -> bool:
        return self.codes is not None

    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for t in (self.centroids, self.ids, self.starts,
                             self.rows, self.codes, self.codebooks)
                   if t is not None)


def stage_index(index, device) -> StagedIvf:
    """``index`` (an ``IvfIndex`` or ``IvfPqIndex``) laid out for the
    kernels on ``device``."""
    dev = torch.device(device)
    valid = index.grouped_valid
    counts = valid.sum(dim=1).cpu().numpy().astype(np.int64)
    starts = np.zeros(index.nlist + 1, np.int64)
    starts[1:] = np.cumsum(counts)
    pq = isinstance(index, IvfPqIndex)
    keep = valid.reshape(-1)

    def compact(t, width):
        return with_slack(t.reshape(-1, width)[keep], dev)

    return StagedIvf(
        centroids=index.centroids.to(dev).contiguous(),
        ids=compact(index.grouped_ids, 1).reshape(-1),
        starts=torch.from_numpy(starts.astype(np.int32)).to(dev),
        rows=None if pq else compact(index.grouped, index.grouped.shape[-1]),
        codes=compact(index.grouped_codes, index.m) if pq else None,
        codebooks=index.codebooks.to(dev).contiguous() if pq else None,
        nlist=index.nlist, c_pad=index.c_pad, starts_host=starts,
        max_rows=int(counts.max()) if len(counts) else 0)


def with_slack(t, device):
    """``t`` on ``device`` as a contiguous view of a fresh allocation 16
    bytes longer (zeros): a 16-byte window over its last elements stays
    inside it."""
    flat = t.reshape(-1)
    buf = torch.zeros(flat.numel() + -(-16 // t.element_size()),
                      dtype=t.dtype, device=device)
    buf[: flat.numel()] = flat.to(device)
    return buf[: flat.numel()].view(t.shape)


class IvfSegment(NamedTuple):
    """One segment's inputs to K6 / K7: its staged index, its live mask
    (bool [n_pad]; a row is a candidate where ``live[id]``), the clusters
    it probes and the hits it returns (``k <= nprobe * c_pad``)."""
    index: StagedIvf
    live: torch.Tensor
    nprobe: int
    k: int


def k_offsets(segments) -> list:
    """Each segment's first column in a call's output, and the width."""
    return list(itertools.accumulate((s.k for s in segments), initial=0))


def _probed(staged: StagedIvf, probes):
    """(compact row indices, flat indices) of the valid rows of the
    probed clusters, in probe order then position order."""
    p = probes.cpu().numpy()
    lo = staged.starts_host[p]
    counts = staged.starts_host[p + 1] - lo
    total = int(counts.sum())
    first = np.repeat(np.cumsum(counts) - counts, counts)
    pos = np.arange(total, dtype=np.int64) - first
    rows = np.repeat(lo, counts) + pos
    flat = np.repeat(np.arange(len(p), dtype=np.int64) * staged.c_pad,
                     counts) + pos
    dev = staged.ids.device
    return torch.from_numpy(rows).to(dev), torch.from_numpy(flat).to(dev)


def _segment_outputs(segments, queries, one):
    """(vals f32 [Q, K], ids i32 [Q, K]) with ``one(seg, q) -> (vals,
    ids)`` of width ``seg.k`` in each segment's columns."""
    offs = k_offsets(segments)
    vals = torch.full((queries.shape[0], offs[-1]), -torch.inf,
                      device=queries.device)
    ids = torch.full((queries.shape[0], offs[-1]), -1, dtype=torch.int32,
                     device=queries.device)
    for seg, a, b in zip(segments, offs[:-1], offs[1:]):
        for qi in range(queries.shape[0]):
            vals[qi, a:b], ids[qi, a:b] = one(seg, queries[qi])
    return vals, ids


def _candidates(seg: IvfSegment, q):
    """(probes, flat-ordered probed rows, their flat indices, their ids,
    candidate mask) of one segment for query ``q``."""
    st = seg.index
    probes = probe(st.centroids, q, seg.nprobe)
    rows, flat = _probed(st, probes)
    ids = st.ids[rows].long()
    ok = (ids >= 0) & seg.live[ids.clamp(0, seg.live.shape[0] - 1)]
    return probes, rows, flat, ids, ok


def ivf_search_segments(segments, queries, *, space: str):
    """Plain twin of K6: each ``IvfSegment``'s top ``k`` for every query
    of ``queries`` f32 [Q, d], as ``ivf_search`` over the padded layout
    computes it.  (vals f32 [Q, K], ids i32 [Q, K]); segment s fills
    columns ``k_offsets(segments)[s]`` on, (-inf, -1) past its hits."""
    _check_space(space)

    def one(seg, q):
        _p, rows, _f, ids, ok = _candidates(seg, q)
        sc = vector_scores(seg.index.rows[rows], ok, q, fn=space)
        return _flat_topk(sc, ids, seg.k)

    return _segment_outputs(segments, queries.to(torch.float32), one)


def ivfpq_search_segments(segments, queries):
    """Plain twin of K7: each ``IvfSegment``'s (over a staged
    ``IvfPqIndex``) l2 ADC top ``k`` for every query, as
    ``ivfpq_search_l2`` computes it; the layout of
    ``ivf_search_segments``."""

    def one(seg, q):
        st = seg.index
        probes, rows, flat, ids, ok = _candidates(seg, q)
        lut = pq_lut(st.codebooks, q[None, :] - st.centroids[probes])
        sc = pq_scores(lut, flat // st.c_pad, st.codes[rows])
        sc = torch.where(ok, sc, torch.full_like(sc, -torch.inf))
        return _flat_topk(sc, ids, seg.k)

    return _segment_outputs(segments, queries.to(torch.float32), one)


def ivf_search_segments_auto(segments, queries, *, space: str):
    """K6 over every segment and query on CUDA tensors, the plain twin on
    CPU ones."""
    if queries.is_cuda:
        from opensearch_tpu_torch.ops.cuda_ivf import ivf_search_segments_cuda
        return ivf_search_segments_cuda(segments, queries, space=space)
    return ivf_search_segments(segments, queries, space=space)


def ivfpq_search_segments_auto(segments, queries):
    """K7 over every segment and query on CUDA tensors, the plain twin on
    CPU ones."""
    if queries.is_cuda:
        from opensearch_tpu_torch.ops.cuda_ivf import \
            ivfpq_search_segments_cuda
        return ivfpq_search_segments_cuda(segments, queries)
    return ivfpq_search_segments(segments, queries)
