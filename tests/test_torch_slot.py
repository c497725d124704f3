"""K2's dense (per-slot) entry folded into one launch per segment, held on
the CPU: ``ops/cuda_bm25.py`` ``term_bag_cuda`` and
``term_bag_quantized_cuda`` now run one block per ``FOLD_TILE_DOCS``
docs of the segment (``csrc/bm25.cu`` ``term_bag_fold_kernel``), each
adding the bag's slots in slot order into its tile and writing the tile
once.

- A numpy model of the fold (per tile, per slot in slot order, the row's
  sub-range of the tile found by a lower bound, ``w * (idf * imp)``
  added in float32 from 0.0) equals the plain versions byte for byte
  (``impact_scores_plain``, ``impact_score_count_plain``,
  ``match_count_plain`` and their quantized twins), at the kernel's tile
  and at a tile of 16 docs (many tiles, rows crossing tile bounds).
- The plain per-slot versions equal the JAX package's
  ``impact_score_count`` / ``match_count`` and its quantized ops, on the
  f32, int8 and int16 layouts.
- The wrappers refuse CPU tensors (a CUDA tensor gets the kernel or an
  exception; the dispatchers take the plain version for CPU tensors
  only), and the replaced route stays reachable from
  ``testing/k2_sweep.py`` only.
"""

import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opensearch_tpu.ops import bm25 as jbm25
from opensearch_tpu.ops import quantized as jquant
from opensearch_tpu_torch.index.codec import unpack_doc_ids
from opensearch_tpu_torch.ops import bm25 as tbm25
from opensearch_tpu_torch.ops import cuda_bm25
from opensearch_tpu_torch.ops import quantized as tquant
from test_torch_ops import CASES, both, csr_case
from test_torch_quantized import quant_case

ROOT = pathlib.Path(__file__).resolve().parents[1]


def fold_model(offsets, docs, imps, tids, active, idfs, weights, n_pad,
               tile):
    """The fold kernel's arithmetic in numpy: ``(scores f32 [n_pad],
    counts i32 [n_pad])`` built tile by tile, each slot's part of a tile
    found by a lower bound over its doc-ascending row, slots added in
    slot order from 0.0."""
    scores = np.empty(n_pad, np.float32)
    counts = np.empty(n_pad, np.int32)
    for b in range(-(-n_pad // tile)):
        doc0 = b * tile
        acc = np.zeros(tile, np.float32)
        cnt = np.zeros(tile, np.int32)
        for j in range(len(tids)):
            if not active[j]:
                continue
            start, end = int(offsets[tids[j]]), int(offsets[tids[j] + 1])
            row = docs[start:end]
            lo = start + int(np.searchsorted(row, doc0, "left"))
            hi = start + int(np.searchsorted(row, doc0 + tile, "left"))
            d = docs[lo:hi] - doc0
            contrib = np.float32(weights[j]) * (np.float32(idfs[j])
                                                * imps[lo:hi])
            acc[d] = acc[d] + contrib.astype(np.float32)
            cnt[d] += 1
        n = min(tile, n_pad - doc0)
        scores[doc0: doc0 + n] = acc[:n]
        counts[doc0: doc0 + n] = cnt[:n]
    return scores, counts


@pytest.mark.parametrize("tile", [16, cuda_bm25.FOLD_TILE_DOCS])
@pytest.mark.parametrize("case", CASES)
def test_fold_model_equals_the_plain_f32_versions(case, tile):
    c = csr_case(*case)
    names = ("offsets", "doc_ids", "impacts", "tids", "active", "idfs",
             "weights")
    _j, t = both(c, *names)
    kw = dict(n_pad=c["n_pad"], budget=c["budget"])
    s_m, c_m = fold_model(c["offsets"], c["doc_ids"], c["impacts"],
                          c["tids"], c["active"], c["idfs"], c["weights"],
                          c["n_pad"], tile)
    s_p, c_p = tbm25.impact_score_count_plain(*t, **kw, scored=True)
    assert s_m.tobytes() == s_p.numpy().tobytes()
    assert c_m.tobytes() == c_p.numpy().tobytes()
    assert s_m.tobytes() == tbm25.impact_scores_plain(
        *t, **kw).numpy().tobytes()
    _jm, tm = both(c, "offsets", "doc_ids", "tfs", "tids", "active")
    assert c_m.tobytes() == tbm25.match_count_plain(
        *tm, **kw).numpy().tobytes()


@pytest.mark.parametrize("tile", [16, cuda_bm25.FOLD_TILE_DOCS])
@pytest.mark.parametrize("dtype,seed", [("int8", 3), ("int16", 33)])
def test_fold_model_equals_the_plain_quantized_versions(dtype, seed, tile,
                                                        monkeypatch):
    dseg, q, qt, tids, active, idfs, weights, budget = quant_case(
        seed, dtype, monkeypatch)
    offsets = dseg.postings["body"]["offsets"]
    host_off = np.asarray(qt._offsets)
    docs = unpack_doc_ids(qt.packed, qt.base, host_off, qt.width)
    np.testing.assert_array_equal(docs, dseg.seg.postings["body"].doc_ids)
    s_m, c_m = fold_model(host_off, docs, qt.dequantized(), tids, active,
                          idfs, weights, dseg.n_pad, tile)
    args = (offsets, q["packed"], q["base"], q["qvals"], q["scales"],
            q["exact_vals"], q["exact_offsets"], torch.from_numpy(tids),
            torch.from_numpy(active), torch.from_numpy(idfs),
            torch.from_numpy(weights))
    kw = dict(width=qt.width, n_pad=dseg.n_pad, budget=budget)
    s_p, c_p = tquant.quantized_impact_score_count_plain(*args, **kw,
                                                         scored=True)
    assert s_m.tobytes() == s_p.numpy().tobytes()
    assert c_m.tobytes() == c_p.numpy().tobytes()
    assert s_m.tobytes() == tquant.quantized_impact_scores_plain(
        *args, **kw).numpy().tobytes()
    assert bool((c_m >= 2).any())         # slot order matters here


@pytest.mark.parametrize("case", CASES)
def test_plain_f32_versions_equal_the_reference(case):
    c = csr_case(*case)
    names = ("offsets", "doc_ids", "impacts", "tids", "active", "idfs",
             "weights")
    j, t = both(c, *names)
    kw = dict(n_pad=c["n_pad"], budget=c["budget"])
    for scored in (True, False):
        rs, rc = jbm25.impact_score_count(*j, **kw, scored=scored)
        gs, gc = tbm25.impact_score_count_plain(*t, **kw, scored=scored)
        assert np.asarray(rs).tobytes() == gs.numpy().tobytes()
        assert np.asarray(rc).tobytes() == gc.numpy().tobytes()
    jm, tm = both(c, "offsets", "doc_ids", "tfs", "tids", "active")
    assert np.asarray(jbm25.match_count(*jm, **kw)).tobytes() == \
        tbm25.match_count_plain(*tm, **kw).numpy().tobytes()


@pytest.mark.parametrize("dtype,seed", [("int8", 5), ("int16", 7)])
def test_plain_quantized_versions_equal_the_reference(dtype, seed,
                                                      monkeypatch):
    dseg, q, qt, tids, active, idfs, weights, budget = quant_case(
        seed, dtype, monkeypatch)
    offsets = dseg.postings["body"]["offsets"]
    names = ("qvals", "scales", "exact_vals", "exact_offsets")
    t_args = (offsets, q["packed"], q["base"], *(q[n] for n in names),
              torch.from_numpy(tids), torch.from_numpy(active),
              torch.from_numpy(idfs), torch.from_numpy(weights))
    j_args = (jnp.asarray(offsets.numpy()),
              jnp.asarray(q["packed"].numpy().view(np.uint32)),
              jnp.asarray(q["base"].numpy()),
              *(jnp.asarray(q[n].numpy()) for n in names),
              jnp.asarray(tids), jnp.asarray(active), jnp.asarray(idfs),
              jnp.asarray(weights))
    kw = dict(width=qt.width, n_pad=dseg.n_pad, budget=budget)
    for scored in (True, False):
        gs, gc = tquant.quantized_impact_score_count_plain(
            *t_args, **kw, scored=scored)
        rs, rc = jquant.quantized_impact_score_count(*j_args, **kw,
                                                     scored=scored)
        assert gs.numpy().tobytes() == np.asarray(rs).tobytes()
        assert gc.numpy().tobytes() == np.asarray(rc).tobytes()


def test_dense_wrappers_refuse_cpu_tensors(monkeypatch):
    c = csr_case(17, 300, 40, 5, 1)
    _j, t = both(c, "offsets", "doc_ids", "impacts", "tids", "active",
                 "idfs", "weights")
    before = cuda_bm25.term_bag_cuda.launches
    for scores, counts in ((True, True), (True, False), (False, True)):
        with pytest.raises(ValueError, match="CUDA"):
            cuda_bm25.term_bag_cuda(*t, n_pad=c["n_pad"],
                                    budget=c["budget"], scores=scores,
                                    counts=counts)
    assert cuda_bm25.term_bag_cuda.launches == before
    dseg, q, qt, tids, active, idfs, weights, budget = quant_case(
        3, "int8", monkeypatch)
    before = cuda_bm25.term_bag_quantized_cuda.launches
    with pytest.raises(ValueError, match="CUDA"):
        cuda_bm25.term_bag_quantized_cuda(
            dseg.postings["body"]["offsets"], q["packed"], q["base"],
            q["qvals"], q["scales"], q["exact_vals"], q["exact_offsets"],
            torch.from_numpy(tids), torch.from_numpy(active),
            torch.from_numpy(idfs), torch.from_numpy(weights),
            width=qt.width, n_pad=dseg.n_pad, budget=budget, scores=True,
            counts=False)
    assert cuda_bm25.term_bag_quantized_cuda.launches == before


def test_replaced_route_is_reachable_from_the_sweep_only():
    """No search path calls the per-slot route: its C entries are named
    only in ``testing/k2_sweep.py``, and ``csrc/bm25.cu`` compiles them
    only under ``BM25_SLOT_ROUTE``, which the search paths' library is
    not built with."""
    port = ROOT / "opensearch_tpu_torch"
    users = sorted(str(p.relative_to(ROOT)) for p in port.rglob("*.py")
                   if "slot_launch" in p.read_text())
    assert users == ["opensearch_tpu_torch/testing/k2_sweep.py"]
    assert "BM25_SLOT_ROUTE" not in cuda_bm25.defines()
    depth, guarded = 0, []
    for ln in (port / "csrc" / "bm25.cu").read_text().splitlines():
        if ln.startswith("#ifdef BM25_SLOT_ROUTE"):
            depth += 1
        elif ln.startswith("#endif  // BM25_SLOT_ROUTE"):
            depth -= 1
        elif "term_bag_slot_kernel" in ln or "slot_launch" in ln:
            guarded.append((depth, ln.strip()))
    assert depth == 0
    assert [ln for d, ln in guarded if d == 0 and not ln.startswith("//")] \
        == []
