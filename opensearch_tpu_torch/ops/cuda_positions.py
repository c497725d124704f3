"""Wrappers of K8 and K9, the hand-written kernels of
``csrc/positions.cu``, which replace the reference's ``phrase_freqs``
(``ops/phrase.py``) and ``span_near_freqs`` (``ops/span.py``) on CUDA
tensors: one launch per (segment, phrase or span leaf), a thread per
posting entry of the anchor term.

- ``phrase_freqs_cuda``: K8, plain twin ``ops/phrase.py`` ``phrase_freqs``;
- ``span_near_cuda``: K9, plain twin ``ops/span.py`` ``span_near_freqs``.

Each builds its slot table on the host (``slot_table``: three int64
words a slot, sent by one pinned copy), zeroes the [n_pad] output and
launches; nothing is launched when no doc can match (an anchor without
entries, or for K8 a slot whose term the segment lacks).  They never fall
back to the plain versions: a CUDA tensor gets the kernel or an
exception.  ``.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from opensearch_tpu_torch.ops import cuda_build
from opensearch_tpu_torch.ops.phrase import PositionSlots


def _declare(lib):
    p = ctypes.c_void_p
    i = ctypes.c_int
    ll = ctypes.c_longlong
    lib.phrase_freqs_launch.argtypes = [p, i, p, p, p, p, ll, p]
    lib.phrase_freqs_launch.restype = i
    lib.span_near_launch.argtypes = [p, i, p, p, p, p, ll, i, i, i, i, p]
    lib.span_near_launch.restype = i


def _library():
    return cuda_build.library("positions", _declare)


def slot_table(slots: PositionSlots) -> np.ndarray:
    """The kernels' slot table: int64 ``{row start, row end, shift}`` per
    slot, slot 0 the anchor (``csrc/positions.cu`` reads it so)."""
    return np.concatenate([slots.rows, slots.shifts[:, None]],
                          axis=1).astype(np.int64).reshape(-1)


def _columns(doc_ids, pos_offsets, positions):
    dev = doc_ids.device
    if dev.type != "cuda":
        raise ValueError(f"K8 / K9 need CUDA tensors, got {dev}")
    for name, t in (("doc_ids", doc_ids), ("pos_offsets", pos_offsets),
                    ("positions", positions)):
        if t.device != dev:
            raise ValueError(f"[{name}] is on {t.device}, expected {dev}")
        if t.dtype != torch.int32 or t.dim() != 1 or not t.is_contiguous():
            raise TypeError(f"[{name}] must be a contiguous int32 vector, "
                            f"got {t.dtype} {list(t.shape)}")
    return dev


def check_slots(slots: PositionSlots, doc_ids, pos_offsets) -> None:
    """Raise unless every slot's posting row lies in the staged columns:
    the kernels read ``doc_ids[e]`` and ``pos_offsets[e + 1]`` of each
    entry ``e`` of a row."""
    rows = slots.rows
    if rows.ndim != 2 or rows.shape[0] < 1 or rows.shape[1] != 2 or \
            slots.shifts.shape != (rows.shape[0],):
        raise ValueError("a phrase or span needs [m, 2] rows and m shifts, "
                         "m >= 1")
    if (rows[:, 0] > rows[:, 1]).any() or (rows < 0).any() or \
            int(rows.max()) > doc_ids.shape[0] or \
            int(rows.max()) >= pos_offsets.shape[0]:
        raise ValueError("slot rows outside the staged postings")


def _launch(fn_name, slots, doc_ids, pos_offsets, positions, n_pad,
            *extra):
    """Zeroed ``tf`` [n_pad] and, when the anchor has entries, one launch
    of ``fn_name`` over it.  Returns (tf, launched)."""
    dev = _columns(doc_ids, pos_offsets, positions)
    check_slots(slots, doc_ids, pos_offsets)
    rows = slots.rows
    tf = torch.zeros(n_pad, dtype=torch.float32, device=dev)
    if slots.n_anchor == 0:
        return tf, False
    table = torch.from_numpy(slot_table(slots)).pin_memory().to(
        dev, non_blocking=True)
    lib = _library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = getattr(lib, fn_name)(
        ctypes.c_void_p(table.data_ptr()), int(rows.shape[0]),
        ctypes.c_void_p(doc_ids.data_ptr()),
        ctypes.c_void_p(pos_offsets.data_ptr()),
        ctypes.c_void_p(positions.data_ptr()), ctypes.c_void_p(tf.data_ptr()),
        slots.n_anchor, *extra, ctypes.c_void_p(stream))
    cuda_build.check(lib, rc, fn_name)
    return tf, True


def phrase_freqs_cuda(doc_ids, pos_offsets, positions, slots: PositionSlots,
                      n_pad: int) -> torch.Tensor:
    """Per-doc exact-phrase frequency, float32 [n_pad] (K8): what
    ``ops.phrase.phrase_freqs`` returns for the same arguments."""
    if not slots.complete:
        _columns(doc_ids, pos_offsets, positions)
        return torch.zeros(n_pad, dtype=torch.float32, device=doc_ids.device)
    tf, launched = _launch("phrase_freqs_launch", slots, doc_ids,
                           pos_offsets, positions, n_pad)
    if launched:
        cuda_build.count(phrase_freqs_cuda)
    return tf


phrase_freqs_cuda.launches = 0


def span_near_cuda(doc_ids, pos_offsets, positions, slots: PositionSlots,
                   n_pad: int, *, ordered: bool, slop: int,
                   end: int) -> torch.Tensor:
    """Per-doc count of clause-0 occurrences that start a span match,
    float32 [n_pad] (K9): what ``ops.span.span_near_freqs`` returns for the
    same arguments."""
    if not ordered and slots.rows.shape[0] != 2:
        raise ValueError("an unordered span takes exactly 2 clauses")
    tf, launched = _launch(
        "span_near_launch", slots, doc_ids, pos_offsets, positions, n_pad,
        int(bool(ordered)), _int32(slop, "slop"), _int32(end, "end"),
        int(bool(slots.same_term)))
    if launched:
        cuda_build.count(span_near_cuda)
    return tf


span_near_cuda.launches = 0


def _int32(x, name: str) -> int:
    """``x`` as the kernel's int argument (the plan passes int32 values)."""
    x = int(x)
    if not -2**31 <= x < 2**31:
        raise ValueError(f"[{name}] {x} does not fit in int32")
    return x
