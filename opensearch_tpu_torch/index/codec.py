"""Lowering policy of the quantized device index (the policy part of the
JAX package's ``index/codec.py``).

The JAX package scores the term bags of every segment with at least
``QUANTIZED_MIN_DOCS`` docs over int8/int16 impacts and bit-packed doc
ids by default.  Those kernels are not ported yet, so this package keeps
the SAME decision and refuses such segments for scored term bags
(``search/plan.py`` raises ``NotYetPortedError``) instead of scoring
them in f32 and answering differently from the reference.
"""

from __future__ import annotations

QUANTIZED_MODE = "auto"            # "auto" | "on" | "off"
QUANTIZED_MIN_DOCS = 65536
QUANTIZED_DTYPE = "int8"           # "int8" | "int16"


def use_quantized(seg) -> bool:
    """Per-segment lowering decision: does this segment's scored
    term-bag path run on the quantized layout in the reference?
    Deterministic from segment size + module policy."""
    if QUANTIZED_MODE == "on":
        return True
    if QUANTIZED_MODE == "off":
        return False
    return int(getattr(seg, "n_docs", 0)) >= int(QUANTIZED_MIN_DOCS)
