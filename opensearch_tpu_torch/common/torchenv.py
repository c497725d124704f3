"""Central PyTorch configuration for the package (the counterpart of the
JAX package's ``common/jaxenv.py``).

Import this module before any device work inside opensearch_tpu_torch.
It pins float32 matrix products and convolutions to full float32 (no
TF32): the k-NN scores are compared at fp32 against the reference.  The
scoring kernels use int32 doc ids/offsets and float32 scores; int64 is
used only where indexing needs it.

``default_device()`` picks ``cuda``.  It never falls back to the CPU on
its own: without CUDA it raises, and a caller that wants the CPU (the
tests, the plain reference path) passes ``device="cpu"`` explicitly.
"""

from __future__ import annotations

import torch

from opensearch_tpu_torch.common.errors import OpenSearchTpuError

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


class DeviceUnavailableError(OpenSearchTpuError):
    """CUDA was asked for (explicitly or by default) and is absent."""

    status = 503


def default_device() -> torch.device:
    """The device a searcher uses when none is given: ``cuda``.  Raises
    when CUDA is absent — pass ``device="cpu"`` to run on the CPU."""
    if not torch.cuda.is_available():
        raise DeviceUnavailableError(
            "CUDA is not available; pass device=\"cpu\" explicitly to "
            "run on the CPU")
    return torch.device("cuda")


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; None means ``default_device()``.
    An explicit ``cuda`` without CUDA raises as well."""
    if device is None:
        return default_device()
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise DeviceUnavailableError(
            f"device [{device}] requested but CUDA is not available")
    return dev
