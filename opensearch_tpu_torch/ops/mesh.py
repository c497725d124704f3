"""The cross-shard merge of the mesh (the reference's ``lax.top_k`` over
all-gathered shard lists, ``parallel/dist_search.py``), on torch tensors.

``mesh_merge_plain`` is the plain version of K10 (``ops/cuda_mesh.py``,
``csrc/mesh_merge.cu``): the top ``k`` of ``vals`` [R, w] flattened, by
a stable descending sort, so the lower flat index ``r * w + c`` wins a
tie (``lax.top_k``'s order; -0.0 and +0.0 tie).  ``mesh_merge``, which
the mesh calls, launches K10 on CUDA tensors and runs the plain version
on CPU ones.
"""

from __future__ import annotations

import torch

from opensearch_tpu_torch.common import torchenv  # noqa: F401


def mesh_merge_plain(vals, k: int):
    """``(top_vals [k] f32, flat_idx [k] i64)``: the ``k`` largest of
    ``vals`` [R, w] flattened, the lower flat index first on ties."""
    flat = vals.reshape(-1)
    top, idx = torch.sort(flat, descending=True, stable=True)
    return top[:k], idx[:k].to(torch.int64)


def mesh_merge(vals, k: int):
    """The merge of ``vals`` [R, w] (each row sorted descending, -inf
    padding): one K10 launch on a CUDA tensor, the plain version on a
    CPU one."""
    if vals.is_cuda:
        from opensearch_tpu_torch.ops import cuda_mesh
        return cuda_mesh.mesh_merge_cuda(vals, k)
    return mesh_merge_plain(vals, k)
