"""opensearch_tpu_torch — the PyTorch/CUDA port of ``opensearch_tpu``.

The JAX package beside it is the reference and stays unchanged; this
package serves the same shard query phase on an NVIDIA H100 with
hand-written CUDA kernels (``csrc/``), and on the CPU through each
kernel's plain PyTorch twin.  It imports neither ``jax`` nor any module
of ``opensearch_tpu``: what it needs of the host side (analysis,
mapping, query DSL, segments) is its own copy, at the same relative
path as the reference module it mirrors.
"""

__version__ = "0.1.0"
