"""Device ops: plain PyTorch versions beside their CUDA kernels."""
