"""Field, point, ristretto and MSM operations on torch tensors, and their CUDA kernels."""
