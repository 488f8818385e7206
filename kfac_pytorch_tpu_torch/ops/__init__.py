"""Factor statistics, eigendecomposition, preconditioning and the CUDA kernels."""
