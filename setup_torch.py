"""Packaging of the PyTorch/CUDA port alone: ``kfac_pytorch_tpu_torch``.

    python setup_torch.py bdist_wheel

It ships the CUDA sources and headers under ``csrc/``, which
``ops/kernel_build.py`` compiles with ``nvcc`` at first use, and the native
loader's C++ source, which ``runtime/loader.py`` compiles with ``g++``; it
requires PyTorch and numpy, nothing of JAX.
"""

from setuptools import find_packages, setup

setup(
    name="kfac_pytorch_tpu_torch",
    version="0.1.0",
    description="Distributed K-FAC gradient preconditioner in PyTorch, with CUDA kernels for Hopper",
    packages=find_packages(include=["kfac_pytorch_tpu_torch", "kfac_pytorch_tpu_torch.*"]),
    package_data={"kfac_pytorch_tpu_torch": ["csrc/*.cu", "csrc/*.cuh", "csrc/*.cpp"]},
    python_requires=">=3.10",
    install_requires=["torch", "numpy"],
)
