"""Packaging (parity: reference setup.py ships only the library package)."""

from setuptools import find_packages, setup

setup(
    name="kfac_pytorch_tpu",
    version="0.1.0",
    description=(
        "TPU-native distributed K-FAC gradient preconditioner (JAX/XLA)"
    ),
    packages=find_packages(
        include=[
            "kfac_pytorch_tpu",
            "kfac_pytorch_tpu.*",
            "kfac_pytorch_tpu_torch",
            "kfac_pytorch_tpu_torch.*",
        ]
    ),
    # ship the native loader source so the ctypes binding can build it
    # on-site with g++ (runtime/loader.py), and the PyTorch port's CUDA
    # kernel sources, built with nvcc at first use (ops/kernel_build.py)
    package_data={
        "kfac_pytorch_tpu.runtime": ["native/*.cpp"],
        "kfac_pytorch_tpu_torch": ["csrc/*.cu", "csrc/*.cuh", "csrc/*.cpp"],
    },
    python_requires=">=3.10",
    install_requires=[
        "jax",
        "flax",
        "optax",
        "orbax-checkpoint",
        "numpy",
    ],
)
