"""Test harness: force an 8-device virtual CPU mesh (default).

Multi-device collective/sharding paths (pmean/psum/shard_map) are exercised on
fake CPU devices — real SPMD semantics, no TPU pod needed (SURVEY.md §4).
See kfac_pytorch_tpu/platform_override.py for why env vars alone are too late
on this image.

``KFAC_TEST_TPU=1`` skips the CPU override so the TPU-gated tests (the
``test_tpu_hardware_*`` Mosaic validations in test_flash_attention.py, which
skip themselves off-TPU) can actually reach the chip:

    KFAC_TEST_TPU=1 pytest tests/test_flash_attention.py -k tpu_hardware
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

if os.environ.get("KFAC_TEST_TPU") == "1":
    from kfac_pytorch_tpu.compile_cache import enable_persistent_cache

    enable_persistent_cache()
else:
    from kfac_pytorch_tpu.platform_override import force_cpu_devices

    # The suite is XLA-compile-bound on the virtual mesh and tier-1 is
    # wall-clock capped; dial LLVM codegen down for test compiles (~20%
    # faster end to end). HLO-level semantics — fusion, collective counts,
    # FP results — are unchanged, so parity/bitwise/lint tests are
    # unaffected; compiled-code runtime does not matter at test sizes.
    if "--xla_backend_optimization_level" not in os.environ.get("XLA_FLAGS", ""):
        os.environ["XLA_FLAGS"] = (
            os.environ.get("XLA_FLAGS", "")
            + " --xla_backend_optimization_level=0"
            + " --xla_llvm_disable_expensive_passes=true"
        ).strip()

    assert force_cpu_devices(8), "JAX backend initialized before conftest ran"


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow: minutes-long on the 8-device CPU mesh; excluded from the "
        "tier-1 pass (`-m 'not slow'`), run explicitly or on real hardware",
    )
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA GPU (the PyTorch port's CUDA kernels); skips "
        "with a reason where torch.cuda.is_available() is false",
    )
