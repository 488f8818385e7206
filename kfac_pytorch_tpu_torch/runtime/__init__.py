"""Host runtime: the native threaded data loader (``runtime/loader.py``)."""

from kfac_pytorch_tpu_torch.runtime.loader import (
    NativeEpochLoader,
    native_epoch_batches,
    native_transform,
)

__all__ = ["NativeEpochLoader", "native_epoch_batches", "native_transform"]
