"""Sharded-parameter K-FAC: the shard lenses of column- and row-sharded
dense kernels and of the MoE expert bank (``lenses.py``)."""

from kfac_pytorch_tpu_torch.shardwise.lenses import (  # noqa: F401
    EIGEN_KEYS,
    eigen_refresh,
    ema_update,
    has_moe,
    has_shard_lens,
    identity_eigen,
    identity_factors,
    is_shard_eigen_entry,
    moe_ema,
    precondition,
    shard_entries,
)
