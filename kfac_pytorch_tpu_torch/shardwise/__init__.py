"""Sharded-parameter K-FAC: the shard lenses of column- and row-sharded
dense kernels and of the MoE expert bank, and their placement on the 3-D
data×fsdp×tensor world (``lenses.py``)."""

from kfac_pytorch_tpu_torch.shardwise.lenses import (  # noqa: F401
    EIGEN_KEYS,
    FSDP,
    TENSOR_SPLIT_KEYS,
    eigen_refresh,
    ema_update,
    factor_leaf_spec,
    global_part,
    has_moe,
    has_shard_lens,
    identity_eigen,
    identity_factors,
    is_shard_eigen_entry,
    lm_param_shardings,
    local_part,
    moe_ema,
    precondition,
    shard_entries,
    state_bytes_local,
)
