"""FSDP's parameter split on the data×fsdp×tensor world.

Port of what the JAX package gets from placing the parameters with
``shardwise.lm_param_shardings`` on a ``data_fsdp_tensor_mesh``: each fsdp
slot stores only its part of every parameter the JAX rule splits
(``shardwise.FSDP``, the flattened parameter cut into ``F`` contiguous
equal parts), and of its momentum; GSPMD gathers the parts for the
forward. Here :class:`FsdpParams` holds this rank's parts of those
parameters in ONE flat buffer (the persistent storage: what the optimizer
updates and a checkpoint gathers) and its momentum parts in the train
state, and around each step:

* :meth:`FsdpParams.gather` puts the whole values back into the model's
  parameters (one ``all_gather_into_tensor`` of the flat buffer on the
  fsdp subgroup), so the forward, the capture hooks and the backward see
  whole parameters (capture at the allgather point, as the JAX package's
  flax layers see the gathered value);
* the gradients are averaged over the data×fsdp group, every fsdp slot
  preconditions the same whole gradient, and :meth:`FsdpParams.sgd_view`
  hands the optimizer (kernel 4, ``csrc/fused_sgd.cu``) this rank's flat
  slice of each gradient beside the persistent parts and their momentum,
  never the gathered temporaries (so an ``apply_kernels.SGDPlan`` built
  once stays valid);
* :meth:`FsdpParams.release` frees the gathered values (each split
  parameter's ``.data`` becomes an empty tensor) until the next gather.

Parameters the rule keeps whole, and the tensor-split MLP kernels
(``KFACShardedDense.split_``), stay ordinary parameters. On a world with
no fsdp axis nothing is split and every method is an identity.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Iterator, Tuple

import torch
import torch.nn as nn

from kfac_pytorch_tpu_torch.parallel.mesh import World
from kfac_pytorch_tpu_torch.shardwise import lenses


class FsdpParams:
    """This rank's fsdp parts of ``model``'s parameters placed
    :data:`shardwise.FSDP` by ``placements`` (``{name: placement}``,
    ``shardwise.lm_param_shardings``). Built whole; :meth:`shard_` cuts the
    parameters and the momentum buffers (after a resume and the starting
    broadcast, which see the whole state)."""

    def __init__(self, model: nn.Module, placements: Dict[str, object], world: World):
        self.world = world
        named = dict(model.named_parameters())
        self.params = {n: p for n, p in named.items()
                       if placements.get(n) == lenses.FSDP and world.fsdp_size > 1}
        self.shapes = {n: p.shape for n, p in self.params.items()}
        dtypes = {p.dtype for p in self.params.values()}
        if len(dtypes) > 1:
            raise ValueError(f"fsdp parameters of one dtype only, got {sorted(map(str, dtypes))}")
        self.flat = None
        self.parts: Dict[str, torch.Tensor] = {}

    @property
    def sharded(self) -> bool:
        return self.flat is not None

    def __contains__(self, name: str) -> bool:
        return name in self.params

    @torch.no_grad()
    def shard_(self, opt_state: Dict[str, torch.Tensor]) -> None:
        """Cut the whole parameters into this rank's flat buffer and the
        momentum buffers of ``opt_state`` into their parts (in place in
        the dict), then release the whole values."""
        if not self.params or self.sharded:
            return
        parts = [lenses.local_part(p.detach(), lenses.FSDP, self.world)
                 for p in self.params.values()]
        self.flat = torch.cat(parts)
        self.parts = dict(zip(self.params, self.flat.split([t.numel() for t in parts])))
        for n in self.params:
            opt_state[n] = lenses.local_part(opt_state[n], lenses.FSDP, self.world).clone()
        self.release()

    @torch.no_grad()
    def gather(self) -> None:
        """Every split parameter's whole value, from the fsdp slots' flat
        buffers (one gather)."""
        if not self.sharded:
            return
        f = self.world.fsdp_size
        rows = self.world.fsdp_all_gather_flat(self.flat).view(f, -1)
        off = 0
        for n, p in self.params.items():
            k = self.parts[n].numel()
            p.data = rows[:, off:off + k].reshape(self.shapes[n])
            off += k

    def release(self) -> None:
        """Drop the gathered values and their gradients."""
        for p in self.params.values():
            p.data = p.data.new_empty(0)
            p.grad = None

    @contextlib.contextmanager
    def gathered(self) -> Iterator[None]:
        """The whole parameters inside the block (evaluation)."""
        self.gather()
        try:
            yield
        finally:
            if self.sharded:
                self.release()

    def sgd_view(self, params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor]
                 ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
        """The optimizer's leaves: this rank's persistent part and flat
        gradient slice of each split parameter, the others as they are."""
        if not self.sharded:
            return params, grads
        return (
            {n: self.parts.get(n, p) for n, p in params.items()},
            {n: lenses.local_part(g, lenses.FSDP, self.world) if n in self.params else g
             for n, g in grads.items()},
        )

    def whole_params(self) -> Dict[str, torch.Tensor]:
        """Every split parameter's whole value, gathered (each rank of the
        fsdp subgroup must call it)."""
        if not self.sharded:
            return {n: p.detach() for n, p in self.params.items()}
        return {n: lenses.global_part(self.parts[n], lenses.FSDP, self.world, self.shapes[n])
                for n in self.params}

    def whole_momentum(self, opt_state: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """``opt_state`` with every split parameter's momentum gathered."""
        if not self.sharded:
            return dict(opt_state)
        return {n: lenses.global_part(m, lenses.FSDP, self.world, self.shapes[n])
                if n in self.params else m for n, m in opt_state.items()}
