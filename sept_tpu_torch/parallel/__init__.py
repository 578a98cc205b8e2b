"""Data parallelism: process groups, the DP train step and epoch runners.

Counterparts of ``sept_tpu/parallel``: one process a device, each a rank of
a ``torch.distributed`` group (:class:`DataGroup`) in place of a 1-D
``Mesh``; see :mod:`sept_tpu_torch.parallel.mesh`.  The JAX package's
``NamedSharding`` helpers (``batch_sharding``, ``replicated``,
``shard_batch``) have no counterpart: a rank takes its rows itself."""

from sept_tpu_torch.parallel.epoch_dp import make_cloak_epoch_runner_dp, make_epoch_runner_dp
from sept_tpu_torch.parallel.mesh import (
    DataGroup,
    barrier,
    broadcast_state,
    current_group,
    init_distributed,
    is_main,
    make_group,
    pad_batch_to_multiple,
    rank_generator,
    spawn,
    sync_gradients,
    visible_devices,
)
from sept_tpu_torch.parallel.shard_map_dp import make_dp_step

__all__ = [
    "DataGroup",
    "barrier",
    "broadcast_state",
    "current_group",
    "init_distributed",
    "is_main",
    "make_cloak_epoch_runner_dp",
    "make_dp_step",
    "make_epoch_runner_dp",
    "make_group",
    "pad_batch_to_multiple",
    "rank_generator",
    "spawn",
    "sync_gradients",
    "visible_devices",
]
