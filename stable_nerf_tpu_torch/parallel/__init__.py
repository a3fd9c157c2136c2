"""Training across processes (counterpart of stable_nerf_tpu/parallel/):
data parallelism over a torch.distributed process group
(:mod:`.sharding`) and fully-sharded data parallelism (:mod:`.fsdp`).
Tensor and sequence parallelism (the JAX package's ``tp.py`` and
``sp.py``) are not ported yet (ROADMAP.md §1)."""

from .fsdp import FSDP, joint_fsdp_specs, place_joint_for_fsdp
from .sharding import (Mesh, all_reduce_mean_, barrier, broadcast_, close_mesh,
                       fold_generator, make_mesh, make_parallel_train_step,
                       process_shard_indices, replicate, shard_batch)

__all__ = [
    "FSDP",
    "Mesh",
    "all_reduce_mean_",
    "barrier",
    "broadcast_",
    "close_mesh",
    "fold_generator",
    "joint_fsdp_specs",
    "make_mesh",
    "make_parallel_train_step",
    "place_joint_for_fsdp",
    "process_shard_indices",
    "replicate",
    "shard_batch",
]
