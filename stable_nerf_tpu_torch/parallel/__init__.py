"""Scale-out across processes (counterpart of stable_nerf_tpu/parallel/):
data parallelism and the multi-axis meshes over torch.distributed process
groups (:mod:`.sharding`), fully-sharded data parallelism (:mod:`.fsdp`),
tensor parallelism of the U-Net (:mod:`.tp`) and sequence parallelism
with ring attention (:mod:`.sp`)."""

from .fsdp import FSDP, joint_fsdp_specs, place_joint_for_fsdp
from .sharding import (Mesh, all_reduce_mean_, barrier, broadcast_, close_mesh,
                       fold_generator, make_mesh, make_mesh_2d, make_mesh_3d,
                       make_parallel_train_step, process_shard_indices, replicate,
                       shard_batch)
from .sp import make_sp_unet_apply, ring_sdpa, serving_param_specs
from .tp import (TensorParallel, make_tp_unet_apply,
                 permute_unet_for_tp, place_joint_for_tp, shard_unet_for_tp,
                 unet_tp_specs)

__all__ = [
    "FSDP",
    "Mesh",
    "TensorParallel",
    "all_reduce_mean_",
    "barrier",
    "broadcast_",
    "close_mesh",
    "fold_generator",
    "joint_fsdp_specs",
    "make_mesh",
    "make_mesh_2d",
    "make_mesh_3d",
    "make_parallel_train_step",
    "make_sp_unet_apply",
    "make_tp_unet_apply",
    "permute_unet_for_tp",
    "place_joint_for_fsdp",
    "place_joint_for_tp",
    "process_shard_indices",
    "replicate",
    "ring_sdpa",
    "serving_param_specs",
    "shard_batch",
    "shard_unet_for_tp",
    "unet_tp_specs",
]
