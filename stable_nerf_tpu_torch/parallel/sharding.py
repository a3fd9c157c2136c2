"""Data-parallel scale-out over a torch.distributed process group
(counterpart of stable_nerf_tpu/parallel/sharding.py).

One process per card, as PyTorch runs data parallelism: each process
holds the whole parameter tree on its own device, reads its own slice of
the data, and averages the gradients with the others before every update.
The JAX package's 1-D ``data`` mesh becomes a :class:`Mesh` here: the
process group, this process's rank and the world size, and the device.
Collectives are NCCL's on the card and gloo's on the CPU; another backend
is used only where the caller names it.

As in the JAX package the NeRF's gradients are averaged too (the
reference's DDP exempts the NeRF; SURVEY.md §2.3).  The parameter trees
are dicts of tensors, not ``nn.Module``s, so the average is an explicit
all-reduce over flattened buckets of gradients rather than
``DistributedDataParallel``'s module wrapper.

The JAX package's 2-D (data × model) and 3-D (data × seq × model) meshes
are :func:`make_mesh_2d` and :func:`make_mesh_3d`: the world's ranks laid
out in the JAX device order, model innermost, each named axis a process
group of its own (``Mesh.axes``), on the world's backend.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..utils.device import resolve_device
from ..utils.tree import tree_leaves

# flattened collectives move at most this many bytes each: the flagship's
# ~1.45 GB of trainable gradients go in ~12 calls, with one bucket's copy
# held beside them
BUCKET_BYTES = 1 << 27


@dataclass(eq=False)
class Mesh:
    """A world of processes, or one axis of one.  ``group``, ``rank`` and
    ``world`` are the process group, this process's index in it and its
    size; ``ranks`` its members' global ranks in index order.  ``axes``
    maps each axis name to the 1-D mesh of this process's group along it
    (a 1-D mesh is its own ``data`` axis), so the data-parallel and
    fully-sharded code takes ``mesh.axes["data"]`` of any mesh.
    ``counts`` tallies the bytes and calls of the collectives, shared by a
    world and its axes, for the measurements that read them."""

    group: Any
    rank: int
    world: int
    device: torch.device
    backend: str
    counts: Dict[str, int] = field(default_factory=lambda: {"all_reduce_bytes": 0,
                                                            "all_reduce_calls": 0})
    ranks: List[int] = field(default_factory=list)
    axes: Dict[str, "Mesh"] = field(default_factory=dict, repr=False)

    def __post_init__(self):
        if not self.ranks:
            self.ranks = list(range(self.world))
        if not self.axes:
            self.axes = {"data": self}

    @property
    def shape(self) -> Dict[str, int]:
        """Axis name → size, outermost first."""
        return {name: axis.world for name, axis in self.axes.items()}


def count(mesh: Mesh, key: str, n: int) -> None:
    """Add ``n`` to the mesh's tally ``key``."""
    mesh.counts[key] = mesh.counts.get(key, 0) + n


def _backend_for(dev: torch.device) -> str:
    return "nccl" if dev.type == "cuda" else "gloo"


def make_mesh(device=None, *, backend: Optional[str] = None,
              init_method: Optional[str] = None, rank: Optional[int] = None,
              world_size: Optional[int] = None) -> Mesh:
    """The data-parallel world of this process on ``device`` (default cuda).

    Adopts the default process group when one is initialized already (a
    launcher's, or the CLI's ``--coordinator``).  Otherwise initializes it:
    at ``init_method`` with ``rank`` and ``world_size`` (``env://`` reads
    torchrun's ``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``),
    or, with neither given, as a world of one on an in-process store.

    The backend follows the device (NCCL on cuda, gloo on the CPU) unless
    ``backend`` names one; a group of another backend than the device's is
    refused unless named.  A failed NCCL initialization raises: there is no
    fall back to gloo."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(dev)
    want = backend or _backend_for(dev)
    if dist.is_initialized():
        have = dist.get_backend()
        if have != want:
            raise ValueError(f"the process group runs {have}, the device {dev} wants "
                             f"{want}: name the backend to use {have}")
        return Mesh(dist.group.WORLD, dist.get_rank(), dist.get_world_size(), dev, have)
    kw = {}
    if want == "nccl":
        # bind the communicator to the card now: a failed NCCL init raises
        # here, not at the first collective
        kw["device_id"] = dev
    if init_method is None and world_size in (None, 1):
        dist.init_process_group(want, store=dist.HashStore(), rank=0, world_size=1, **kw)
    else:
        dist.init_process_group(want, init_method=init_method or "env://", rank=rank,
                                world_size=world_size, **kw)
    return Mesh(dist.group.WORLD, dist.get_rank(), dist.get_world_size(), dev, want)


def close_mesh() -> None:
    """Destroy the default process group, where one is initialized."""
    if dist.is_initialized():
        dist.destroy_process_group()


def make_mesh_3d(device=None, *, sp: int = 1, tp: int = 1, **kw) -> Mesh:
    """The (data × seq × model) mesh of this process's world (counterpart
    of ``stable_nerf_tpu.parallel.sp.make_mesh_3d``), the world adopted or
    initialized as :func:`make_mesh` does (``kw``: its ``backend``,
    ``init_method``, ``rank``, ``world_size``).  The JAX device order: model
    innermost, seq next, so rank ``r`` has model index ``r % tp``, seq index
    ``(r // tp) % sp`` and data index ``r // (sp·tp)``.  Each axis is a
    process group on the world's backend (the world's own group where the
    axis spans it).  Every rank calls this with the same sizes: making a
    group is a collective.  A world that ``sp·tp`` does not divide is
    refused before any group is made."""
    return _mesh_of(device, {"data": None, "seq": sp, "model": tp}, kw)


def make_mesh_2d(device=None, *, tp: int = 1, **kw) -> Mesh:
    """The (data × model) mesh (counterpart of
    ``stable_nerf_tpu.parallel.tp.make_mesh_2d``): :func:`make_mesh_3d`
    without a seq axis."""
    return _mesh_of(device, {"data": None, "model": tp}, kw)


def _mesh_of(device, sizes: Dict[str, Optional[int]], kw) -> Mesh:
    """The world with the axes of ``sizes`` (outermost first; None: the
    world over the others' product)."""
    n = dist.get_world_size() if dist.is_initialized() else (kw.get("world_size") or 1)
    inner = math.prod(v for v in sizes.values() if v is not None)
    if n % inner:
        names = "*".join(k for k, v in sizes.items() if v is not None)
        raise ValueError(f"{n} processes not divisible by {names}={inner}")
    return _with_axes(make_mesh(device, **kw),
                      {k: n // inner if v is None else v for k, v in sizes.items()})


def _with_axes(world: Mesh, sizes: Dict[str, int]) -> Mesh:
    """``world`` with one group an axis of ``sizes`` (outermost first; the
    last axis innermost)."""
    names = list(sizes)
    strides, s = {}, 1
    for name in reversed(names):
        strides[name] = s
        s *= sizes[name]
    world.axes = {}
    for name in names:
        size, stride = sizes[name], strides[name]
        members = [[r + i * stride for i in range(size)] for r in range(world.world)
                   if (r // stride) % size == 0]
        mine = next(m for m in members if world.rank in m)
        if size == world.world:
            group = world.group
        else:
            group, _ = dist.new_subgroups_by_enumeration(members, backend=world.backend)
        world.axes[name] = Mesh(group, mine.index(world.rank), size, world.device,
                                world.backend, world.counts, mine)
        world.axes[name].axes = {name: world.axes[name]}
    return world


def process_shard_indices(n_samples: int, mesh: Mesh) -> np.ndarray:
    """This rank's contiguous slice of ``n_samples`` indices.  Every rank
    gets exactly ``n_samples // world``: the remainder is dropped, never
    given to the last rank, since unequal slices would let ranks disagree
    on the batches an epoch and the extra batch's first collective would
    hang the others (torch's DistributedSampler equalizes ranks for the
    same reason)."""
    per = n_samples // mesh.world
    start = mesh.rank * per
    return np.arange(start, start + per)


def barrier(mesh: Mesh) -> None:
    """Wait until every rank arrives (the reference's
    ``accelerator.wait_for_everyone()``): a one-element all-reduce on the
    mesh's device, read back, so it also waits for this rank's queued
    device work."""
    t = torch.zeros(1, device=mesh.device)
    dist.all_reduce(t, group=mesh.group)
    t.item()


def _buckets(tensors: Sequence[torch.Tensor]) -> List[List[torch.Tensor]]:
    """Consecutive runs of one dtype of at most ``BUCKET_BYTES`` (a tensor
    larger than that is a bucket of its own)."""
    out, cur, size = [], [], 0
    for t in tensors:
        nbytes = t.numel() * t.element_size()
        if cur and (t.dtype != cur[0].dtype or size + nbytes > BUCKET_BYTES):
            out.append(cur)
            cur, size = [], 0
        cur.append(t)
        size += nbytes
    if cur:
        out.append(cur)
    return out


def _flat(t: torch.Tensor) -> torch.Tensor:
    # NCCL and gloo reduce no bool: move bools as bytes
    flat = t.reshape(-1)
    return flat.view(torch.uint8) if t.dtype == torch.bool else flat


def _unflat(piece: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    return (piece.view(torch.bool) if t.dtype == torch.bool else piece).view(t.shape)


def all_reduce_mean_(tensors: Sequence[torch.Tensor], mesh: Mesh) -> None:
    """Average ``tensors`` over the ranks in place: each bucket flattened
    into one buffer, summed (``ReduceOp.AVG`` is NCCL's alone) and divided
    by the world size."""
    with torch.no_grad():
        for bucket in _buckets(list(tensors)):
            flat = torch.cat([t.reshape(-1) for t in bucket])
            dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=mesh.group)
            flat.div_(mesh.world)
            count(mesh, "all_reduce_bytes", flat.numel() * flat.element_size())
            count(mesh, "all_reduce_calls", 1)
            for t, piece in zip(bucket, flat.split([t.numel() for t in bucket])):
                t.copy_(piece.view_as(t))


def broadcast_(tensors: Sequence[torch.Tensor], mesh: Mesh) -> None:
    """Overwrite ``tensors`` in place with rank 0's values."""
    with torch.no_grad():
        for bucket in _buckets(list(tensors)):
            flat = torch.cat([_flat(t) for t in bucket])
            dist.broadcast(flat, src=0, group=mesh.group)
            for t, piece in zip(bucket, flat.split([t.numel() for t in bucket])):
                t.copy_(_unflat(piece, t))


def replicate(tree: Any, mesh: Mesh) -> Any:
    """Make every tensor leaf of ``tree`` equal rank 0's, in place, so every
    rank starts bit-equal; returns ``tree``."""
    broadcast_([x for x in tree_leaves(tree) if isinstance(x, torch.Tensor)], mesh)
    return tree


def shard_batch(batch: Dict, mesh: Mesh) -> Dict:
    """This rank's rows of a global batch that every rank holds: the
    leading axis split into ``world`` contiguous blocks."""
    out = {}
    for k, v in batch.items():
        n = v.shape[0]
        if n % mesh.world:
            raise ValueError(f"batch {k!r} of {n} rows does not split over "
                             f"{mesh.world} ranks")
        per = n // mesh.world
        out[k] = v[mesh.rank * per:(mesh.rank + 1) * per]
    return out


def fold_generator(generator: torch.Generator, rank: int) -> torch.Generator:
    """A generator of this rank's own stream, seeded from one draw of
    ``generator`` (which every rank advances alike) and the rank: the
    counterpart of ``jax.random.fold_in(key, axis_index)``, so noise,
    timesteps and ray jitter differ across ranks as across DDP workers."""
    draw = int(torch.randint(0, 2 ** 62, (1,), generator=generator,
                             device=generator.device).item())
    seed = int(np.random.SeedSequence([draw, rank]).generate_state(1, np.uint64)[0])
    return torch.Generator(device=generator.device).manual_seed(seed >> 1)


def make_parallel_train_step(step_fn: Callable, mesh: Mesh) -> Callable:
    """Wrap a train step built with ``make_train_step(..., mesh=mesh)``
    (which averages its gradients and metrics over the ranks) into the
    per-rank step: ``step(params, grid_state, batch, generator=None,
    draws=None)`` with ``batch`` this rank's rows and ``generator`` the
    stream every rank shares, folded here with the rank.  Params,
    optimizer state and grid state stay equal on every rank, since every
    rank applies the same averaged update."""

    def step(params, grid_state, batch, generator=None, draws=None):
        g = fold_generator(generator, mesh.rank) if generator is not None else None
        return step_fn(params, grid_state, batch, generator=g, draws=draws)

    return step
