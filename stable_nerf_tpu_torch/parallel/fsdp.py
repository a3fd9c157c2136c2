"""Fully-sharded data parallelism, ZeRO-3 with ZeRO-1 optimizer state
(counterpart of stable_nerf_tpu/parallel/fsdp.py).

The reference replicates the whole SDXL and its AdamW moments on every
DDP worker.  Here each rank keeps at rest only its slice of every large SD
leaf, frozen or trainable: the leaf split into ``world`` equal blocks along
one dimension, this rank's block stored flat.  The optimizer is built over
those slices, so the gradients it reads and its two AdamW moments are
slices too.

The step gathers the SD tree for use (one ``all_gather_into_tensor`` a
bucket), runs forward and backward on it, reduce-scatters the gradients
of the sharded trainable leaves back to the slices (summed, then divided
by the world size: the average of the ranks' gradients) and frees the
gathered tree.  The JAX package gets the same from XLA's partitioner,
which gathers a layer before its use; gathering per block is later work.

A fully-sharded step computes the global batch's step, as the JAX
package's step jitted on sharded arrays does.  Every stage of the joint
step treats samples apart but one, the reference's pairing of the ip
tokens (``sd_network.embed_conditions`` reshapes [2B, T, D] into
[B, 2T, D], so at B > 1 a sample's tokens come from other samples): the
ranks exchange their tokens and pair them over the global batch
(:func:`global_token_pairing`).  The data-parallel step, like the JAX
package's ``shard_map`` step, pairs each rank's own rows.

Which leaves shard follows the JAX package's rule (``_fsdp_upgrade_spec``):
an SD leaf of at least ``min_size`` elements with a dimension divisible by
the world size, split along the largest such dimension.  The NeRF stays
replicated: its hash-table gradient scatter (the CUDA kernel of
``ops/hopper/scatter.py``) runs against a device-local table.

Composed with tensor parallelism (a data × model mesh, ``tp_axis``) the
tree is first cut over the model axis (``tp.place_joint_for_tp``) and the
rank's tensor-parallel slices sharded over the data axis: TP's dimension
of a U-Net leaf survives, and FSDP claims another one, chosen on the whole
leaf's shape as the JAX package chooses it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..utils.tree import tree_leaves_with_path, tree_map_with_path
from .sharding import BUCKET_BYTES, Mesh
from .tp import TensorParallel, place_joint_for_tp, unet_tp_specs

MIN_SIZE = 1 << 15


def fsdp_dim(shape: Sequence[int], world: int, min_size: int = MIN_SIZE,
             taken: Optional[int] = None) -> Optional[int]:
    """The dimension a leaf of ``shape`` shards along over ``world`` ranks:
    the largest one divisible by ``world`` (the first of equals) but
    ``taken`` (tensor parallelism's), for a leaf of at least ``min_size``
    elements; None leaves it replicated."""
    size = 1
    for d in shape:
        size *= int(d)
    if size < min_size:
        return None
    best, best_dim = -1, None
    for i, d in enumerate(shape):
        if i != taken and int(d) % world == 0 and int(d) > best:
            best, best_dim = int(d), i
    return best_dim


def joint_fsdp_specs(params: Dict, world: int, *, tp_axis=None,
                     min_size: int = MIN_SIZE) -> Any:
    """A tree like the whole ``params`` holding each leaf's shard dimension
    over ``world`` data ranks, None where the leaf stays replicated: every
    NeRF leaf, every small SD leaf.  With ``tp_axis`` (the model axis TP
    cuts the U-Net over) the dimension TP shards a U-Net leaf along is not
    taken (JAX's ``joint_fsdp_specs(..., tp_axis="model")``)."""
    taken = {}
    if tp_axis is not None:
        taken = dict(tree_leaves_with_path(unet_tp_specs(params["sd"]["unet"]),
                                           "['sd']['unet']"))

    def spec(path, x):
        if path.startswith("['nerf']") or not isinstance(x, torch.Tensor) or x.ndim == 0:
            return None
        return fsdp_dim(x.shape, world, min_size, taken.get(path))

    return tree_map_with_path(spec, params)


@dataclass(frozen=True)
class _Leaf:
    path: Tuple            # keys from the root
    dim: int               # the dimension split over the ranks
    shape: Tuple[int, ...] # the whole leaf's shape
    dtype: torch.dtype

    @property
    def moved(self) -> Tuple[int, ...]:
        """The shape with the split dimension first."""
        return (self.shape[self.dim],) + tuple(s for i, s in enumerate(self.shape)
                                               if i != self.dim)

    @property
    def numel(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _paths(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _paths(tree[k], prefix + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _paths(v, prefix + (i,))
    else:
        yield prefix, tree


def _replace(tree, new: Dict[Tuple, Any], prefix=()):
    """``tree`` with the leaves at the paths of ``new`` replaced."""
    if prefix in new:
        return new[prefix]
    if isinstance(tree, dict):
        return {k: _replace(v, new, prefix + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_replace(v, new, prefix + (i,)) for i, v in enumerate(tree)]
    return tree


class FSDP:
    """The sharding of one joint param tree over a mesh, and the
    collectives that gather it for use and scatter its gradients back.
    Build it from the whole tree, then :meth:`shard` the tree."""

    def __init__(self, params: Dict, mesh: Mesh, *, min_size: int = MIN_SIZE,
                 specs: Optional[Any] = None):
        self.mesh = mesh
        # the tensor-parallel cut the tree went through first, if any
        self.tp: Optional[TensorParallel] = None
        if specs is None:
            specs = joint_fsdp_specs(params, mesh.world, min_size=min_size)
        self.leaves: List[_Leaf] = [
            _Leaf(path, dim, tuple(_get(params, path).shape), _get(params, path).dtype)
            for path, dim in _paths(specs) if dim is not None]
        self._by_id: Dict[int, _Leaf] = {}

    # -- layout -------------------------------------------------------------

    def specs(self) -> Dict[str, int]:
        """``jax.tree_util.keystr`` path → shard dimension of every sharded
        leaf (the non-``P()`` leaves of JAX's ``joint_fsdp_specs``)."""
        return {"".join(f"[{k!r}]" for k in leaf.path): leaf.dim for leaf in self.leaves}

    def local_slice(self, x: torch.Tensor, leaf: _Leaf) -> torch.Tensor:
        """This rank's block of a whole leaf, flat (a view where it can be)."""
        blocks = x.movedim(leaf.dim, 0).reshape(self.mesh.world, -1)
        return blocks[self.mesh.rank]

    def shard(self, params: Dict) -> Dict:
        """``params`` with each sharded leaf replaced by a contiguous copy of
        this rank's block (``requires_grad`` kept); the whole leaves are
        freed once the caller drops them."""
        new = {}
        with torch.no_grad():
            for leaf in self.leaves:
                x = _get(params, leaf.path)
                s = self.local_slice(x, leaf).contiguous().clone()
                new[leaf.path] = s.requires_grad_(x.requires_grad)
                self._by_id[id(new[leaf.path])] = leaf
        return _replace(params, new)

    def is_shard(self, t: torch.Tensor) -> bool:
        return id(t) in self._by_id

    # -- collectives ----------------------------------------------------------

    def _bucketed(self, items: List[Tuple[_Leaf, Any]]):
        """Runs of one dtype whose whole leaves add up to at most
        ``BUCKET_BYTES`` (a larger leaf is a run of its own)."""
        out, cur, size = [], [], 0
        for leaf, x in items:
            nbytes = leaf.numel * torch.empty((), dtype=leaf.dtype).element_size()
            if cur and (leaf.dtype != cur[0][0].dtype or size + nbytes > BUCKET_BYTES):
                out.append(cur)
                cur, size = [], 0
            cur.append((leaf, x))
            size += nbytes
        if cur:
            out.append(cur)
        return out

    def gather_leaves(self, items: List[Tuple[_Leaf, torch.Tensor]]) -> List[torch.Tensor]:
        """The whole tensors of ``(leaf, this rank's flat block)`` pairs, one
        ``all_gather_into_tensor`` a bucket.  Every rank passes the same
        leaves in the same order."""
        w, out = self.mesh.world, []
        with torch.no_grad():
            for bucket in self._bucketed(items):
                send = torch.cat([x.reshape(-1) for _, x in bucket])
                recv = torch.empty(w * send.numel(), dtype=send.dtype, device=send.device)
                dist.all_gather_into_tensor(recv, send, group=self.mesh.group)
                recv = recv.view(w, send.numel())
                off = 0
                for leaf, _ in bucket:
                    k = leaf.numel // w
                    whole = recv[:, off:off + k].reshape(leaf.moved).movedim(0, leaf.dim)
                    out.append(whole.contiguous())
                    off += k
                del recv, send
        return out

    def gather(self, params: Dict, *, with_grad: bool = True) -> Dict:
        """``params`` with each sharded leaf whole again.  A trainable leaf
        comes back as a new leaf tensor that requires grad (``with_grad``),
        whose gradient :meth:`reduce_scatter_grads` sends to the slice.  A
        None in ``params`` (a partition's other half) stays None."""
        items = [(leaf, _get(params, leaf.path)) for leaf in self.leaves]
        items = [(leaf, x) for leaf, x in items if x is not None]
        new = {}
        for (leaf, x), whole in zip(items, self.gather_leaves(items)):
            new[leaf.path] = whole.requires_grad_(with_grad and x.requires_grad)
        return _replace(params, new)

    def reduce_scatter_grads(self, gathered: Dict, params: Dict) -> None:
        """Average the gradients of the gathered trainable leaves over the
        ranks and add this rank's block of the average to the slice's
        ``.grad``: one ``reduce_scatter_tensor`` (a sum) a bucket, divided
        by the world size.  Drops the gathered leaves' gradients."""
        w = self.mesh.world
        items = []
        for leaf in self.leaves:
            whole = _get(gathered, leaf.path)
            if whole is not None and whole.grad is not None:
                items.append((leaf, whole))
        with torch.no_grad():
            for bucket in self._bucketed(items):
                ks = [leaf.numel // w for leaf, _ in bucket]
                send = torch.cat([whole.grad.movedim(leaf.dim, 0).reshape(w, k)
                                  for (leaf, whole), k in zip(bucket, ks)], dim=1)
                out = torch.empty(send.shape[1], dtype=send.dtype, device=send.device)
                dist.reduce_scatter_tensor(out, send.reshape(-1), op=dist.ReduceOp.SUM,
                                           group=self.mesh.group)
                out.div_(w)
                for (leaf, whole), piece in zip(bucket, out.split(ks)):
                    shard = _get(params, leaf.path)
                    if shard.grad is None:
                        shard.grad = piece.clone()
                    else:
                        shard.grad.add_(piece)
                    whole.grad = None
                del send, out

    # -- checkpoints ----------------------------------------------------------

    def shard_like(self, whole_tree: Dict) -> Dict:
        """A whole tree (a restored checkpoint, on any device) with each
        sharded leaf cut to this rank's flat block, to copy into the live
        slices."""
        new = {}
        for leaf in self.leaves:
            try:
                x = _get(whole_tree, leaf.path)
            except (KeyError, IndexError, TypeError):
                continue
            if isinstance(x, torch.Tensor):
                new[leaf.path] = self.local_slice(x, leaf).contiguous()
        return _replace(whole_tree, new)

    def _optimizer_params(self, optimizer) -> List[torch.Tensor]:
        return [p for g in optimizer.param_groups for p in g["params"]]

    def optimizer_state_dict(self, optimizer: torch.optim.Optimizer) -> Dict:
        """The optimizer's state dict in the single-device format: each
        sharded leaf's moments gathered whole (a collective: every rank
        calls it)."""
        sd = optimizer.state_dict()
        pending = []
        for i, p in enumerate(self._optimizer_params(optimizer)):
            leaf = self._by_id.get(id(p))
            if leaf is None or i not in sd["state"]:
                continue
            for name, v in sorted(sd["state"][i].items()):
                if isinstance(v, torch.Tensor) and v.numel() == p.numel() and v.ndim:
                    pending.append((i, name, leaf, v))
        wholes = self.gather_leaves([(leaf, v) for _, _, leaf, v in pending])
        state = {i: dict(s) for i, s in sd["state"].items()}
        for (i, name, _, _), whole in zip(pending, wholes):
            state[i][name] = whole
        return {"state": state, "param_groups": sd["param_groups"]}

    def load_optimizer_state_dict(self, optimizer: torch.optim.Optimizer,
                                  state_dict: Dict) -> None:
        """Load a single-device state dict: each sharded leaf's moments cut
        to this rank's block."""
        state = {}
        for i, p in enumerate(self._optimizer_params(optimizer)):
            s = state_dict["state"].get(i)
            if s is None:
                continue
            leaf = self._by_id.get(id(p))
            if leaf is not None:
                s = {k: (self.local_slice(v, leaf).contiguous()
                         if isinstance(v, torch.Tensor) and tuple(v.shape) == leaf.shape
                         else v) for k, v in s.items()}
            state[i] = s
        optimizer.load_state_dict({"state": state,
                                   "param_groups": state_dict["param_groups"]})


class _GatherRows(torch.autograd.Function):
    """All ranks' ``x`` stacked [world, ...]; the backward sums every rank's
    gradient of the stack and keeps this rank's row."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        out = torch.empty(mesh.world * x.numel(), dtype=x.dtype, device=x.device)
        dist.all_gather_into_tensor(out, x.contiguous().reshape(-1), group=mesh.group)
        return out.view((mesh.world,) + tuple(x.shape))

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, op=dist.ReduceOp.SUM, group=ctx.mesh.group)
        return grad[ctx.mesh.rank], None


def global_token_pairing(mesh: Mesh):
    """``embed_conditions``' pairing over the global batch: this rank's
    tokens [2b, T, D] (b targets, then b references) are gathered from
    every rank into the global order [all targets, all references],
    paired as the reference pairs one batch, and this rank's b rows of
    [B, 2T, D] returned."""
    def pair(tokens):
        b, rest = tokens.shape[0] // 2, tuple(tokens.shape[1:])
        every = _GatherRows.apply(tokens, mesh)            # [world, 2b, T, D]
        glob = torch.cat([every[:, :b].reshape((-1,) + rest),
                          every[:, b:].reshape((-1,) + rest)])
        paired = glob.reshape(glob.shape[0] // 2, 2 * rest[0], *rest[1:])
        return paired[mesh.rank * b:(mesh.rank + 1) * b]

    return pair


def place_joint_for_fsdp(params: Dict, mesh: Mesh, *, tp_axis: Optional[Mesh] = None,
                         min_size: int = MIN_SIZE) -> Tuple[Dict, FSDP]:
    """Shard the whole joint param tree over ``mesh`` (the data axis):
    returns this rank's tree (each sharded leaf its flat block) and the
    :class:`FSDP` that gathers it.  Build the optimizer over the returned
    tree, so its gradients and moments are blocks too.  With ``tp_axis``
    the tree is cut for tensor parallelism first; the returned layout's
    ``tp`` gathers that cut back."""
    specs = joint_fsdp_specs(params, mesh.world, tp_axis=tp_axis, min_size=min_size)
    tp = None
    if tp_axis is not None:
        params, tp = place_joint_for_tp(params, tp_axis)
    layout = FSDP(params, mesh, specs=specs)
    layout.tp = tp
    return layout.shard(params), layout
