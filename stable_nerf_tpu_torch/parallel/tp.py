"""Tensor parallelism for the SDXL U-Net over a ``model`` axis
(counterpart of stable_nerf_tpu/parallel/tp.py).

Megatron's split of every transformer block: the attention heads
(``to_q``, ``to_k``, ``to_v`` and the IP heads ``to_k_ip``, ``to_v_ip``)
and the GEGLU hidden width (``ff_geglu``) are column-sharded, the output
projections (``to_out``, ``ff_out``) row-sharded, and one all-reduce a
projection sums the partial outputs.  Convolutions, norms, the time
embeddings and the conditioning path stay replicated.

The JAX package has two styles: explicit collectives under ``shard_map``
for serving, and GSPMD placement for training, where XLA reshards the
GEGLU split and needs no permutation.  Here one explicit style serves
both: each rank holds its contiguous slice of every sharded leaf, the
GEGLU columns permuted first (:func:`permute_unet_for_tp`) so that a
slice's first half is its ``val`` block and its second half its ``gate``
block, in training too.  Two autograd functions carry the collectives:
:func:`copy_to_model` on the input of every column-sharded projection
(identity forward, gradient all-reduced) and :func:`reduce_from_model` on
the output of every row-sharded one (all-reduce forward, identity
backward), so the replicated leaves' gradients come out whole and equal
on every rank of the model axis.  Checkpoints keep the single-device,
unpermuted layout (:class:`TensorParallel`).

SDXL's 10 and 20 heads admit tp ∈ {2, 5, 10}.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..utils.tree import tree_leaves_with_path, tree_map_with_path
from .sharding import Mesh, count

# param dicts column-sharded on the output dim (bias, if any, sharded too)
_COL = {"to_q", "to_k", "to_v", "to_k_ip", "to_v_ip", "ff_geglu"}
# param dicts row-sharded on the input dim (bias replicated, added after the sum)
_ROW = {"to_out", "ff_out"}


# -- the collectives -----------------------------------------------------------

def _all_reduce_(x: torch.Tensor, axis: Mesh) -> torch.Tensor:
    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=axis.group)
    count(axis, "tp_all_reduce_bytes", x.numel() * x.element_size())
    count(axis, "tp_all_reduce_calls", 1)
    return x


class _CopyToModel(torch.autograd.Function):
    """Identity forward; the gradient summed over the model axis (each
    rank's heads contribute a part of the input's gradient)."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce_(grad.contiguous().clone(), ctx.axis), None


class _ReduceFromModel(torch.autograd.Function):
    """The partial outputs summed over the model axis; identity backward
    (every rank holds the whole output's gradient).  Not
    ``torch.distributed.nn.functional.all_reduce``, whose backward sums the
    gradient again and so multiplies the replicated leaves' gradients by
    the axis size."""

    @staticmethod
    def forward(ctx, x, axis):
        return _all_reduce_(x.contiguous().clone(), axis)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherDim(torch.autograd.Function):
    """Every rank's ``x`` concatenated along ``dim`` in axis order; the
    backward keeps this rank's block of the gradient (what follows the
    gather runs alike on every rank)."""

    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim, ctx.size = axis, dim, x.shape[dim]
        x = x.contiguous()
        out = torch.empty(axis.world * x.numel(), dtype=x.dtype, device=x.device)
        dist.all_gather_into_tensor(out, x.reshape(-1), group=axis.group)
        count(axis, "gather_bytes", out.numel() * out.element_size())
        count(axis, "gather_calls", 1)
        out = out.view((axis.world,) + tuple(x.shape)).movedim(0, dim)
        shape = list(x.shape)
        shape[dim] *= axis.world
        return out.reshape(shape)

    @staticmethod
    def backward(ctx, grad):
        return grad.narrow(ctx.dim, ctx.axis.rank * ctx.size, ctx.size), None, None


def copy_to_model(x: torch.Tensor, axis: Mesh) -> torch.Tensor:
    return _CopyToModel.apply(x, axis)


def reduce_from_model(x: torch.Tensor, axis: Mesh) -> torch.Tensor:
    return _ReduceFromModel.apply(x, axis)


def gather_dim(x: torch.Tensor, axis: Mesh, dim: int) -> torch.Tensor:
    """``jax.lax.all_gather(x, axis, axis=dim, tiled=True)``."""
    return _GatherDim.apply(x, axis, dim)


# -- the layout ------------------------------------------------------------------

def _map_tp_tree(params: Any, leaf_fn: Callable, name: Optional[str] = None) -> Any:
    """Mirror the U-Net param tree, calling ``leaf_fn(kind, key, leaf)`` with
    kind ∈ {"col", "row", "rep"} for every leaf."""
    if isinstance(params, dict):
        if name in _COL:
            return {k: leaf_fn("col", k, v) for k, v in params.items()}
        if name in _ROW:
            return {k: leaf_fn("row", k, v) for k, v in params.items()}
        return {k: _map_tp_tree(v, leaf_fn, k) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return [_map_tp_tree(v, leaf_fn, name) for v in params]
    return leaf_fn("rep", name, params)


def unet_tp_specs(params: Dict) -> Dict:
    """A tree like the U-Net's holding each leaf's sharded dimension, None
    where it is replicated (JAX's ``P(None, "model")`` is 1, ``P("model")``
    0, ``P()`` None)."""
    def leaf(kind, key, v):
        if kind == "col":
            return 1 if key == "kernel" else 0
        if kind == "row":
            return 0 if key == "kernel" else None
        return None
    return _map_tp_tree(params, leaf)


def _geglu_col_perm(hidden: int, tp: int) -> np.ndarray:
    """Column permutation making each contiguous 1/tp slice of the GEGLU
    kernel hold [val_i | gate_i], so a rank's ``chunk(2)`` of its columns
    is the unsharded split's (diffusers GEGLU: val = first half, gate =
    second half of the 8c projection)."""
    half = hidden // 2
    if half % tp:
        raise ValueError(f"GEGLU half width {half} not divisible by tp={tp}")
    m = half // tp
    order = []
    for i in range(tp):
        order.extend(range(i * m, (i + 1) * m))                 # val block i
        order.extend(range(half + i * m, half + (i + 1) * m))   # gate block i
    return np.asarray(order)


def _geglu_perm(hidden: int, tp: int, inverse: bool) -> torch.Tensor:
    perm = _geglu_col_perm(hidden, tp)
    return torch.from_numpy(np.argsort(perm) if inverse else perm)


def permute_unet_for_tp(params: Dict, tp: int, inverse: bool = False) -> Dict:
    """Permute every ``ff_geglu`` kernel and bias for contiguous tp
    sharding (``inverse``: back to the checkpoint layout); every other leaf
    is returned as it is.  Attention needs no permutation: contiguous
    column blocks are contiguous head groups, and the row-sharded outputs
    split in the same block order."""
    def rec(node, name=None):
        if isinstance(node, dict):
            if name == "ff_geglu":
                perm = _geglu_perm(node["kernel"].shape[1], tp, inverse)
                out = {"kernel": node["kernel"][:, perm.to(node["kernel"].device)]}
                if "bias" in node:
                    out["bias"] = node["bias"][perm.to(node["bias"].device)]
                return out
            return {k: rec(v, k) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [rec(v, name) for v in node]
        return node

    return rec(params)


def axis_block(x: torch.Tensor, dim: int, axis: Mesh) -> torch.Tensor:
    """This rank's contiguous 1/n block of ``x`` along ``dim`` (a view)."""
    k = x.shape[dim] // axis.world
    return x.narrow(dim, axis.rank * k, k)


class TensorParallel:
    """The tensor-parallel cut of a U-Net inside a param tree (the joint
    ``{"sd": {"unet": ...}}`` tree by default) over a model axis: which
    leaves are sharded, along which dimension, and which carry the GEGLU
    permutation.  :meth:`shard` cuts a whole tree to this rank's slices,
    :meth:`gather` joins them back into the single-device layout (a
    collective: every rank of the axis calls it)."""

    def __init__(self, params: Dict, axis: Mesh, unet_keys: Sequence[str] = ("sd", "unet")):
        self.axis = axis
        unet = params
        for k in unet_keys:
            unet = unet[k]
        prefix = "".join(f"[{k!r}]" for k in unet_keys)
        specs = unet_tp_specs(unet)
        self.leaves: Dict[str, Tuple[int, bool]] = {}
        for (path, dim), (_, x) in zip(tree_leaves_with_path(specs),
                                          tree_leaves_with_path(unet)):
            if dim is None:
                continue
            if x.shape[dim] % axis.world:
                raise ValueError(f"{prefix}{path}: dimension {dim} of {tuple(x.shape)} "
                                 f"not divisible by tp={axis.world}")
            self.leaves[prefix + path] = (dim, "['ff_geglu']" in path)

    def _permute(self, x: torch.Tensor, path: str, inverse: bool) -> torch.Tensor:
        dim, geglu = self.leaves[path]
        if not geglu or self.axis.world == 1:
            return x
        perm = _geglu_perm(x.shape[dim], self.axis.world, inverse).to(x.device)
        return x.index_select(dim, perm)

    def cut(self, x: torch.Tensor, path: str) -> torch.Tensor:
        """This rank's contiguous slice of the whole leaf at ``path``
        (permuted first where it is a GEGLU leaf)."""
        with torch.no_grad():
            dim, _ = self.leaves[path]
            return axis_block(self._permute(x, path, False), dim, self.axis).contiguous().clone()

    def join(self, x: torch.Tensor, path: str) -> torch.Tensor:
        """The whole leaf at ``path`` from every rank's slice ``x``, in the
        single-device layout."""
        with torch.no_grad():
            dim, _ = self.leaves[path]
            return self._permute(gather_dim(x.detach(), self.axis, dim), path, True)

    def shard(self, params: Any) -> Any:
        """``params`` with each sharded leaf replaced by this rank's slice
        (``requires_grad`` kept); None leaves (a partition's other half)
        stay None."""
        def leaf(path, x):
            if path not in self.leaves or x is None:
                return x
            return self.cut(x, path).requires_grad_(x.requires_grad)
        return tree_map_with_path(leaf, params)

    def gather(self, params: Any) -> Any:
        """``params`` with each sharded leaf whole and unpermuted again."""
        def leaf(path, x):
            if path not in self.leaves or x is None:
                return x
            return self.join(x, path)
        return tree_map_with_path(leaf, params)

    def gather_optimizer_state(self, state_dict: Dict, paths: List[str]) -> Dict:
        """An optimizer state dict whose parameter ``i`` sits at ``paths[i]``
        with each sharded leaf's moments joined whole (a collective)."""
        return self._map_state(state_dict, paths, self.join)

    def shard_optimizer_state(self, state_dict: Dict, paths: List[str]) -> Dict:
        """A single-device optimizer state dict cut to this rank's slices."""
        return self._map_state(state_dict, paths, self.cut)

    def _map_state(self, state_dict, paths, fn):
        state = {}
        for i, s in state_dict["state"].items():
            path = paths[i]
            if path in self.leaves:
                s = {k: fn(v, path) if isinstance(v, torch.Tensor) and v.ndim else v
                     for k, v in s.items()}
            state[i] = s
        return {"state": state, "param_groups": state_dict["param_groups"]}


def shard_unet_for_tp(params: Dict, axis: Mesh) -> Dict:
    """A whole U-Net tree permuted and cut to this rank's slices (counterpart
    of the JAX ``shard_unet_for_tp``, which returns the placed tree and its
    specs; here every rank holds only its own slices).  The inverse, the
    slices joined and unpermuted, is ``TensorParallel(...).gather``."""
    return TensorParallel(params, axis, unet_keys=()).shard(params)


def place_joint_for_tp(params: Dict, axis: Mesh) -> Tuple[Dict, TensorParallel]:
    """Cut the joint ``{"sd", "nerf"}`` tree for tensor-parallel training
    (counterpart of ``place_joint_for_gspmd``): the U-Net's attention and
    GEGLU leaves to this rank's slices, everything else (VAE, image
    projection, NeRF, the conditioning caches) whole.  Returns this rank's
    tree and the :class:`TensorParallel` that gathers it back; build the
    optimizer over the returned tree, so its moments are slices too."""
    layout = TensorParallel(params, axis)
    return layout.shard(params), layout


def make_tp_unet_apply(params: Dict, mesh: Mesh, cfg, axis: str = "model",
                       data_axis: Optional[str] = None, compute_dtype=torch.float32):
    """Tensor-parallel ``unet_apply`` for serving (counterpart of the JAX
    ``make_tp_unet_apply``).  Returns ``(local_params, apply_fn)`` with
    ``apply_fn(local_params, sample, t, ehs, text_embeds, time_ids)`` on the
    whole batch.  With ``data_axis`` the batch is split over that axis of
    ``mesh`` as well and the outputs gathered back."""
    from ..models.diffusion.unet import unet_apply

    tp_axis = mesh.axes[axis]
    data = mesh.axes[data_axis] if data_axis else None
    local = shard_unet_for_tp(params, tp_axis)

    def apply_fn(p, sample, t, ehs, text_embeds, time_ids):
        rows = [sample, torch.as_tensor(t, device=sample.device).expand(sample.shape[0]),
                ehs, text_embeds, time_ids]
        if data is not None:
            rows = [axis_block(x, 0, data) for x in rows]
        eps = unet_apply(p, rows[0], rows[1], rows[2], added_text_embeds=rows[3],
                         added_time_ids=rows[4], cfg=cfg, compute_dtype=compute_dtype,
                         tp_axis=tp_axis)
        return gather_dim(eps, data, 0) if data is not None else eps

    return local, apply_fn
