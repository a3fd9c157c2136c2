"""Sequence parallelism for the SDXL U-Net: ring attention over a ``seq``
axis (counterpart of stable_nerf_tpu/parallel/sp.py).

Each rank keeps only h·w/n latent tokens of every transformer interior;
self-attention rotates the k/v blocks one hop at a time round the axis
(``models.diffusion.nn.ring_sdpa``), cross-attention needs no collective
(its k/v come from the replicated conditioning tokens), and one gather a
transformer brings the token axis back for the convolutions.  It composes
with tensor parallelism on the (data × seq × model) mesh of
``sharding.make_mesh_3d``: heads over ``model``, tokens over ``seq``,
batch over ``data``.  A serving lever, as in the JAX package.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch

from ..models.diffusion.nn import ring_sdpa  # re-export: the sequence-parallel primitive
from ..utils.tree import tree_map
from .sharding import Mesh, make_mesh_3d
from .tp import axis_block, gather_dim, permute_unet_for_tp, shard_unet_for_tp, unet_tp_specs

__all__ = ["make_mesh_3d", "make_sp_unet_apply", "ring_sdpa", "serving_param_specs"]


def serving_param_specs(params: Dict, tp: int = 1,
                        unet_keys: Sequence[str] = ("unet",)) -> Tuple[Dict, Dict]:
    """A param tree ready for sharded serving and its specs: with ``tp`` > 1
    the U-Net's GEGLU kernels permuted for contiguous slices and the
    U-Net's specs per ``tp.unet_tp_specs``; every other spec None
    (replicated).  ``unet_keys`` locates the U-Net (("unet",) in a bare SD
    tree, ("sd", "unet") in the joint tree).  With tp == 1 the params come
    back unpermuted and every spec is None."""
    specs = tree_map(lambda _: None, params)
    if tp > 1:
        unet = params
        for k in unet_keys:
            unet = unet[k]
        unet = permute_unet_for_tp(unet, tp)

        def set_path(tree, keys, value):
            if not keys:
                return value
            out = dict(tree)
            out[keys[0]] = set_path(tree[keys[0]], keys[1:], value)
            return out

        params = set_path(params, list(unet_keys), unet)
        specs = set_path(specs, list(unet_keys), unet_tp_specs(unet))
    return params, specs


def make_sp_unet_apply(params: Dict, mesh: Mesh, cfg, seq_axis: str = "seq",
                       tp_axis: Optional[str] = None, data_axis: Optional[str] = None,
                       compute_dtype=torch.float32):
    """Sequence-parallel (with ``tp_axis``, also tensor-parallel) serving
    ``unet_apply`` over the named axes of ``mesh``.  Returns
    ``(local_params, apply_fn)`` with ``apply_fn(local_params, sample, t,
    ehs, text_embeds, time_ids)`` on the whole batch.  Params replicated
    over the seq axis, cut over the model axis where it is given; the
    batch split over ``data_axis`` where it is given and the outputs
    gathered back.  Every latent token count the U-Net visits must divide
    by the seq axis size (``unet_apply`` raises otherwise)."""
    from ..models.diffusion.unet import unet_apply

    seq = mesh.axes[seq_axis]
    model = mesh.axes[tp_axis] if tp_axis else None
    data = mesh.axes[data_axis] if data_axis else None
    local = shard_unet_for_tp(params, model) if model is not None else params

    def apply_fn(p, sample, t, ehs, text_embeds, time_ids):
        rows = [sample, torch.as_tensor(t, device=sample.device).expand(sample.shape[0]),
                ehs, text_embeds, time_ids]
        if data is not None:
            rows = [axis_block(x, 0, data) for x in rows]
        eps = unet_apply(p, rows[0], rows[1], rows[2], added_text_embeds=rows[3],
                         added_time_ids=rows[4], cfg=cfg, compute_dtype=compute_dtype,
                         tp_axis=model, sp_axis=seq)
        return gather_dim(eps, data, 0) if data is not None else eps

    return local, apply_fn
