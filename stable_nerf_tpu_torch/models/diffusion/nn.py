"""Functional NN primitives of the diffusion models (counterpart of
stable_nerf_tpu/models/diffusion/nn.py).

Param layout, kept from the reference package:
  conv:   {"kernel": [O, I, kh, kw], "bias": [O]}   (OIHW)
  linear: {"kernel": [in, out], "bias": [out]?}
  norm:   {"scale": [C], "bias": [C]}
Activations are NCHW.  A weight is cast to the activation's dtype at use,
so frozen weights may be stored in bf16 while an f32 path (the VAE
encode) still computes in f32.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.distributed as dist
import torch.nn.functional as F


def uniform(generator: torch.Generator, shape, scale: float) -> torch.Tensor:
    """U(-scale, scale) float32 tensor on the generator's device.  A
    generator on the ``meta`` device (``META_GENERATOR``) draws nothing:
    the result only has the shape, as a template needs."""
    t = torch.empty(shape, dtype=torch.float32, device=generator.device)
    if t.is_meta:
        return t
    return t.uniform_(-scale, scale, generator=generator)


class _MetaGenerator:
    """Stands for a ``torch.Generator`` in the init functions, which read
    only its ``device``: they then build shape-only trees at no memory."""

    device = torch.device("meta")


META_GENERATOR = _MetaGenerator()


def conv2d(p: Dict, x: torch.Tensor, stride: int = 1, padding: int = 1) -> torch.Tensor:
    bias = p["bias"].to(x.dtype) if "bias" in p else None
    return F.conv2d(x, p["kernel"].to(x.dtype), bias, stride=stride, padding=padding)


def linear(p: Dict, x: torch.Tensor) -> torch.Tensor:
    out = x @ p["kernel"].to(x.dtype)
    if "bias" in p:
        out = out + p["bias"].to(x.dtype)
    return out


def group_norm(p: Dict, x: torch.Tensor, groups: int = 32, eps: float = 1e-6) -> torch.Tensor:
    """GroupNorm over NCHW with float32 statistics and affine, cast back to
    the input's dtype."""
    xf = F.group_norm(x.float(), groups, eps=eps)
    out = xf * p["scale"][None, :, None, None] + p["bias"][None, :, None, None]
    return out.to(x.dtype)


def layer_norm(p: Dict, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = F.layer_norm(x.float(), (x.shape[-1],), eps=eps)
    return (xf * p["scale"] + p["bias"]).to(x.dtype)


def silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Scaled dot-product attention over [B, H, S, D].

    Logits are float32 whatever the input type: for bf16 inputs the scaled
    q is rounded to bf16 and the products of the bf16 operands are summed
    in f32 (the reference's preferred_element_type=float32); the softmax is
    f32 and the probabilities are cast to v's dtype for the second
    product."""
    scale = q.shape[-1] ** -0.5
    if q.dtype == torch.bfloat16:
        qs = (q * scale).to(q.dtype).float()
    else:
        qs = q.float() * scale
    logits = qs @ k.float().transpose(-1, -2)
    attn = torch.softmax(logits, dim=-1)
    return attn.to(v.dtype) @ v


def ring_shift(x: torch.Tensor, axis, reverse: bool = False) -> torch.Tensor:
    """One hop of the ring over ``axis`` (a ``parallel.sharding.Mesh``):
    send ``x`` to the next index, return the previous index's block
    (``reverse``: the other way round).

    The transport follows the axis's backend.  NCCL, and gloo on CPU
    tensors, carry the block as it is (``batch_isend_irecv``).  gloo on
    CUDA tensors (two ranks sharing one card) stages the block through a
    host tensor: gloo's point-to-point path reads the tensor's memory from
    the host."""
    n, i = axis.world, axis.rank
    step = -1 if reverse else 1
    dst, src = axis.ranks[(i + step) % n], axis.ranks[(i - step) % n]
    staged = axis.backend == "gloo" and x.is_cuda
    send = x.detach().contiguous()
    if staged:
        send = send.cpu()
    recv = torch.empty_like(send)
    ops = [dist.P2POp(dist.isend, send, dst, axis.group),
           dist.P2POp(dist.irecv, recv, src, axis.group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    axis.counts["ring_hops"] = axis.counts.get("ring_hops", 0) + 1
    axis.counts["ring_bytes"] = (axis.counts.get("ring_bytes", 0)
                                 + send.numel() * send.element_size())
    return recv.to(x.device) if staged else recv


def _scaled_q(q: torch.Tensor) -> torch.Tensor:
    """``sdpa``'s float32 logits operand: the scaled q rounded to bf16 for
    bf16 inputs, scaled in float32 otherwise."""
    scale = q.shape[-1] ** -0.5
    if q.dtype == torch.bfloat16:
        return (q * scale).to(q.dtype).float()
    return q.float() * scale


class _RingSDPA(torch.autograd.Function):
    """Ring attention: the forward folds the k/v blocks as they arrive into
    float32 online-softmax accumulators; the backward recomputes each
    block's probabilities from the saved log-sum-exp and sends dk/dv round
    the ring the other way, so each block's gradient arrives home after
    n - 1 hops."""

    @staticmethod
    def forward(ctx, q, k, v, axis):
        n = axis.world
        qs = _scaled_q(q)
        B, H, Sq, D = q.shape
        m = torch.full((B, H, Sq), -math.inf, dtype=torch.float32, device=q.device)
        l = torch.zeros((B, H, Sq), dtype=torch.float32, device=q.device)
        acc = torch.zeros((B, H, Sq, v.shape[-1]), dtype=torch.float32, device=q.device)
        k_blk, v_blk = k, v
        for j in range(n):
            if j:
                # the resident block first, then the n - 1 others as they arrive
                k_blk, v_blk = ring_shift(k_blk, axis), ring_shift(v_blk, axis)
            s = qs @ k_blk.float().transpose(-1, -2)              # [B, H, Sq, Sk] f32
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + p.to(v.dtype).float() @ v_blk.float()
            m = m_new
        out = (acc / l[..., None]).to(v.dtype)
        ctx.axis = axis
        ctx.save_for_backward(q, k_blk, v_blk, out, m + torch.log(l))
        return out

    @staticmethod
    def backward(ctx, g_out):
        q, k_blk, v_blk, out, lse = ctx.saved_tensors
        axis, n = ctx.axis, ctx.axis.world
        scale = q.shape[-1] ** -0.5
        qs = _scaled_q(q)
        g = g_out.float()
        delta = (g * out.float()).sum(dim=-1, keepdim=True)      # [B, H, Sq, 1]
        dq = torch.zeros_like(qs)
        dk = dv = None
        # the blocks in the reverse order of the forward's: the last block
        # the forward held first, each earlier one from the next rank
        for j in range(n):
            if j:
                k_blk, v_blk = (ring_shift(t, axis, reverse=True) for t in (k_blk, v_blk))
                dk, dv = (ring_shift(t, axis, reverse=True) for t in (dk, dv))
            kf, vf = k_blk.float(), v_blk.float()
            p = torch.exp(qs @ kf.transpose(-1, -2) - lse[..., None])
            dp = g @ vf.transpose(-1, -2)
            ds = p * (dp - delta)
            dq = dq + ds @ kf
            dk_j = ds.transpose(-1, -2) @ qs
            dv_j = p.transpose(-1, -2) @ g
            dk = dk_j if dk is None else dk + dk_j
            dv = dv_j if dv is None else dv + dv_j
        return ((dq * scale).to(q.dtype), dk.to(k_blk.dtype), dv.to(v_blk.dtype), None)


def ring_sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, axis) -> torch.Tensor:
    """Sequence-parallel SDPA over a seq axis (ring attention; counterpart
    of the JAX package's ``ring_sdpa``).

    ``q``, ``k``, ``v`` are this rank's [B, H, S/n, D] token blocks of a
    sequence split over ``axis`` (a ``parallel.sharding.Mesh``).  Returns
    the exact softmax(q·kᵀ)·v of the local queries against the whole
    sequence: the k/v blocks rotate one hop at a time round the axis
    (:func:`ring_shift`) and fold into float32 accumulators (running max,
    normalizer, weighted value sum).  It follows ``sdpa``'s dtype rules:
    bf16 operands with float32 logits and sums, float32 throughout for
    float32.  Differentiable.  On an axis of one rank it is ``sdpa``."""
    if axis.world == 1:
        return sdpa(q, k, v)
    return _RingSDPA.apply(q, k, v, axis)


def split_heads(x: torch.Tensor, n_heads: int) -> torch.Tensor:
    b, s, d = x.shape
    return x.reshape(b, s, n_heads, d // n_heads).transpose(1, 2)


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    b, h, s, hd = x.shape
    return x.transpose(1, 2).reshape(b, s, h * hd)


def timestep_embedding(timesteps: torch.Tensor, dim: int, max_period: float = 10000.0,
                       flip_sin_to_cos: bool = True,
                       downscale_freq_shift: float = 0.0) -> torch.Tensor:
    """Sinusoidal timestep embedding (diffusers get_timestep_embedding)."""
    half = dim // 2
    exponent = -math.log(max_period) * torch.arange(
        half, dtype=torch.float32, device=timesteps.device)
    freqs = torch.exp(exponent / (half - downscale_freq_shift))
    args = timesteps.float()[:, None] * freqs[None, :]
    sin, cos = torch.sin(args), torch.cos(args)
    return torch.cat([cos, sin] if flip_sin_to_cos else [sin, cos], dim=-1)
