"""Input encodings: multiresolution hash grid and spherical harmonics
(counterpart of stable_nerf_tpu/ops/encoding.py).

The hash grid keeps one [L·T, F] table.  Its uint32 arithmetic (the tcnn
spatial hash and the murmur-style mix of the stochastic corner draw) is
emulated in int64 and masked to 32 bits after every multiply, so row
indices match the reference bit for bit.  The custom backward recomputes
indices and weights from the saved positions and sends the table gradient
to the scatter kernel (ops/hopper/scatter.py), one slab per level section.
Spans (``utils/profiling.py``): ``nerf.hash_encode`` over the encode and
``nerf.hash_encode_backward`` over the custom backward.
"""

from __future__ import annotations

import math

import torch

from ..config import HashGridConfig
from ..utils.profiling import span
from .hopper.scatter import hash_scatter_add_per_level

# tcnn spatial hash primes (grid.h)
_PRIMES = (1, 2654435761, 805459861)
_MASK32 = 0xFFFFFFFF

# 8 corner offsets in the reference's order: corner c = 4i + 2j + k
_CORNERS = [(i, j, k) for i in (0, 1) for j in (0, 1) for k in (0, 1)]


def _level_geometry(cfg: HashGridConfig):
    """Per-level (scale, resolution, dense?) following tcnn grid.h:
    scale_l = base·2^(l·log2 s) − 1; res_l = ceil(scale_l) + 1; dense
    indexing iff res_l³ <= table_size."""
    log2s = math.log2(cfg.per_level_scale)
    scales, resolutions, dense = [], [], []
    for level in range(cfg.n_levels):
        scale = cfg.base_resolution * (2.0 ** (level * log2s)) - 1.0
        res = int(math.ceil(scale)) + 1
        scales.append(scale)
        resolutions.append(res)
        dense.append(res ** 3 <= cfg.table_size)
    return scales, resolutions, dense


def hash_grid_init(generator: torch.Generator, cfg: HashGridConfig,
                   device: torch.device) -> dict:
    """Uniform(-1e-4, 1e-4) table, tcnn's default grid init."""
    shape = (cfg.n_levels * cfg.table_size, cfg.n_features_per_level)
    table = torch.empty(shape, dtype=torch.float32, device=device)
    return {"table": table.uniform_(-1e-4, 1e-4, generator=generator)}


def _mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """(a·c) mod 2^32 for int64 ``a`` in [0, 2^32) and a constant c < 2^32,
    split in 16-bit halves so no int64 product overflows."""
    lo, hi = c & 0xFFFF, c >> 16
    return (a * lo + (((a * hi) & 0xFFFF) << 16)) & _MASK32


def _cell_coords(x: torch.Tensor, cfg: HashGridConfig, lv0: int, lv1: int):
    """[M, 3] in [0, 1] → (p0 [M, L', 3] int64, w [M, L', 3] f32) for
    levels [lv0, lv1): pos = x·scale + 0.5 (tcnn pos_fract)."""
    scales, _, _ = _level_geometry(cfg)
    scale = torch.tensor(scales[lv0:lv1], dtype=torch.float32, device=x.device)
    pos = x[:, None, :] * scale[None, :, None] + 0.5
    p0 = torch.floor(pos)
    return p0.long(), pos - p0


def _flat_index(cx, cy, cz, cfg: HashGridConfig, lv0: int) -> torch.Tensor:
    """Corner coords, each [M, L', C] int64 → flat table rows [M, L', C]
    int64: dense strides where the level fits the table, else the tcnn
    hash, modulo T, plus the level offset."""
    _, resolutions, dense = _level_geometry(cfg)
    T = cfg.table_size
    Lp = cx.shape[1]
    dev = cx.device
    r = torch.tensor(resolutions[lv0:lv0 + Lp], dtype=torch.int64,
                     device=dev)[None, :, None]
    is_dense = torch.tensor(dense[lv0:lv0 + Lp], device=dev)[None, :, None]
    cx, cy, cz = cx & _MASK32, cy & _MASK32, cz & _MASK32
    dense_idx = (cx + cy * r + cz * r * r) & _MASK32
    hashed = (_mul32(cx, _PRIMES[0]) ^ _mul32(cy, _PRIMES[1])
              ^ _mul32(cz, _PRIMES[2]))
    idx = torch.where(is_dense, dense_idx, hashed) % T
    level_off = torch.arange(lv0, lv0 + Lp, dtype=torch.int64, device=dev) * T
    return idx + level_off[None, :, None]


def _indices_weights_exact(x, cfg: HashGridConfig, lv0: int, lv1: int):
    """8-corner trilinear: (rows [M, L', 8] int64, cw [M, L', 8] f32)."""
    p0, w = _cell_coords(x, cfg, lv0, lv1)
    off = torch.tensor(_CORNERS, dtype=torch.int64, device=x.device)      # [8, 3]
    c = [p0[:, :, None, a] + off[None, None, :, a] for a in range(3)]
    rows = _flat_index(c[0], c[1], c[2], cfg, lv0)
    wx, wy, wz = w[..., 0:1], w[..., 1:2], w[..., 2:3]
    cw = torch.cat([
        (1 - wx) * (1 - wy) * (1 - wz),
        (1 - wx) * (1 - wy) * wz,
        (1 - wx) * wy * (1 - wz),
        (1 - wx) * wy * wz,
        wx * (1 - wy) * (1 - wz),
        wx * (1 - wy) * wz,
        wx * wy * (1 - wz),
        wx * wy * wz,
    ], dim=2)
    return rows, cw


def _stateless_uniform3(x: torch.Tensor, L: int, lv0: int) -> torch.Tensor:
    """Position-seeded uniforms [M, L, 3] in [0, 1): murmur-style mixing of
    the position's float bits, decorrelated per absolute level and axis
    (reference encoding.py:130-153), in int64 masked to 32 bits."""
    bx = x.float().contiguous().view(torch.int32).long() & _MASK32      # [M, 3]
    h = (_mul32(bx[:, 0], _PRIMES[0]) ^ _mul32(bx[:, 1], _PRIMES[1])
         ^ _mul32(bx[:, 2], _PRIMES[2]))
    lvl = torch.tensor([(v * 0x9E3779B9) & _MASK32 for v in range(lv0, lv0 + L)],
                       dtype=torch.int64, device=x.device)
    hh = h[:, None] ^ lvl[None]                                           # [M, L]

    def mix(v, c):
        v = _mul32(v ^ (v >> 16), c)
        v = _mul32(v ^ (v >> 13), 0x5BD1E995)
        return v ^ (v >> 16)

    u = torch.stack([mix(hh, c) for c in (0x85EBCA6B, 0xC2B2AE35, 0x27D4EB2F)],
                    dim=-1)
    return (u >> 8).float() * (1.0 / (1 << 24))


def _indices_weights_stochastic(x, cfg: HashGridConfig, lv0: int, lv1: int):
    """One corner per (sample, level), drawn ∝ its trilinear weight (each
    axis bit is 1 with probability frac): (rows [M, L', 1], ones)."""
    p0, w = _cell_coords(x, cfg, lv0, lv1)
    bits = (_stateless_uniform3(x, lv1 - lv0, lv0) < w).long()
    c = p0 + bits
    rows = _flat_index(c[..., 0:1], c[..., 1:2], c[..., 2:3], cfg, lv0)
    return rows, torch.ones(rows.shape, dtype=torch.float32, device=x.device)


def _hash_sections(x, cfg: HashGridConfig, stochastic: bool, min_level: int):
    """The encode as level sections [(lv0, rows [M, L', C], cw [M, L', C])].
    Exact or fully stochastic is one section; the hybrid (stochastic with
    0 < min_level < L) is exact on [0, min_level) and one corner on the
    rest."""
    L = cfg.n_levels
    if not stochastic or min_level >= L:
        return [(0, *_indices_weights_exact(x, cfg, 0, L))]
    if min_level <= 0:
        return [(0, *_indices_weights_stochastic(x, cfg, 0, L))]
    return [(0, *_indices_weights_exact(x, cfg, 0, min_level)),
            (min_level, *_indices_weights_stochastic(x, cfg, min_level, L))]


def _encode_sections(table: torch.Tensor, sections) -> torch.Tensor:
    """Weighted corner gather → [M, L·F]."""
    outs = []
    for _, rows, cw in sections:
        M, Lp, _ = rows.shape
        feats = table[rows]                                    # [M, L', C, F]
        outs.append((feats * cw[..., None]).sum(2).reshape(M, -1))
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=-1)


class _HashEncode(torch.autograd.Function):
    """Saves only ``x``; the backward recomputes rows and weights and
    scatters each section's table gradient through the kernel wrapper.
    Positions get a zero gradient (reference encoding.py:253-276)."""

    @staticmethod
    def forward(ctx, table, x, cfg, stochastic, grad_bf16, min_level):
        ctx.save_for_backward(x)
        ctx.args = (cfg, stochastic, grad_bf16, min_level)
        return _encode_sections(table, _hash_sections(x, cfg, stochastic,
                                                      min_level))

    @staticmethod
    def backward(ctx, g):
        with span("nerf.hash_encode_backward"):
            (x,) = ctx.saved_tensors
            cfg, stochastic, grad_bf16, min_level = ctx.args
            M = x.shape[0]
            F = cfg.n_features_per_level
            T = cfg.table_size
            g = g.float().reshape(M, cfg.n_levels, 1, F)
            slabs = []
            for lv0, rows, cw in _hash_sections(x, cfg, stochastic, min_level):
                Lp = rows.shape[1]
                upd = (cw[..., None] * g[:, lv0:lv0 + Lp]).contiguous()
                local = (rows - lv0 * T).to(torch.int32)
                slabs.append(hash_scatter_add_per_level(local, upd, Lp, T,
                                                        payload_bf16=grad_bf16))
            table_grad = slabs[0] if len(slabs) == 1 else torch.cat(slabs)
            x_grad = torch.zeros_like(x) if ctx.needs_input_grad[1] else None
        return table_grad, x_grad, None, None, None, None


def hash_grid_encode(params: dict, x: torch.Tensor, cfg: HashGridConfig,
                     custom_bwd: bool = False, stochastic: bool = False,
                     grad_bf16: bool = False,
                     stochastic_min_level: int = 0) -> torch.Tensor:
    """Encode positions [..., 3] in [0, 1] → [..., n_levels·F] features.

    custom_bwd: table gradient through the scatter kernel (positions then
      get a zero gradient); else autograd through the gather.
    stochastic: one corner per level instead of trilinear interpolation.
    grad_bf16: (custom_bwd only) round table-gradient updates to bf16.
    stochastic_min_level: hybrid mode, exact below this level.
    """
    batch_shape = x.shape[:-1]
    xf = x.reshape(-1, 3).float()
    table = params["table"]
    with span("nerf.hash_encode"):
        if custom_bwd:
            out = _HashEncode.apply(table, xf, cfg, stochastic, grad_bf16,
                                    stochastic_min_level)
        else:
            out = _encode_sections(table, _hash_sections(xf, cfg, stochastic,
                                                         stochastic_min_level))
    return out.reshape(*batch_shape, cfg.output_dim)


def sh_encoding(d: torch.Tensor, degree: int = 4) -> torch.Tensor:
    """Real SH basis up to ``degree`` bands (tcnn SphericalHarmonics);
    ``d`` [..., 3] in [0, 1] → [..., degree²]."""
    if degree < 1 or degree > 4:
        raise ValueError("sh_encoding supports 1..4 bands")
    d = d * 2.0 - 1.0
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    xy, xz, yz = x * y, x * z, y * z
    x2, y2, z2 = x * x, y * y, z * z
    out = [torch.full_like(x, 0.28209479177387814)]
    if degree >= 2:
        out += [-0.48860251190291987 * y, 0.48860251190291987 * z,
                -0.48860251190291987 * x]
    if degree >= 3:
        out += [1.0925484305920792 * xy, -1.0925484305920792 * yz,
                0.94617469575755997 * z2 - 0.31539156525251999,
                -1.0925484305920792 * xz, 0.54627421529603959 * (x2 - y2)]
    if degree >= 4:
        out += [0.59004358992664352 * y * (-3.0 * x2 + y2),
                2.8906114426405538 * xy * z,
                0.45704579946446572 * y * (1.0 - 5.0 * z2),
                0.3731763325901154 * z * (5.0 * z2 - 3.0),
                0.45704579946446572 * x * (1.0 - 5.0 * z2),
                1.4453057213202769 * z * (x2 - y2),
                0.59004358992664352 * x * (-x2 + 3.0 * y2)]
    return torch.stack(out, dim=-1)



def freq_encoding(x: torch.Tensor, n_freqs: int, include_input: bool = True) -> torch.Tensor:
    """γ(p) = (p?, sin(2⁰p), cos(2⁰p), …, sin(2^{L−1}p), cos(2^{L−1}p)) of
    the tiny NeRF → [..., D·(2L + include_input)], sin then cos per octave,
    as the original NeRF lays it out."""
    freqs = 2.0 ** torch.arange(n_freqs, dtype=x.dtype, device=x.device)     # [L]
    xb = x[..., None, :] * freqs[:, None]                                    # [..., L, D]
    enc = torch.cat([torch.sin(xb), torch.cos(xb)], dim=-1).reshape(*x.shape[:-1], -1)
    return torch.cat([x, enc], dim=-1) if include_input else enc
