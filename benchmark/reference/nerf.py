"""Plain float32 Instant-NGP NeRF: hash-grid and SH encodings, the bias-free
MLPs, the lattice march, compaction, compositing, the occupancy grid.

A frozen copy of the port's ``ops/{encoding,marching,compaction,composite,
ray_ops,activation}.py`` and ``models/nerf/{network,renderer,grid}.py``
(stable_nerf_tpu_torch, as of the benchmark's first version), with no
kernel: the table gradient comes from autograd through the gather (an
``index_add``), the composite's gradient from autograd through its
cumulative products, and every product is float32 (or the control's
precision, ``precision.py``).  Configurations are plain dicts, the
``nerf`` section of a configuration file.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional

import torch

from . import precision
from .sd import Spec

_PRIMES = (1, 2654435761, 805459861)
_MASK32 = 0xFFFFFFFF
_CORNERS = [(i, j, k) for i in (0, 1) for j in (0, 1) for k in (0, 1)]
SQRT3 = math.sqrt(3.0)
FLT_MAX = torch.finfo(torch.float32).max


# ------------------------------------------------------------------ encoding

def _geometry(h: Dict):
    log2s = math.log2(h["per_level_scale"])
    scales, res, dense = [], [], []
    for level in range(h["n_levels"]):
        s = h["base_resolution"] * (2.0 ** (level * log2s)) - 1.0
        r = int(math.ceil(s)) + 1
        scales.append(s)
        res.append(r)
        dense.append(r ** 3 <= (1 << h["log2_hashmap_size"]))
    return scales, res, dense


def _mul32(a, c):
    lo, hi = c & 0xFFFF, c >> 16
    return (a * lo + (((a * hi) & 0xFFFF) << 16)) & _MASK32


def _rows(cx, cy, cz, h, lv0):
    _, res, dense = _geometry(h)
    T = 1 << h["log2_hashmap_size"]
    Lp, dev = cx.shape[1], cx.device
    r = torch.tensor(res[lv0:lv0 + Lp], dtype=torch.int64, device=dev)[None, :, None]
    is_dense = torch.tensor(dense[lv0:lv0 + Lp], device=dev)[None, :, None]
    cx, cy, cz = cx & _MASK32, cy & _MASK32, cz & _MASK32
    dense_idx = (cx + cy * r + cz * r * r) & _MASK32
    hashed = _mul32(cx, _PRIMES[0]) ^ _mul32(cy, _PRIMES[1]) ^ _mul32(cz, _PRIMES[2])
    idx = torch.where(is_dense, dense_idx, hashed) % T
    return idx + (torch.arange(lv0, lv0 + Lp, dtype=torch.int64, device=dev) * T)[None, :, None]


def _cell(x, h, lv0, lv1):
    scales, _, _ = _geometry(h)
    scale = torch.tensor(scales[lv0:lv1], dtype=torch.float32, device=x.device)
    pos = x[:, None, :] * scale[None, :, None] + 0.5
    p0 = torch.floor(pos)
    return p0.long(), pos - p0


def _exact(x, h, lv0, lv1):
    p0, w = _cell(x, h, lv0, lv1)
    off = torch.tensor(_CORNERS, dtype=torch.int64, device=x.device)
    c = [p0[:, :, None, a] + off[None, None, :, a] for a in range(3)]
    rows = _rows(c[0], c[1], c[2], h, lv0)
    wx, wy, wz = w[..., 0:1], w[..., 1:2], w[..., 2:3]
    cw = torch.cat([(1 - wx) * (1 - wy) * (1 - wz), (1 - wx) * (1 - wy) * wz,
                    (1 - wx) * wy * (1 - wz), (1 - wx) * wy * wz,
                    wx * (1 - wy) * (1 - wz), wx * (1 - wy) * wz,
                    wx * wy * (1 - wz), wx * wy * wz], dim=2)
    return rows, cw


def _uniform3(x, L, lv0):
    bx = x.float().contiguous().view(torch.int32).long() & _MASK32
    hh = _mul32(bx[:, 0], _PRIMES[0]) ^ _mul32(bx[:, 1], _PRIMES[1]) ^ _mul32(bx[:, 2], _PRIMES[2])
    lvl = torch.tensor([(v * 0x9E3779B9) & _MASK32 for v in range(lv0, lv0 + L)],
                       dtype=torch.int64, device=x.device)
    hh = hh[:, None] ^ lvl[None]

    def mix(v, c):
        v = _mul32(v ^ (v >> 16), c)
        v = _mul32(v ^ (v >> 13), 0x5BD1E995)
        return v ^ (v >> 16)

    u = torch.stack([mix(hh, c) for c in (0x85EBCA6B, 0xC2B2AE35, 0x27D4EB2F)], dim=-1)
    return (u >> 8).float() * (1.0 / (1 << 24))


def _stochastic(x, h, lv0, lv1):
    p0, w = _cell(x, h, lv0, lv1)
    c = p0 + (_uniform3(x, lv1 - lv0, lv0) < w).long()
    rows = _rows(c[..., 0:1], c[..., 1:2], c[..., 2:3], h, lv0)
    return rows, torch.ones(rows.shape, dtype=torch.float32, device=x.device)


def hash_encode(table, x, h: Dict, stochastic: bool, min_level: int):
    """x [M, 3] in [0, 1] → [M, L·F]; exact, one corner a level, or the
    hybrid (exact below ``min_level``)."""
    L = h["n_levels"]
    if not stochastic or min_level >= L:
        sections = [_exact(x, h, 0, L)]
    elif min_level <= 0:
        sections = [_stochastic(x, h, 0, L)]
    else:
        sections = [_exact(x, h, 0, min_level), _stochastic(x, h, min_level, L)]
    t = precision.table(table)
    outs = [(t[rows] * cw[..., None]).sum(2).reshape(x.shape[0], -1) for rows, cw in sections]
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=-1)


def sh_encoding(d, degree=4):
    d = d * 2.0 - 1.0
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    xy, xz, yz, x2, y2, z2 = x * y, x * z, y * z, x * x, y * y, z * z
    out = [torch.full_like(x, 0.28209479177387814)]
    if degree >= 2:
        out += [-0.48860251190291987 * y, 0.48860251190291987 * z, -0.48860251190291987 * x]
    if degree >= 3:
        out += [1.0925484305920792 * xy, -1.0925484305920792 * yz,
                0.94617469575755997 * z2 - 0.31539156525251999,
                -1.0925484305920792 * xz, 0.54627421529603959 * (x2 - y2)]
    if degree >= 4:
        out += [0.59004358992664352 * y * (-3.0 * x2 + y2), 2.8906114426405538 * xy * z,
                0.45704579946446572 * y * (1.0 - 5.0 * z2),
                0.3731763325901154 * z * (5.0 * z2 - 3.0),
                0.45704579946446572 * x * (1.0 - 5.0 * z2), 1.4453057213202769 * z * (x2 - y2),
                0.59004358992664352 * x * (-x2 + 3.0 * y2)]
    return torch.stack(out, dim=-1)


class _TruncExp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.exp(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g * torch.exp(torch.clamp(x, -15.0, 15.0))


# ------------------------------------------------------------------ network

def nerf_template(n: Dict) -> Dict:
    h = n["encoding_sigma"]
    L, F, T = h["n_levels"], h["n_features_per_level"], 1 << h["log2_hashmap_size"]

    def mlp(di, do, width, hidden):
        dims = [di] + [width] * hidden + [do]
        return {"layers": [Spec((a, b), "uniform", (6.0 / a) ** 0.5)
                           for a, b in zip(dims[:-1], dims[1:])]}

    return {"hash": {"table": Spec((L * T, F), "uniform", 1e-4)},
            "sigma_mlp": mlp(L * F, 1 + n["geo_feat_dim"], n["network_sigma"]["n_neurons"],
                             n["network_sigma"]["n_hidden_layers"]),
            "color_mlp": mlp(n["encoding_dir"]["degree"] ** 2 + n["geo_feat_dim"],
                             n["channel_dim"], n["network_color"]["n_neurons"],
                             n["network_color"]["n_hidden_layers"])}


def _mlp(layers, x):
    h = x
    for i, w in enumerate(layers):
        h = precision.low(h) @ precision.low(w)
        if i < len(layers) - 1:
            h = torch.relu(h)
    return h


def density(params, x, n: Dict, stochastic=False):
    b = n["bound"]
    h = hash_encode(params["hash"]["table"], ((x + b) / (2 * b)).reshape(-1, 3).float(),
                    n["encoding_sigma"], stochastic, n["hash_stochastic_min_level"])
    h = _mlp(params["sigma_mlp"]["layers"], h)
    sigma = (_TruncExp.apply(h[..., 0]) if n["density_activation"] == "trunc_exp"
             else torch.relu(h[..., 0]))
    return sigma, h[..., 1:]


def nerf_apply(params, x, d, n: Dict, stochastic=False):
    sigma, geo = density(params, x, n, stochastic)
    sh = sh_encoding((d + 1.0) / 2.0, n["encoding_dir"]["degree"])
    rgb = torch.sigmoid(_mlp(params["color_mlp"]["layers"], torch.cat([sh, geo], dim=-1)))
    return sigma, rgb


# ------------------------------------------------------------ march, composite

def near_far(o, d, bound, min_near):
    aabb = torch.tensor([-bound] * 3 + [bound] * 3, dtype=torch.float32, device=o.device)
    rdir = 1.0 / d
    lo, hi = (aabb[:3] - o) * rdir, (aabb[3:] - o) * rdir
    near = torch.minimum(lo, hi).amax(dim=-1)
    far = torch.maximum(lo, hi).amin(dim=-1)
    miss = near > far
    near = torch.clamp(near, min=min_near)
    return torch.where(miss, FLT_MAX, near), torch.where(miss, FLT_MAX, far)


def _mip(v, cascade):
    _, e = torch.frexp(v)
    return torch.clamp(e, 0, cascade - 1).to(torch.int32)


def march(o, d, nears, fars, occ, n: Dict, max_steps, noise):
    b, H, cas = n["bound"], n["grid_size"], cascade(n)
    dev = o.device
    dt = torch.tensor(2.0 * SQRT3 / max_steps, dtype=torch.float32, device=dev)
    t0 = nears if noise is None else nears + dt * noise
    ts = t0[:, None] + torch.arange(max_steps, dtype=torch.float32, device=dev)[None] * dt
    pos = torch.clamp(o[:, None, :] + ts[..., None] * d[:, None, :], -b, b)
    level = torch.maximum(_mip(pos.abs().amax(dim=-1), cas), _mip(dt * H * 0.5, cas))
    mip_bound = torch.clamp(torch.exp2(level.float()), max=b)
    c = torch.clamp((0.5 * (pos / mip_bound[..., None] + 1.0) * H).to(torch.int32), 0, H - 1).long()
    idx = ((level.long() * H + c[..., 0]) * H + c[..., 1]) * H + c[..., 2]
    valid = (ts < fars[:, None]) & occ.reshape(-1)[idx]
    return pos, ts, dt, valid, t0


def composite(sigmas, rgbs, dt, ts, t0, valid, t_thresh=1e-4):
    alpha = valid.float() * (1.0 - torch.exp(-sigmas * dt))
    T_after = torch.cumprod(1.0 - alpha, dim=-1)
    T_before = torch.cat([torch.ones_like(T_after[:, :1]), T_after[:, :-1]], -1)
    ok = (T_after >= t_thresh).float().detach()
    include = torch.cat([torch.ones_like(ok[:, :1]), torch.cumprod(ok[:, :-1], dim=-1)], -1)
    w = alpha * T_before * include
    return w.sum(-1), torch.einsum("nk,nkc->nc", w, rgbs)


class Plan(NamedTuple):
    src: torch.Tensor
    used: torch.Tensor
    new_valid: torch.Tensor


def compact_plan(valid, budget):
    """Step-major packing of the valid samples into ``budget`` slots; the
    far tail of the longest rays is dropped over the budget."""
    N, K = valid.shape
    NK, dev = N * K, valid.device
    flat = valid.reshape(-1)
    cnt = torch.cumsum(valid.T.reshape(-1).long(), dim=0)
    rank = (cnt - 1).reshape(K, N).T.reshape(-1)
    dest = torch.where(flat, rank.clamp(max=budget), budget)
    src = torch.full((budget + 1,), NK, dtype=torch.int64, device=dev)
    src.scatter_(0, dest, torch.arange(NK, dtype=torch.int64, device=dev))
    used = torch.arange(budget, device=dev) < cnt[-1].clamp(max=budget)
    return Plan(src[:budget], used, (flat & (rank < budget)).reshape(N, K))


def cascade(n: Dict) -> int:
    return 1 + math.ceil(math.log2(max(n["bound"], 1.0)))


def render(params, occ, rays_o, rays_d, n: Dict, *, bg, max_steps, perturb=None,
           sample_budget: Optional[int] = None, chunk: int = 2 ** 17):
    """Rays [..., 3] → image [..., C]; ``perturb`` jitters t0 (training, and
    the stochastic encode when the configuration asks for it)."""
    stochastic = bool(n["hash_stochastic"]) and perturb is not None
    prefix = rays_o.shape[:-1]
    o, d = rays_o.reshape(-1, 3).float(), rays_d.reshape(-1, 3).float()
    N = o.shape[0]
    nears, fars = near_far(o, d, n["bound"], n["min_near"])
    pos, ts, dt, valid, t0 = march(o, d, nears, fars, occ, n, max_steps, perturb)
    K = ts.shape[1]
    M = N * K

    def evaluate(p, dd):
        outs = [nerf_apply(params, a, b, n, stochastic)
                for a, b in zip(p.split(chunk), dd.split(chunk))]
        return torch.cat([s for s, _ in outs]), torch.cat([c for _, c in outs])

    if sample_budget is not None and sample_budget < M:
        plan = compact_plan(valid, sample_budget)
        safe = plan.src.clamp(max=M - 1)
        used = plan.used.float()[:, None]
        pos_c = pos.reshape(M, 3)[safe] * used
        dirs_c = d[torch.div(plan.src, K, rounding_mode="floor").clamp(max=N - 1)] * used
        s_c, c_c = evaluate(pos_c, dirs_c)
        idx = torch.where(plan.used, plan.src, M)
        sig = torch.zeros(M + 1, device=o.device).index_copy(0, idx, s_c)[:M]
        rgb = torch.zeros(M + 1, c_c.shape[-1], device=o.device).index_copy(0, idx, c_c)[:M]
        valid = plan.new_valid
    else:
        sig, rgb = evaluate(pos.reshape(M, 3), d[:, None, :].expand(N, K, 3).reshape(M, 3))
    ws, image = composite(sig.reshape(N, K) * n["density_scale"],
                          rgb.reshape(N, K, n["channel_dim"]), dt, ts, t0, valid)
    image = image + (1.0 - ws)[:, None] * torch.as_tensor(bg, dtype=torch.float32,
                                                          device=o.device)
    return image.reshape(*prefix, n["channel_dim"])


# ----------------------------------------------------------- occupancy grid

class Grid(NamedTuple):
    density: torch.Tensor     # [CAS, H³], -1 on untrainable cells
    occ: torch.Tensor         # [CAS, H, H, H] bool
    iters: int


def _coords(H, dev):
    r = torch.arange(H, device=dev)
    x, y, z = torch.meshgrid(r, r, r, indexing="ij")
    return torch.stack([x.reshape(-1), y.reshape(-1), z.reshape(-1)], dim=-1)


def grid_marked(n: Dict, poses, intrinsic, dev) -> Grid:
    """A fresh grid with the cells that no camera sees marked −1."""
    H, C = n["grid_size"], cascade(n)
    fx, fy, cx, cy = [float(v) for v in intrinsic]
    world = 2.0 * _coords(H, dev).float() / (H - 1) - 1.0
    dens = torch.zeros((C, H ** 3), device=dev)
    for cas in range(C):
        bound = min(2 ** cas, n["bound"])
        hgs = bound / H
        cw = world * (bound - hgs)
        seen = torch.zeros(H ** 3, dtype=torch.bool, device=dev)
        for pose in torch.as_tensor(poses, dtype=torch.float32, device=dev):
            cam = (cw - pose[:3, 3][None]) @ pose[:3, :3]
            seen |= ((cam[:, 2] > 0) & (cam[:, 0].abs() < cx / fx * cam[:, 2] + hgs * 2)
                     & (cam[:, 1].abs() < cy / fy * cam[:, 2] + hgs * 2))
        dens[cas] = torch.where(seen, 0.0, -1.0)
    return Grid(dens, torch.zeros((C, H, H, H), dtype=torch.bool, device=dev), 0)


@torch.no_grad()
def grid_refresh(g: Grid, params, n: Dict, draws: Dict, decay=0.95, chunk=2 ** 16) -> Grid:
    """The occupancy refresh with its random numbers given: ``noise`` [H³, 3]
    a cascade in a full sweep (the first 16), else ``noise`` [H³/2, 3],
    ``rand_idx`` and ``u`` [H³/4] a cascade (the partial sweep)."""
    H, C = n["grid_size"], cascade(n)
    H3, dev = H ** 3, g.density.device
    coords = _coords(H, dev)

    def sweep(cas, idx):
        bound = min(2 ** cas, n["bound"])
        hgs = bound / H
        c = coords if idx is None else coords[idx]
        xyz = (2.0 * c.float() / (H - 1) - 1.0) * (bound - hgs) + draws["noise"][cas] * hgs
        return torch.cat([density(params, x, n)[0] * n["density_scale"]
                          for x in xyz.split(chunk)])

    tmp = torch.full((C, H3), -1.0, device=dev)
    for cas in range(C):
        if g.iters < 16:
            tmp[cas] = sweep(cas, None)
        else:
            cnt = torch.cumsum((g.density[cas] > 0).long(), 0)
            r = torch.floor(draws["u"][cas].float() * cnt[-1].float()).long()
            occ_idx = torch.searchsorted(cnt, r, right=True).clamp(max=H3 - 1)
            if int(cnt[-1]) == 0:
                occ_idx = draws["fallback_idx"][cas].long()
            idx = torch.cat([draws["rand_idx"][cas].long(), occ_idx])
            tmp[cas, idx] = sweep(cas, idx)
    valid = (g.density >= 0) & (tmp >= 0)
    dens = torch.where(valid, torch.maximum(g.density * decay, tmp), g.density)
    thresh = torch.clamp(dens.clamp(min=0).mean(), max=n["density_thresh"])
    return Grid(dens, (dens > thresh).reshape(C, H, H, H), g.iters + 1)
