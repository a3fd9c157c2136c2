"""The committed synthetic scene as the reference reads it: images resized
and normalized, poses in the ngp convention, each view paired with a
shuffled partner, rays of every pixel at the encoded resolution.

A frozen copy of the single-scene path of the port's ``data/{preprocess,
rays,dataset}.py`` (stable_nerf_tpu_torch, as of the benchmark's first
version): the same file gives the same arrays, worked out again here.
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F


def _ngp_pose(p, scale=0.33):
    return np.array([[p[1, 0], -p[1, 1], -p[1, 2], p[1, 3] * scale],
                     [p[2, 0], -p[2, 1], -p[2, 2], p[2, 3] * scale],
                     [p[0, 0], -p[0, 1], -p[0, 2], p[0, 3] * scale],
                     [0, 0, 0, 1]], dtype=np.float32)


def rays(poses: np.ndarray, intrinsic, H: int, W: int) -> Dict[str, np.ndarray]:
    """Rays of every pixel, pixel centres at +0.5, directions normalized
    before the rotation: {'rays_o', 'rays_d'} [B, H·W, 3]."""
    p = torch.from_numpy(poses).float()
    fx, fy, cx, cy = [float(v) for v in intrinsic]
    j, i = torch.meshgrid(torch.arange(H, dtype=torch.float32),
                          torch.arange(W, dtype=torch.float32), indexing="ij")
    i, j = i.reshape(1, -1) + 0.5, j.reshape(1, -1) + 0.5
    dirs = torch.stack([(i - cx) / fx, (j - cy) / fy, torch.ones_like(i)], dim=-1)
    dirs = dirs / torch.linalg.norm(dirs, dim=-1, keepdim=True)
    rays_d = torch.einsum("bnk,bjk->bnj", dirs.expand(p.shape[0], -1, -1), p[:, :3, :3])
    rays_o = p[:, None, :3, 3].expand(rays_d.shape)
    return {"rays_o": rays_o.numpy(), "rays_d": rays_d.numpy()}


def load_scene(path: str, shape: int, encoded: int, seed: int) -> Dict[str, np.ndarray]:
    """The scene at ``shape``² images and ``encoded``² rays: reference and
    target views (the target a shuffled copy), poses and the intrinsics."""
    data = np.load(path, allow_pickle=True)
    arr = (np.clip(np.asarray(data["images"]), 0, 1) * 255).astype(np.uint8)
    t = torch.from_numpy(np.ascontiguousarray(arr)).permute(0, 3, 1, 2)
    t = F.interpolate(t, size=(shape, shape), mode="bilinear", align_corners=False,
                      antialias=True)
    images = (t.numpy().astype(np.float32) / 255.0 - 0.5) / 0.5
    poses = np.stack([_ngp_pose(p) for p in data["poses"][:, :-1, :]])
    perm = np.random.default_rng(seed).permutation(images.shape[0])
    intrinsic = np.array([138.0, 138.0, encoded // 2, encoded // 2], np.float32)
    ref, tgt = rays(poses, intrinsic, encoded, encoded), rays(poses[perm], intrinsic,
                                                               encoded, encoded)
    return {"reference_image": images, "target_image": images[perm],
            "reference_pose": poses, "target_pose": poses[perm],
            "reference_rays_o": ref["rays_o"], "reference_rays_d": ref["rays_d"],
            "target_rays_o": tgt["rays_o"], "target_rays_d": tgt["rays_d"],
            "intrinsic": intrinsic}


def scene_path(root: str) -> str:
    return os.path.join(root, "datasets", "nerf", "synthetic_spheres.npz")
