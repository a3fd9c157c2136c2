#!/usr/bin/env python
"""The deterministic three-sphere scene through the port's ray code
(counterpart of scripts/make_synthetic_scene.py).

An analytically ray-traced scene of three Lambertian spheres on a white
background, written in tiny_nerf_data.npz's layout (images [N, H, W, 3]
float32 in [0, 1], poses [N, 4, 4] in the Blender convention, focal), so
the dataset loaders and the fit harness read it unchanged.  Every pixel is
an exact ray-sphere intersection along the rays the training pipeline
generates: ``data/rays.py::nerf_matrix_to_ngp`` then ``get_rays`` with the
dataset's fixed intrinsic [138, 138, W/2, H/2] (reference dataset.py:48),
so a perfect fit would reach infinite PSNR.  ``SPHERES`` is the one copy
of the scene's geometry in the port.

The default ``--out`` lies under ``output_synthetic_scene/``, never over
the committed ``datasets/nerf/synthetic_spheres.npz`` (the JAX script's
output, which the tests compare this script's with).

Usage: python scripts/make_torch_synthetic_scene.py
       [--out output_synthetic_scene/synthetic_spheres.npz] [--n-views 64] [--size 128]
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)

# spheres in ngp space (inside the [-1, 1]³ box after the 0.33 pose scale):
# (center xyz, radius, base rgb)
SPHERES = [
    (np.array([0.00, 0.00, 0.00]), 0.16, np.array([0.85, 0.25, 0.20])),
    (np.array([0.18, 0.10, 0.12]), 0.09, np.array([0.20, 0.65, 0.90])),
    (np.array([-0.16, -0.06, 0.14]), 0.075, np.array([0.95, 0.85, 0.25])),
]
LIGHT = np.array([0.40824829, 0.81649658, 0.40824829])   # normalized (1, 2, 1)
DEFAULT_OUT = os.path.join("output_synthetic_scene", "synthetic_spheres.npz")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--n-views", type=int, default=64)
    ap.add_argument("--size", type=int, default=128)
    return ap


def blender_orbit_poses(n: int, radius: float = 4.0) -> np.ndarray:
    """An orbit of ``n`` Blender-convention c2w poses (the camera looks
    along −z; the z column points backward) at a wobbling elevation."""
    poses = np.zeros((n, 4, 4), np.float32)
    for i in range(n):
        theta = 2.0 * np.pi * i / n
        phi = 0.35 + 0.25 * np.sin(4.0 * np.pi * i / n)
        c = radius * np.array([np.cos(phi) * np.sin(theta), np.sin(phi),
                               np.cos(phi) * np.cos(theta)], np.float32)
        back = c / np.linalg.norm(c)
        up = np.array([0.0, 1.0, 0.0], np.float32)
        x = np.cross(up, back)
        x /= np.linalg.norm(x)
        y = np.cross(back, x)
        poses[i] = np.eye(4, dtype=np.float32)
        poses[i, :3, 0] = x
        poses[i, :3, 1] = y
        poses[i, :3, 2] = back
        poses[i, :3, 3] = c
    return poses


def trace(rays_o: np.ndarray, rays_d: np.ndarray) -> np.ndarray:
    """Nearest-hit Lambertian shading of SPHERES on a white background
    (tiny_nerf_data's lego is on white; rendered with the reference's
    bg_color 0, the white background makes the ReLU-density fit
    well-posed)."""
    n = rays_o.shape[0]
    color = np.ones((n, 3), np.float32)
    best_t = np.full((n,), np.inf, np.float32)
    for center, radius, base in SPHERES:
        oc = rays_o - center
        b = np.sum(oc * rays_d, axis=-1)
        cterm = np.sum(oc * oc, axis=-1) - radius * radius
        disc = b * b - cterm
        hit = disc > 0
        t = -b - np.sqrt(np.maximum(disc, 0.0))
        hit &= (t > 1e-4) & (t < best_t)
        p = rays_o + t[:, None] * rays_d
        normal = (p - center) / radius
        lam = np.clip(np.sum(normal * LIGHT, axis=-1), 0.0, 1.0)
        shade = (0.35 + 0.65 * lam)[:, None] * base[None, :]
        color = np.where(hit[:, None], shade.astype(np.float32), color)
        best_t = np.where(hit, t, best_t)
    return color


def render_scene(n_views: int, size: int):
    """(images [n, size, size, 3] float32, Blender poses [n, 4, 4])."""
    import torch

    from stable_nerf_tpu_torch.data.rays import get_rays, nerf_matrix_to_ngp

    intrinsic = (138.0, 138.0, size / 2, size / 2)      # dataset.py:48
    poses = blender_orbit_poses(n_views)
    ngp = np.stack([np.asarray(nerf_matrix_to_ngp(p[:3])) for p in poses])
    rays = get_rays(torch.from_numpy(ngp).float(), intrinsic, size, size)
    rays_o = rays["rays_o"].double().numpy()
    rays_d = rays["rays_d"].double().numpy()
    images = np.stack([trace(rays_o[i], rays_d[i]).reshape(size, size, 3)
                       for i in range(n_views)]).astype(np.float32)
    return images, poses


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    images, poses = render_scene(args.n_views, args.size)
    if os.path.dirname(args.out):
        os.makedirs(os.path.dirname(args.out), exist_ok=True)
    # the scene marker tells the loaders this is not tiny-NeRF data
    np.savez(args.out, images=images, poses=poses, focal=np.float32(138.0),
             scene="synthetic_spheres")
    occ = float((images.sum(-1) < 2.999).mean())
    print(f"wrote {args.out}: {args.n_views} views at {args.size}x{args.size}, "
          f"{occ:.1%} foreground coverage")
    return 0


if __name__ == "__main__":
    sys.exit(main())
