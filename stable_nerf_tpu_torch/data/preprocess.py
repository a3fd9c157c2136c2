"""Host-side dataset loading and preprocessing (counterpart of
stable_nerf_tpu/data/preprocess.py; reference datasets/preprocess.py).

The reference's behaviour is kept, its quirks included: images resized,
then normalized with mean/std 0.5 to [-1, 1]; poses through the ngp axis
swap with translation scale 0.33; a normalized-intrinsics helper that the
dataset layer then ignores for a hard-coded focal.

The resize is PIL's ``BILINEAR`` computed by PyTorch: ``interpolate`` on
the uint8 image with ``antialias=True`` is PyTorch's PIL-compatible
fixed-point path, so no PIL is needed (the card's machine has none).
Objaverse PNGs are decoded by the native loader (``native_loader``) to
the uint8 RGB that PIL's ``convert("RGB")`` gives, then go through the
same resize.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from . import native_loader
from .rays import nerf_matrix_to_ngp


def construct_normalized_camera_intrinsics(image_shape, focal_length: float = 50.0,
                                           skew: float = 0.0) -> np.ndarray:
    """Normalized 3×3 intrinsics from a blender focal length in mm (sensor
    width 36 mm; reference preprocess.py:25-42)."""
    focal_px = focal_length * (image_shape[0] / 36.0)
    return np.array(
        [
            [focal_px / image_shape[0], skew, 0.5],
            [0.0, focal_px / image_shape[1], 0.5],
            [0.0, 0.0, 1.0],
        ],
        dtype=np.float32,
    )


def resize_bilinear_uint8(images: np.ndarray, shape: Tuple[int, int]) -> np.ndarray:
    """[N, h, w, 3] uint8 → [N, H, W, 3] uint8, PIL ``BILINEAR`` (with its
    antialiasing when shrinking), computed on the CPU."""
    t = torch.from_numpy(np.ascontiguousarray(images)).permute(0, 3, 1, 2)
    out = F.interpolate(t, size=tuple(shape), mode="bilinear", align_corners=False,
                        antialias=True)
    return out.permute(0, 2, 3, 1).contiguous().numpy()


def preprocess_images(images: np.ndarray, shape: Tuple[int, int] = (64, 64),
                      mean: Sequence[float] = (0.5, 0.5, 0.5),
                      std: Sequence[float] = (0.5, 0.5, 0.5)) -> np.ndarray:
    """Resize and normalize a stack of float images in [0, 1] (reference
    preprocess.py:45-67) → [N, 3, H, W] float32."""
    mean = np.asarray(mean, np.float32).reshape(3, 1, 1)
    std = np.asarray(std, np.float32).reshape(3, 1, 1)
    arr = (np.clip(np.asarray(images), 0, 1) * 255).astype(np.uint8)
    arr = resize_bilinear_uint8(arr, shape)
    chw = arr.astype(np.float32).transpose(0, 3, 1, 2) / 255.0
    return (chw - mean) / std


def load_nerf_data(shape=(64, 64), mean=(0.5, 0.5, 0.5), std=(0.5, 0.5, 0.5),
                   root: str = "datasets", filename: str = "tiny_nerf_data.npz",
                   expect_scene: Optional[str] = None):
    """tiny_nerf_data.npz-layout loader (reference preprocess.py:70-112) →
    (images [N, 3, H, W], poses [N, 4, 4] ngp convention, normalized 3×3
    intrinsics).

    Files written by the synthetic-scene generator carry a ``scene``
    marker: loading a marked file as tiny-NeRF data (``expect_scene``
    None) raises, as does a marker other than ``expect_scene``."""
    path = os.path.join(root, "nerf", filename)
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"{path} not found — download/generate {filename} into {root}/nerf/")
    data = np.load(path, allow_pickle=True)
    marker = str(data["scene"]) if "scene" in data.files else None
    if expect_scene is None and marker is not None:
        raise ValueError(
            f"{path} carries scene marker {marker!r} — it is a generated "
            f"synthetic scene, not tiny-NeRF data.  Load it with "
            f"dataset='synthetic' (or pass expect_scene={marker!r}).")
    if expect_scene is not None and marker != expect_scene:
        raise ValueError(
            f"{path}: expected scene marker {expect_scene!r}, found "
            f"{marker!r} — regenerate with scripts/make_synthetic_scene.py.")
    native_h, native_w = data["images"].shape[1:3]
    images = preprocess_images(data["images"], shape, mean, std)
    poses = data["poses"][:, :-1, :]            # drop the redundant last row
    poses = np.stack([nerf_matrix_to_ngp(p) for p in poses])
    # a pixel focal at the capture resolution, normalized by the native
    # size; the dataset's parity branch ignores it for a hard-coded 138
    focal = float(data["focal"])
    intrinsic = np.array(
        [[focal / native_w, 0.0, 0.5],
         [0.0, focal / native_h, 0.5],
         [0.0, 0.0, 1.0]], dtype=np.float32)
    return images, poses, intrinsic


def load_objaverse_data(shape=(64, 64), mean=(0.5, 0.5, 0.5), std=(0.5, 0.5, 0.5),
                        fix_choices: Optional[Tuple[int, int]] = (0, 1),
                        percent_objects: float = 0.001, root: str = "datasets",
                        seed: int = 0):
    """Objaverse ``views_release`` loader (reference preprocess.py:115-190):
    2 of an object's 12 views (``fix_choices``, or with None a draw from a
    generator seeded by (``seed``, the object's index in the sorted
    listing), so the draw does not depend on the threads' order), the
    sorted listing cut to its first ``percent_objects``, a thread pool
    over the objects, corrupt objects dropped silently (preprocess.py:158).

    An object directory holds ``NNN.png`` (8-bit RGB or RGBA) and
    ``NNN.npy`` (a 3×4 or 4×4 blender pose) for NNN in 000..011.  Objects
    keep the listing's order (the JAX package appends them as their loads
    complete).  An object drops when a file is missing or does not decode
    or its views differ in size; a native loader that does not build
    raises here, before any object is read.

    Returns (images [O, 2, 3, H, W], poses [O, 2, 4, 4], intrinsics 3×3)."""
    assert 0 < percent_objects <= 1, "percent_objects must be in (0, 1]"
    if fix_choices is not None:
        assert len(fix_choices) == 2
        assert all(0 <= c < 12 for c in fix_choices)
    dataset_path = os.path.join(root, "objaverse", "views_release")
    if not os.path.isdir(dataset_path):
        raise FileNotFoundError(
            f"{dataset_path} not found — fetch Objaverse views_release first")
    native_loader.load()

    def process(index, obj_dir):
        try:
            choices = (np.asarray(fix_choices) if fix_choices is not None
                       else np.random.default_rng([seed, index]).choice(12, 2, replace=False))
            imgs, poses = [], []
            for i in choices:
                with open(os.path.join(dataset_path, obj_dir, f"{i:03d}.png"), "rb") as f:
                    imgs.append(native_loader.decode_png_uint8(f.read()) / 255.0)
                pose = np.load(os.path.join(dataset_path, obj_dir, f"{i:03d}.npy"))
                poses.append(nerf_matrix_to_ngp(pose))
            return preprocess_images(np.asarray(imgs), shape, mean, std), np.asarray(poses)
        except (OSError, EOFError, ValueError, IndexError):
            return None, None                   # silent drop (preprocess.py:158)

    listing = sorted(os.listdir(dataset_path))
    listing = listing[: int(len(listing) * percent_objects)]
    with ThreadPoolExecutor() as pool:
        loaded = [r for r in pool.map(process, range(len(listing)), listing)
                  if r[0] is not None]
    if not loaded:
        raise RuntimeError("no loadable objaverse objects found")
    images = np.stack([imgs for imgs, _ in loaded])
    poses = np.stack([p for _, p in loaded]).astype(np.float32)
    return images, poses, construct_normalized_camera_intrinsics(shape)


def load_data(dataset: str = "objaverse", shape=(64, 64), mean=(0.5, 0.5, 0.5),
              std=(0.5, 0.5, 0.5), fix_choices=(0, 1), percent_objects: float = 0.1,
              root: str = "datasets", seed: int = 0):
    """Dispatch on the dataset's name (reference preprocess.py:193-214;
    "synthetic" is the committed scene with its marker; ``seed`` draws
    objaverse views when ``fix_choices`` is None)."""
    if dataset == "nerf":
        return load_nerf_data(shape, mean, std, root)
    if dataset == "synthetic":
        return load_nerf_data(shape, mean, std, root, filename="synthetic_spheres.npz",
                              expect_scene="synthetic_spheres")
    if dataset == "objaverse":
        return load_objaverse_data(shape, mean, std, fix_choices, percent_objects, root,
                                   seed)
    raise ValueError(f'dataset "{dataset}" not in ["nerf", "synthetic", "objaverse"]')
