"""Host-side dataset loading and preprocessing (counterpart of
stable_nerf_tpu/data/preprocess.py; reference datasets/preprocess.py).

The reference's behaviour is kept, its quirks included: images resized,
then normalized with mean/std 0.5 to [-1, 1]; poses through the ngp axis
swap with translation scale 0.33; a normalized-intrinsics helper that the
dataset layer then ignores for a hard-coded focal.

The resize is PIL's ``BILINEAR`` computed by PyTorch: ``interpolate`` on
the uint8 image with ``antialias=True`` is PyTorch's PIL-compatible
fixed-point path, so no PIL is needed (the card's machine has none).
The Objaverse loader decodes PNGs and is not ported yet.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

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


def load_data(dataset: str = "objaverse", shape=(64, 64), mean=(0.5, 0.5, 0.5),
              std=(0.5, 0.5, 0.5), fix_choices=(0, 1), percent_objects: float = 0.1,
              root: str = "datasets"):
    """Dispatch on the dataset's name (reference preprocess.py:193-214;
    "synthetic" is the committed scene with its marker)."""
    if dataset == "nerf":
        return load_nerf_data(shape, mean, std, root)
    if dataset == "synthetic":
        return load_nerf_data(shape, mean, std, root, filename="synthetic_spheres.npz",
                              expect_scene="synthetic_spheres")
    if dataset == "objaverse":
        raise NotImplementedError(
            "the objaverse loader (PNG decode) is not ported yet: ROADMAP.md §1 "
            "queue, the rest of the data")
    raise ValueError(f'dataset "{dataset}" not in ["nerf", "synthetic", "objaverse"]')
