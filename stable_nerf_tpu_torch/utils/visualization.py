"""Debug dumps and image files (counterpart of
stable_nerf_tpu/utils/visualization.py; reference
utils/visualization_utils.py:6-34)."""

from __future__ import annotations

import os
import random
from typing import Optional

import numpy as np
import torch


def _to_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach()
        return (x.float() if x.is_floating_point() else x).cpu().numpy()
    return np.asarray(x)


def sample_save_for_vis(prefix: str, tensor, sample_prob: float = 0.0125,
                        directory: str = "visualizations",
                        rng: Optional[random.Random] = None,
                        max_files: int = 64) -> Optional[str]:
    """With probability ``sample_prob``, save ``tensor`` as
    ``<directory>/<prefix>_<k>.npy`` (k counts up); returns the path, or
    None.  At most ``max_files`` files a (directory, prefix); the draw is
    made before that cap is checked, so the cap never shifts later draws.
    Floating tensors are saved in float32."""
    r = (rng or random).random()
    if r >= sample_prob:
        return None
    os.makedirs(directory, exist_ok=True)
    k = 0
    while os.path.exists(os.path.join(directory, f"{prefix}_{k}.npy")):
        k += 1
    if max_files is not None and k >= max_files:
        return None
    path = os.path.join(directory, f"{prefix}_{k}.npy")
    np.save(path, _to_numpy(tensor))
    return path


def save_image(path: str, img, *, chw: bool = False):
    """Save an image in [0, 1] as PNG; where PIL is absent, as
    ``<path>.npy`` of the uint8 array, as the JAX package does."""
    arr = _to_numpy(img)
    if chw:
        arr = arr.transpose(1, 2, 0)
    arr = (np.clip(arr, 0.0, 1.0) * 255).astype(np.uint8)
    if arr.shape[-1] == 1:
        arr = arr[..., 0]
    try:
        from PIL import Image
    except ImportError:
        np.save(path + ".npy", arr)
        return
    Image.fromarray(arr).save(path)
