"""Paired reference/target dataset of the joint training loop (counterpart
of stable_nerf_tpu/data/dataset.py; reference datasets/dataset.py).

Numpy arrays in host memory, with the reference's quirks kept as its
behaviour:

  * the single-scene branch pairs each image with a shuffled partner and
    hard-codes the intrinsics [138, 138, encW//2, encH//2] (dataset.py:40-48);
  * the objaverse branch takes views 0/1 as reference/target and computes
    the focal as ``W / (2·tan(47.1 / 2))``, degrees fed to tan as radians
    (dataset.py:56-58);
  * rays of every sample are computed once, at the encoded (latent)
    resolution (dataset.py:62-73), by the port's ``get_rays`` on the CPU.

Batches are plain numpy dicts from :func:`iterate`; the copy to the card
is data/prefetch.py's.
"""

from __future__ import annotations

import math
import warnings
from typing import Dict, Iterator, Optional, Sequence, Tuple

import numpy as np
import torch

from .preprocess import load_data
from .rays import get_rays

SAMPLE_KEYS = (
    "target_image", "reference_image", "target_pose", "reference_pose",
    "target_rays_o", "target_rays_d", "target_rays_inds",
    "reference_rays_o", "reference_rays_d", "reference_rays_inds",
)


def _rays(poses: np.ndarray, intrinsic: np.ndarray, H: int, W: int) -> Dict[str, np.ndarray]:
    return {k: v.numpy() for k, v in get_rays(torch.from_numpy(poses), intrinsic,
                                              H, W).items()}


class StableNeRFDataset:
    """Paired (reference, target) images, poses and rays in host memory."""

    def __init__(self, dataset_name: str = "objaverse", shape=(512, 512),
                 encoded_shape=(128, 128), mean=(0.5, 0.5, 0.5), std=(0.5, 0.5, 0.5),
                 fix_choices: Optional[Tuple[int, int]] = (0, 1),
                 percent_objects: float = 0.1, root: str = "datasets", seed: int = 0,
                 scale_intrinsics: bool = False):
        """``scale_intrinsics``: the capture's true pixel focal rescaled to
        the encoded resolution instead of the hard-coded 138."""
        if isinstance(shape, int):
            shape = (shape, shape)
        if isinstance(encoded_shape, int):
            encoded_shape = (encoded_shape, encoded_shape)
        self.H, self.W = shape
        self.encoded_H, self.encoded_W = encoded_shape

        images, poses, norm_intrinsic = load_data(
            dataset=dataset_name, shape=shape, mean=mean, std=std,
            fix_choices=fix_choices, percent_objects=percent_objects, root=root,
            seed=seed)
        images = np.asarray(images, np.float32)
        poses = np.asarray(poses, np.float32)

        if images.ndim == 4:
            # single scene: partner = shuffled copy (dataset.py:40-48)
            perm = np.random.default_rng(seed).permutation(images.shape[0])
            self.reference_images, self.target_images = images, images[perm]
            self.reference_poses, self.target_poses = poses, poses[perm]
            if scale_intrinsics:
                self.intrinsic = np.array(
                    [norm_intrinsic[0, 0] * self.encoded_W,
                     norm_intrinsic[1, 1] * self.encoded_H,
                     self.encoded_W // 2, self.encoded_H // 2], np.float32)
            else:
                self.intrinsic = np.array(
                    [138.0, 138.0, self.encoded_W // 2, self.encoded_H // 2], np.float32)
        else:
            # objaverse [O, 2, ...]: view 0 = reference, view 1 = target
            self.reference_images = images[:, 0]
            self.target_images = images[:, 1]
            self.reference_poses = poses[:, 0]
            self.target_poses = poses[:, 1]
            fov = 47.1
            # degrees used as radians, as the reference does (dataset.py:56-58)
            fov_x = self.W / (2 * math.tan(fov / 2))
            fov_y = self.H / (2 * math.tan(fov / 2))
            self.intrinsic = np.array(
                [fov_x, fov_y, self.encoded_W // 2, self.encoded_H // 2], np.float32)

        self.reference_rays = _rays(self.reference_poses, self.intrinsic,
                                    self.encoded_H, self.encoded_W)
        self.target_rays = _rays(self.target_poses, self.intrinsic,
                                 self.encoded_H, self.encoded_W)

    def __len__(self) -> int:
        return self.target_images.shape[0]

    def __getitem__(self, idx) -> Dict[str, np.ndarray]:
        return {
            "target_image": self.target_images[idx],
            "reference_image": self.reference_images[idx],
            "target_pose": self.target_poses[idx],
            "reference_pose": self.reference_poses[idx],
            "target_rays_o": self.target_rays["rays_o"][idx],
            "target_rays_d": self.target_rays["rays_d"][idx],
            "target_rays_inds": self.target_rays["inds"][idx],
            "reference_rays_o": self.reference_rays["rays_o"][idx],
            "reference_rays_d": self.reference_rays["rays_d"][idx],
            "reference_rays_inds": self.reference_rays["inds"][idx],
        }

    def all_poses(self) -> np.ndarray:
        """[2·N, 4, 4] reference + target poses, for mark_untrained_grid
        (reference train.py:190)."""
        return np.concatenate([self.reference_poses, self.target_poses], axis=0)


def collate(samples: Sequence[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    """Stack sample dicts into one batch dict (reference dataset.py:105-113)."""
    return {k: np.stack([s[k] for s in samples]) for k in samples[0].keys()}


def split_dataset(n: int, train_frac: float = 0.8, val_frac: float = 0.1,
                  seed: int = 0) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Random 80/10/10 index split (reference train.py:164-170)."""
    perm = np.random.default_rng(seed).permutation(n)
    n_train = int(train_frac * n)
    n_val = int(val_frac * n)
    return perm[:n_train], perm[n_train:n_train + n_val], perm[n_train + n_val:]


def iterate(dataset, indices: np.ndarray, batch_size: int, *, shuffle: bool = False,
            seed: int = 0, drop_last: bool = True) -> Iterator[Dict[str, np.ndarray]]:
    """Minibatches over a subset of ``dataset``.  ``drop_last`` keeps every
    batch full; a split smaller than one batch is padded by repetition to
    one full batch, with a warning."""
    idx = np.array(indices)
    if shuffle:
        np.random.default_rng(seed).shuffle(idx)
    if drop_last and 0 < len(idx) < batch_size:
        warnings.warn(f"split has {len(idx)} samples < batch_size={batch_size}; "
                      f"padding by repetition to one full batch", stacklevel=2)
        idx = np.resize(idx, batch_size)
    end = len(idx) - (len(idx) % batch_size) if drop_last else len(idx)
    for s in range(0, end, batch_size):
        yield collate([dataset[int(i)] for i in idx[s:s + batch_size]])
