"""The port's data pipeline (data/{rays,preprocess,dataset,prefetch}.py)
against the JAX package's on the CPU, on the committed synthetic scene
(datasets/nerf/synthetic_spheres.npz) and on random images.

Tolerances: poses, intrinsics, split indices and batch order exactly
equal; images exactly equal on the scene (the port's PIL-compatible
resize in PyTorch equals PIL's BILINEAR there) and within one uint8 step
(2/255 after the 0.5/0.5 normalization) on random images, where PyTorch's
and PIL's fixed-point rounding may part on a few pixels; rays within
1e-6, the same formula computed by XLA and by PyTorch.
"""

import math
import os
import warnings

import numpy as np
import pytest
import torch

from stable_nerf_tpu.data import dataset as jds
from stable_nerf_tpu.data import preprocess as jpre
from stable_nerf_tpu.data import rays as jrays
from stable_nerf_tpu_torch.data import dataset as tds
from stable_nerf_tpu_torch.data import preprocess as tpre
from stable_nerf_tpu_torch.data import rays as trays
from stable_nerf_tpu_torch.data.prefetch import device_prefetch

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.join(REPO, "datasets")
SCENE = os.path.join(ROOT, "nerf", "synthetic_spheres.npz")


def test_nerf_matrix_to_ngp_equals_jax(rng):
    for _ in range(5):
        pose = rng.normal(size=(4, 4)).astype(np.float32)
        np.testing.assert_array_equal(trays.nerf_matrix_to_ngp(pose),
                                      jrays.nerf_matrix_to_ngp(pose))
    pose = rng.normal(size=(3, 4)).astype(np.float32)
    np.testing.assert_array_equal(trays.nerf_matrix_to_ngp(pose, 0.5, (1, 2, 3)),
                                  jrays.nerf_matrix_to_ngp(pose, 0.5, (1, 2, 3)))


@pytest.mark.parametrize("size", [512, 64, 32])
def test_preprocess_images_equal_pil_on_the_scene(size):
    pytest.importorskip("PIL")          # the reference resizes with PIL
    images = np.load(SCENE)["images"][:8]
    want = jpre.preprocess_images(images, (size, size))
    got = tpre.preprocess_images(images, (size, size))
    assert got.dtype == np.float32 and got.shape == (8, 3, size, size)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape", [(64, 64), (16, 20), (100, 7), (37, 53)])
def test_preprocess_images_within_one_step_of_pil_on_random_images(rng, shape):
    pytest.importorskip("PIL")
    images = rng.uniform(0, 1, (3, 37, 53, 3)).astype(np.float32)
    want = jpre.preprocess_images(images, shape)
    got = tpre.preprocess_images(images, shape)
    assert np.abs(got - want).max() <= 2 / 255 + 1e-7
    exact = float(np.mean(got == want))
    print(f"{shape}: {exact:.4f} of the values exactly equal")
    assert exact > 0.99


def test_construct_normalized_camera_intrinsics_equals_jax():
    for shape, f in [((64, 64), 50.0), ((512, 384), 35.0)]:
        np.testing.assert_array_equal(tpre.construct_normalized_camera_intrinsics(shape, f),
                                      jpre.construct_normalized_camera_intrinsics(shape, f))


def test_load_nerf_data_on_the_scene_equals_jax():
    pytest.importorskip("PIL")
    want = jpre.load_data("synthetic", (64, 64), root=ROOT)
    got = tpre.load_data("synthetic", (64, 64), root=ROOT)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_scene_marker_guards_raise_alike(tmp_path):
    for mod in (jpre, tpre):
        with pytest.raises(ValueError, match="scene marker"):
            mod.load_nerf_data((8, 8), root=ROOT, filename="synthetic_spheres.npz")
        with pytest.raises(ValueError, match="expected scene marker"):
            mod.load_nerf_data((8, 8), root=ROOT, filename="synthetic_spheres.npz",
                               expect_scene="other")
        with pytest.raises(FileNotFoundError):
            mod.load_data("nerf", (8, 8), root=str(tmp_path))
        with pytest.raises(ValueError, match="not in"):
            mod.load_data("unknown", (8, 8), root=ROOT)
    # an unmarked file asked for as a marked scene
    (tmp_path / "nerf").mkdir()
    d = np.load(SCENE)
    np.savez(tmp_path / "nerf" / "synthetic_spheres.npz", images=d["images"][:2],
             poses=d["poses"][:2], focal=d["focal"])
    for mod in (jpre, tpre):
        with pytest.raises(ValueError, match="expected scene marker"):
            mod.load_data("synthetic", (8, 8), root=str(tmp_path))
    # no objaverse renders in the repository: both name the directory
    for mod in (jpre, tpre):
        with pytest.raises(FileNotFoundError, match="objaverse/views_release"):
            mod.load_data("objaverse", (8, 8), root=ROOT)


@pytest.mark.parametrize("scale_intrinsics", [False, True])
def test_dataset_keys_and_intrinsic_equal_jax(scale_intrinsics):
    pytest.importorskip("PIL")
    kw = dict(shape=64, encoded_shape=16, root=ROOT, seed=3,
              scale_intrinsics=scale_intrinsics)
    want = jds.StableNeRFDataset("synthetic", **kw)
    got = tds.StableNeRFDataset("synthetic", **kw)
    assert len(got) == len(want) == 64
    assert got.intrinsic.dtype == np.float32
    np.testing.assert_array_equal(got.intrinsic, want.intrinsic)
    if not scale_intrinsics:        # the hard-coded focal of the reference
        np.testing.assert_array_equal(got.intrinsic, [138.0, 138.0, 8.0, 8.0])
    np.testing.assert_array_equal(got.all_poses(), want.all_poses())
    for i in (0, 17, 63):
        a, b = got[i], want[i]
        assert set(a) == set(b) == set(tds.SAMPLE_KEYS)
        for k in a:
            if "rays_o" in k or "rays_d" in k:
                np.testing.assert_allclose(a[k], b[k], rtol=1e-6, atol=1e-6)
            else:
                np.testing.assert_array_equal(a[k], b[k])


def test_objaverse_branch_and_fov_quirk_equal_jax(monkeypatch, rng):
    """The two-view branch: view 0 reference, view 1 target, and the focal
    ``W / (2·tan(47.1 / 2))`` with degrees fed to tan as radians (reference
    dataset.py:56-58), on the same loaded arrays for both packages (the
    loaders themselves: tests/test_torch_objaverse.py); without the data,
    the objaverse loader names the directory it needs."""
    images = rng.uniform(-1, 1, (3, 2, 3, 32, 32)).astype(np.float32)
    poses = np.stack([[trays.nerf_matrix_to_ngp(rng.normal(size=(4, 4)))
                       for _ in range(2)] for _ in range(3)])
    loaded = (images, poses, np.eye(3, dtype=np.float32))
    monkeypatch.setattr(jds, "load_data", lambda **kw: loaded)
    monkeypatch.setattr(tds, "load_data", lambda **kw: loaded)
    want = jds.StableNeRFDataset("objaverse", shape=32, encoded_shape=8)
    got = tds.StableNeRFDataset("objaverse", shape=32, encoded_shape=8)
    np.testing.assert_array_equal(got.intrinsic, want.intrinsic)
    np.testing.assert_allclose(got.intrinsic[0], 32 / (2 * math.tan(47.1 / 2)), rtol=1e-6)
    for i in range(3):
        np.testing.assert_array_equal(got[i]["reference_image"], images[i, 0])
        np.testing.assert_array_equal(got[i]["target_pose"], poses[i, 1])
        np.testing.assert_allclose(got[i]["target_rays_d"], want[i]["target_rays_d"],
                                   rtol=1e-6, atol=1e-6)
    with pytest.raises(FileNotFoundError, match="objaverse/views_release"):
        monkeypatch.undo()
        tds.StableNeRFDataset("objaverse", shape=64, encoded_shape=16, root=ROOT)


class _Recorder:
    """A dataset of index records that logs every index it is asked for."""

    def __init__(self, n):
        self.n, self.seen = n, []

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        self.seen.append(i)
        return {"i": np.array(i), "x": np.full((2, 3), i, np.float32)}


@pytest.mark.parametrize("n,frac", [(10, (0.8, 0.1)), (64, (0.8, 0.1)), (7, (0.5, 0.25))])
def test_split_dataset_equals_jax(n, frac):
    for seed in (0, 5):
        for a, b in zip(tds.split_dataset(n, *frac, seed=seed),
                        jds.split_dataset(n, *frac, seed=seed)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("n_idx,batch,shuffle,drop_last", [
    (8, 2, True, True), (9, 4, True, True), (9, 4, False, False), (1, 2, False, True),
    (3, 5, True, True)])
def test_iterate_order_and_padding_equal_jax(n_idx, batch, shuffle, drop_last):
    idx = np.arange(100, 100 + n_idx)
    runs = []
    for mod in (tds, jds):
        ds = _Recorder(200)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            batches = list(mod.iterate(ds, idx, batch, shuffle=shuffle, seed=4,
                                       drop_last=drop_last))
        runs.append((ds.seen, [b["i"].tolist() for b in batches],
                     [str(w.message) for w in caught]))
    assert runs[0] == runs[1]
    padded = drop_last and 0 < n_idx < batch
    assert bool(runs[0][2]) == padded
    if padded:
        assert "padding by repetition" in runs[0][2][0]


def test_collate_equals_jax(rng):
    samples = [{"a": rng.normal(size=(3,)).astype(np.float32), "b": np.array(i)}
               for i in range(4)]
    got, want = tds.collate(samples), jds.collate(samples)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


def test_device_prefetch_on_the_cpu_keeps_order_and_values():
    ds = _Recorder(20)
    batches = list(tds.iterate(ds, np.arange(10), 2))
    out = list(device_prefetch(iter(batches), size=2, device="cpu"))
    assert len(out) == len(batches)
    for got, want in zip(out, batches):
        assert set(got) == set(want)
        for k in want:
            assert isinstance(got[k], torch.Tensor) and got[k].device.type == "cpu"
            np.testing.assert_array_equal(got[k].numpy(), want[k])
    assert list(device_prefetch(iter([]), device="cpu")) == []
