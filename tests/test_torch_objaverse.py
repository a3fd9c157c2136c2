"""The port's Objaverse path (data/native_loader.py, the objaverse branch of
data/preprocess.py and of data/dataset.py) against the JAX package's, on
the CPU, on PNGs written by PIL.

Both packages build the same ``native/dataloader.cpp``: its three
functions must agree bit for bit.  ``load_objaverse_data`` decodes with the
native loader where the JAX package uses PIL; at 32² from 64² RGBA PNGs
the images, poses and intrinsics must be equal bit for bit.  The JAX
package appends objects in the order their loads complete, the port in
the sorted listing's: objects are matched by their poses.  The dataset's
rays: 1e-6 (both compute them from equal poses in float32).
"""

import os

import numpy as np
import pytest
from PIL import Image

from stable_nerf_tpu.data import dataset as jds
from stable_nerf_tpu.data import native_loader as jnl
from stable_nerf_tpu.data import preprocess as jpre
from stable_nerf_tpu_torch.data import dataset as tds
from stable_nerf_tpu_torch.data import native_loader as tnl
from stable_nerf_tpu_torch.data import preprocess as tpre
from stable_nerf_tpu_torch.data.rays import nerf_matrix_to_ngp


def _write_object(d, rng, mode="RGBA", size=64, pose_rows=4, views=12):
    os.makedirs(d)
    for i in range(views):
        ch = {"RGBA": 4, "RGB": 3}.get(mode, 1)
        arr = rng.integers(0, 256, (size, size, ch), dtype=np.uint8)
        img = Image.fromarray(arr.squeeze(-1) if ch == 1 else arr, mode=mode if ch > 1 else "L")
        if mode == "P":
            img = img.convert("P")
        img.save(os.path.join(d, f"{i:03d}.png"))
        pose = np.eye(4)
        pose[:3] = rng.normal(size=(3, 4))
        np.save(os.path.join(d, f"{i:03d}.npy"), pose[:pose_rows])


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """views_release with 4 objects: RGBA with 4×4 poses, RGB, RGBA with
    3×4 poses, and one whose view 1 is a truncated PNG (dropped)."""
    base = tmp_path_factory.mktemp("data")
    views = base / "objaverse" / "views_release"
    rng = np.random.default_rng(0)
    _write_object(str(views / "a_rgba"), rng)
    _write_object(str(views / "b_rgb"), rng, mode="RGB")
    _write_object(str(views / "c_pose3x4"), rng, pose_rows=3)
    _write_object(str(views / "d_corrupt"), rng)
    data = open(views / "d_corrupt" / "001.png", "rb").read()
    open(views / "d_corrupt" / "001.png", "wb").write(data[: len(data) // 2])
    return str(base)


def _match(port_poses, jax_poses):
    """The permutation p with jax_poses[p[i]] == port_poses[i]."""
    perm = [next(j for j in range(len(jax_poses)) if np.array_equal(jax_poses[j], p))
            for p in port_poses]
    assert sorted(perm) == list(range(len(jax_poses)))
    return perm


def test_native_loader_functions_equal_jax(root, tmp_path):
    views = os.path.join(root, "objaverse", "views_release")
    paths = [os.path.join(views, o, "000.png") for o in ("a_rgba", "b_rgb", "c_pose3x4")]
    paths.append(os.path.join(views, "d_corrupt", "001.png"))
    for p in paths[:3]:
        data = open(p, "rb").read()
        for shape, mean, std in (((64, 64), (0.0,) * 3, (1.0,) * 3), ((32, 24), (0.5,) * 3,
                                                                     (0.5,) * 3)):
            np.testing.assert_array_equal(tnl.decode_image(data, shape, mean, std),
                                          jnl.decode_image(data, shape, mean, std))
        want = np.asarray(Image.open(p).convert("RGB"))
        np.testing.assert_array_equal(tnl.decode_png_uint8(data), want)
    got, status = tnl.load_batch(paths, (32, 32), n_threads=2)
    ref, ref_status = jnl.load_batch(paths, (32, 32), n_threads=2)
    np.testing.assert_array_equal(status, ref_status)
    assert list(status[:3]) == [0, 0, 0] and status[3] != 0
    np.testing.assert_array_equal(got[:3], ref[:3])
    pose = os.path.join(views, "a_rgba", "005.npy")
    np.testing.assert_array_equal(tnl.decode_npy_pose(pose), jnl.decode_npy_pose(pose))
    with pytest.raises(ValueError, match="native npy read failed"):
        tnl.decode_npy_pose(os.path.join(views, "c_pose3x4", "000.npy"))   # 3×4
    with pytest.raises(ValueError, match="native PNG decode failed"):
        tnl.decode_image(b"\x89PNG\r\n\x1a\n" + b"\0" * 40, (4, 4))


def test_load_objaverse_data_equals_jax_bit_for_bit(root):
    images, poses, intr = tpre.load_data("objaverse", shape=(32, 32), percent_objects=1.0,
                                         root=root)
    j_images, j_poses, j_intr = jpre.load_data("objaverse", shape=(32, 32),
                                               percent_objects=1.0, root=root)
    assert images.shape == (3, 2, 3, 32, 32) and images.dtype == np.float32
    assert poses.shape == (3, 2, 4, 4) and poses.dtype == np.float32
    perm = _match(poses, j_poses)
    np.testing.assert_array_equal(images, j_images[perm])
    np.testing.assert_array_equal(intr, j_intr)
    # the sorted listing's order: the corrupt object is the one missing
    first = np.load(os.path.join(root, "objaverse", "views_release", "a_rgba", "000.npy"))
    np.testing.assert_array_equal(poses[0, 0], tpre.nerf_matrix_to_ngp(first))
    # percent_objects cuts the sorted listing before loading
    few = tpre.load_objaverse_data((32, 32), percent_objects=0.5, root=root)[1]
    np.testing.assert_array_equal(few, poses[:2])


def test_dataset_objaverse_rays_and_intrinsics_equal_jax(root):
    got = tds.StableNeRFDataset("objaverse", shape=32, encoded_shape=8, percent_objects=1.0,
                                root=root)
    want = jds.StableNeRFDataset("objaverse", shape=32, encoded_shape=8,
                                 percent_objects=1.0, root=root)
    np.testing.assert_array_equal(got.intrinsic, want.intrinsic)
    perm = _match(got.target_poses, want.target_poses)
    assert len(got) == len(want) == 3
    for i, j in enumerate(perm):
        a, b = got[i], want[j]
        assert set(a) == set(b) == set(tds.SAMPLE_KEYS)
        for k in a:
            if "rays_o" in k or "rays_d" in k:
                np.testing.assert_allclose(a[k], b[k], rtol=1e-6, atol=1e-6, err_msg=k)
            else:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_views_drawn_from_a_seeded_generator_and_a_palette_png_dropped(tmp_path):
    """Kept differences (ROADMAP §3): with ``fix_choices=None`` the port
    draws an object's views from a generator seeded by (the dataset's
    ``seed``, the object's index in the sorted listing), whatever order the
    threads finish in (the JAX package from an unseeded one); a palette
    PNG, which PIL decodes, is refused by the native loader, so its object
    drops in the port only."""
    views = tmp_path / "objaverse" / "views_release"
    rng = np.random.default_rng(1)
    _write_object(str(views / "a"), rng, size=16)
    _write_object(str(views / "b_palette"), rng, mode="P", size=16)
    _write_object(str(views / "c"), rng, size=16)
    expect = np.stack([
        [nerf_matrix_to_ngp(np.load(str(views / name / f"{i:03d}.npy")))
         for i in np.random.default_rng([7, index]).choice(12, 2, replace=False)]
        for index, name in ((0, "a"), (2, "c"))]).astype(np.float32)
    for _ in range(2):
        ds = tds.StableNeRFDataset("objaverse", shape=16, encoded_shape=8, fix_choices=None,
                                   percent_objects=1.0, root=str(tmp_path), seed=7)
        np.testing.assert_array_equal(ds.reference_poses, expect[:, 0])
        np.testing.assert_array_equal(ds.target_poses, expect[:, 1])
    assert jpre.load_objaverse_data((16, 16), percent_objects=1.0,
                                    root=str(tmp_path))[1].shape == (3, 2, 4, 4)


def test_a_loader_that_does_not_build_raises(root, tmp_path, monkeypatch):
    bad = tmp_path / "dataloader.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(tnl, "SOURCE", str(bad))
    monkeypatch.setattr(tnl, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(tnl, "_lib", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        tpre.load_data("objaverse", shape=(32, 32), percent_objects=1.0, root=root)
    monkeypatch.setattr(tnl, "SOURCE", str(tmp_path / "missing.cpp"))
    with pytest.raises(RuntimeError, match="not found"):
        tnl.decode_image(b"", (1, 1))
    with pytest.raises(FileNotFoundError, match="views_release"):
        tpre.load_data("objaverse", root=str(tmp_path))
