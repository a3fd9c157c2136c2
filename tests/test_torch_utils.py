"""The port's small utilities against the JAX package's on the CPU:
``StepTimer`` (utils/profiling.py), ``sample_save_for_vis`` and
``save_image`` (utils/visualization.py), ``partition``/``combine``/
``dealias`` (utils/tree.py).  Counters and rates equal to 1e-12 relative
(the same float64 arithmetic); files equal in name, shape and value."""

import random
import sys

import numpy as np
import pytest
import torch

from stable_nerf_tpu.utils import profiling as jprof
from stable_nerf_tpu.utils import pytree as jtree
from stable_nerf_tpu.utils import visualization as jvis
from stable_nerf_tpu_torch.utils import profiling as tprof
from stable_nerf_tpu_torch.utils import tree as ttree
from stable_nerf_tpu_torch.utils import visualization as tvis


def test_step_timer_observe_equals_jax():
    spans = [(8, 8 * 8192, 5.2), (0, 0, 1.0), (8, 8 * 8192, 4.9), (3, 3 * 100, 0.0),
             (5, 5 * 8192, 3.1)]
    timers = [tprof.StepTimer(), jprof.StepTimer()]
    for steps, rays, s in spans:
        for t in timers:
            t.observe(steps, rays, s)
    got, want = timers
    assert (got.total_steps, got.total_rays) == (want.total_steps, want.total_rays) == (21, 21 * 8192)
    for name in ("steps_per_sec", "rays_per_sec"):
        np.testing.assert_allclose(getattr(got, name)(), getattr(want, name)(), rtol=1e-12)
    np.testing.assert_allclose(got.avg_dt, want.avg_dt, rtol=1e-12)
    assert tprof.StepTimer().steps_per_sec() == jprof.StepTimer().steps_per_sec() == 0.0


def test_device_memory_stats_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert tprof.device_memory_stats() == {}


@pytest.mark.parametrize("prob,max_files", [(0.5, 64), (0.9, 3), (0.0, 64)])
def test_sample_save_for_vis_draws_and_caps_as_jax(tmp_path, prob, max_files):
    x = np.arange(12, dtype=np.float32).reshape(3, 4)
    saved = {}
    for name, mod, arr in (("t", tvis, torch.from_numpy(x)), ("j", jvis, x)):
        rng = random.Random(17)
        d = tmp_path / name
        paths = [mod.sample_save_for_vis(p, arr, prob, directory=str(d), rng=rng,
                                         max_files=max_files)
                 for _ in range(10) for p in ("latents", "pred")]
        saved[name] = ([None if p is None else p.split("/")[-1] for p in paths],
                       rng.random())
    assert saved["t"] == saved["j"]          # same files, and the draws stay aligned
    for f in (tmp_path / "t").glob("*.npy") if prob else []:
        np.testing.assert_array_equal(np.load(f), np.load(tmp_path / "j" / f.name))


def test_sample_save_for_vis_takes_card_dtypes():
    x = torch.ones((2, 2), dtype=torch.bfloat16)
    assert tvis._to_numpy(x).dtype == np.float32


@pytest.mark.parametrize("pil", [True, False])
def test_save_image_equals_jax(tmp_path, monkeypatch, pil):
    if pil:
        pytest.importorskip("PIL")
    else:                                    # the card's machine has no PIL
        monkeypatch.setitem(sys.modules, "PIL", None)
    img = np.random.default_rng(0).uniform(-0.2, 1.2, (3, 8, 6)).astype(np.float32)
    tvis.save_image(str(tmp_path / "t.png"), torch.from_numpy(img), chw=True)
    jvis.save_image(str(tmp_path / "j.png"), img, chw=True)
    if pil:
        from PIL import Image

        np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "t.png")),
                                      np.asarray(Image.open(tmp_path / "j.png")))
    else:
        a, b = np.load(tmp_path / "t.png.npy"), np.load(tmp_path / "j.png.npy")
        assert a.dtype == b.dtype == np.uint8 and a.shape == (8, 6, 3)
        np.testing.assert_array_equal(a, b)


def test_partition_and_combine_equal_jax():
    tree = {"a": [torch.ones(2), torch.zeros(3)], "b": {"c": torch.full((1,), 2.0)}}
    mask = {"a": [True, False], "b": {"c": True}}
    t, f = ttree.partition(tree, mask)
    assert t["a"][1] is None and f["a"][0] is None and f["b"]["c"] is None
    back = ttree.combine(t, f)
    for x, y in zip(ttree.tree_leaves(back), ttree.tree_leaves(tree)):
        assert x is y
    np_tree = {"a": [np.ones(2), np.zeros(3)], "b": {"c": np.full((1,), 2.0)}}
    jt, jf = jtree.partition(np_tree, mask)
    assert [x is None for x in ttree.tree_leaves(t)] == \
        [x is None for x in [jt["a"][0], jt["a"][1], jt["b"]["c"]]]


def test_dealias_clones_shared_memory_only():
    w = torch.randn(4, 3, requires_grad=True)
    other = torch.randn(2)
    tree = {"k": w, "ip": w, "view": w[1:], "x": other}
    out, = ttree.dealias(tree)
    assert out["k"] is w and out["x"] is other
    for k in ("ip", "view"):
        assert out[k] is not w and torch.equal(out[k], tree[k])
        assert out[k].untyped_storage().data_ptr() != w.untyped_storage().data_ptr()
    assert out["ip"].requires_grad
    a, b = ttree.dealias({"p": w}, {"q": w})
    assert a["p"] is w and b["q"] is not w
