"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU and skips without one.  This file
imports neither JAX nor the JAX package, so it runs on a machine that has
only PyTorch:

    python -m pytest tests/test_torch_cuda.py -m cuda -q

Tolerance: the scatter kernel sums a row in per-thread runs, per-block
partial sums and f32 atomics whose order changes from run to run, so each
row's sum is held to 1e-5 of the row's sum of |updates| against the plain
version's index_add_; the encode's table
gradient (~10 updates a row) to 1e-5 relative and absolute.  The gather
kernel only rounds and moves values: bit for bit.  The tiny inference
step on the card against the CPU: 1e-3 of each key's scale (float32 sums
in other orders through three U-Net passes and the VAE decode).
"""

import pytest
import torch

from stable_nerf_tpu_torch.config import HashGridConfig
from stable_nerf_tpu_torch.ops import encoding
from stable_nerf_tpu_torch.ops.hopper.gather import (sorted_window_gather,
                                                     sorted_window_gather_plain)
from stable_nerf_tpu_torch.ops.hopper.scatter import (hash_scatter_add_per_level,
                                                      hash_scatter_add_plain)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("C", [1, 8])
@pytest.mark.parametrize("L,T,F,payload_bf16", [
    (16, 2 ** 12, 2, False),    # K1-shaped: the table does not fit shared
    (16, 2 ** 12, 2, True),     # memory, each level does; payload_bf16
    (3, 1024, 2, False),        # K2-shaped: the whole table fits
    (4, 1024, 3, False),        # a width other than the grid's 2 features
    (2, 2 ** 16, 2, False),     # no level fits shared memory
])
def test_kernel_matches_plain(cuda, L, T, F, payload_bf16, C):
    g = torch.Generator(device=cuda).manual_seed(0)
    M = 20_003                               # ragged tiles
    idx = (torch.randint(0, T, (M, L, C), generator=g, device=cuda)
           + torch.arange(L, device=cuda)[None, :, None] * T).to(torch.int32)
    idx[:100, 0, 0] = 7                      # a hot row
    idx[1000:3000] = idx[1000:1001]          # runs of equal samples
    idx[-10:, -1, -1] = L * T                # padding rows, dropped
    idx[-10:, 0, -1] = -1
    idx[5000:5050, 0, 0] = idx[5000:5050, -1, 0]    # rows in another level's slab
    upd = torch.randn((M, L, C, F), generator=g, device=cuda)
    before = hash_scatter_add_per_level.launches
    got = hash_scatter_add_per_level(idx, upd, L, T, payload_bf16)
    torch.cuda.synchronize()
    assert hash_scatter_add_per_level.launches == before + 1
    want = hash_scatter_add_plain(idx, upd, L * T, payload_bf16)
    row_abs = hash_scatter_add_plain(idx, upd.abs(), L * T, payload_bf16)
    assert torch.all((got - want).abs() <= 1e-5 * row_abs + 1e-30)


def test_wrapper_raises_instead_of_falling_back(cuda):
    idx = torch.zeros((4, 1, 8), dtype=torch.int64, device=cuda)
    with pytest.raises(TypeError):
        hash_scatter_add_per_level(idx, torch.zeros((4, 1, 8, 2), device=cuda), 1, 16)


@pytest.mark.parametrize("mode,sections", [("exact", 1), ("hybrid", 2)])
def test_hash_encode_table_grad_through_kernel(cuda, mode, sections):
    """The encode's custom backward on the card (one kernel launch per
    level section) against the same backward on the CPU (plain version)."""
    cfg = HashGridConfig(n_levels=6, log2_hashmap_size=12, base_resolution=4)
    kw = dict(custom_bwd=True, stochastic=mode == "hybrid", stochastic_min_level=3)
    g = torch.Generator().manual_seed(1)
    x = torch.rand((5000, 3), generator=g)
    table = torch.rand((cfg.n_levels * cfg.table_size, 2), generator=g) * 2 - 1
    gout = torch.randn((5000, cfg.output_dim), generator=g)
    grads = {}
    for dev in ("cpu", "cuda"):
        t = table.to(dev, copy=True).requires_grad_(True)
        before = hash_scatter_add_per_level.launches
        (encoding.hash_grid_encode({"table": t}, x.to(dev), cfg, **kw)
         * gout.to(dev)).sum().backward()
        launched = hash_scatter_add_per_level.launches - before
        assert launched == (sections if dev == "cuda" else 0)
        grads[dev] = t.grad.cpu()
    torch.testing.assert_close(grads["cuda"], grads["cpu"], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("T,F,M,dtype,is_sorted", [
    (8192, 2, 3000, torch.float32, True),       # the reference tests' shape
    (32768, 2, 1024, torch.float32, True),
    (16 * 4096, 2, 100_003, torch.bfloat16, True),
    (8192, 2, 50_000, torch.float32, False),    # unsorted: same rows
    (5000, 1, 4097, torch.float32, True),       # T no multiple of 4096, F != 2
    (5000, 4, 4097, torch.bfloat16, True),
    (4096, 8, 999, torch.float16, True),        # cast to bf16 by the wrapper
])
def test_gather_kernel_matches_plain(cuda, T, F, M, dtype, is_sorted):
    g = torch.Generator(device=cuda).manual_seed(0)
    table = torch.randn((T, F), generator=g, device=cuda).to(dtype)
    idx = torch.randint(-3, T + 3, (M,), generator=g, device=cuda, dtype=torch.int32)
    if is_sorted:
        idx = torch.sort(idx)[0]
    before = sorted_window_gather.launches
    got = sorted_window_gather(table, idx)
    torch.cuda.synchronize()
    assert sorted_window_gather.launches == before + 1
    assert got.dtype == torch.float32
    assert torch.equal(got, sorted_window_gather_plain(table, idx))


def test_gather_empty_and_wrapper_raises(cuda):
    table = torch.zeros((16, 2), device=cuda)
    before = sorted_window_gather.launches
    out = sorted_window_gather(table, torch.zeros(0, dtype=torch.int32, device=cuda))
    assert out.shape == (0, 2) and sorted_window_gather.launches == before
    with pytest.raises(TypeError):
        sorted_window_gather(table, torch.zeros(4, dtype=torch.int64, device=cuda))
    with pytest.raises(ValueError):
        sorted_window_gather(table.T, torch.zeros(4, dtype=torch.int32, device=cuda))
    with pytest.raises(ValueError):
        sorted_window_gather(table, torch.zeros(4, dtype=torch.int32))


def test_budgeted_render_grads_through_kernel(cuda):
    """A binding sample budget under gradient: the scatter kernel runs on
    the compacted positions (one launch: the budget is one chunk) and the
    table gradient matches the CPU's."""
    from stable_nerf_tpu_torch.config import NeRFConfig
    from stable_nerf_tpu_torch.models.nerf.grid import grid_init
    from stable_nerf_tpu_torch.models.nerf.network import nerf_init
    from stable_nerf_tpu_torch.models.nerf.renderer import render
    from stable_nerf_tpu_torch.utils.tree import tree_map

    cfg = NeRFConfig(channel_dim=4, grid_size=16, density_scale=3.0,
                     encoding_sigma=HashGridConfig(n_levels=4, log2_hashmap_size=10,
                                                   base_resolution=4))
    g = torch.Generator().manual_seed(2)
    params = nerf_init(0, cfg, device="cpu")
    params["hash"]["table"].mul_(1e4)
    grid = grid_init(cfg, device="cpu")
    grid = grid._replace(occ=torch.rand(grid.occ.shape, generator=g) < 0.3)
    o = torch.tensor([0.0, 0.0, 2.0]).expand(64, 3).contiguous()
    d = torch.nn.functional.normalize(
        torch.tensor([0.0, 0.0, -1.0]) + 0.3 * torch.randn((64, 3), generator=g), dim=-1)
    w = torch.randn((64, 4), generator=g)
    grads = {}
    for dev in ("cpu", "cuda"):
        p = tree_map(lambda x: x.to(dev, copy=True), params)
        table = p["hash"]["table"].requires_grad_(True)
        before = hash_scatter_add_per_level.launches
        out = render(p, type(grid)(*(t.to(dev) for t in grid)), o.to(dev), d.to(dev),
                     cfg, max_steps=32, sample_budget=100)
        (out["image"] * w.to(dev)).sum().backward()
        assert hash_scatter_add_per_level.launches - before == (dev == "cuda")
        grads[dev] = table.grad.cpu()
    assert float(grads["cpu"].abs().max()) > 0
    torch.testing.assert_close(grads["cuda"], grads["cpu"], rtol=1e-4, atol=1e-6)


def test_inference_step_on_card_matches_cpu(cuda):
    """The tiny inference step (3 DDIM steps, float32, guidance 3, sparse
    grid) on the card against the CPU, same params and draws."""
    from stable_nerf_tpu_torch.config import (NeRFConfig, SDConfig, TrainConfig)
    from stable_nerf_tpu_torch.data.rays import get_rays, rand_poses
    from stable_nerf_tpu_torch.models.diffusion.scheduler import DDIMScheduler
    from stable_nerf_tpu_torch.models.diffusion.sd_network import (
        SDNetworkConfig, init_ip_from_unet, sd_network_init)
    from stable_nerf_tpu_torch.models.diffusion.unet import tiny_unet_config
    from stable_nerf_tpu_torch.models.diffusion.vae import VAEConfig
    from stable_nerf_tpu_torch.models.nerf.grid import grid_init
    from stable_nerf_tpu_torch.models.nerf.network import nerf_init
    from stable_nerf_tpu_torch.training.inference import make_inference_step
    from stable_nerf_tpu_torch.training.joint import JointConfig
    from stable_nerf_tpu_torch.utils.device import disable_tf32
    from stable_nerf_tpu_torch.utils.tree import tree_map

    disable_tf32()
    cfg = JointConfig(
        nerf=NeRFConfig(channel_dim=4, grid_size=32,
                        encoding_sigma=HashGridConfig(n_levels=4, log2_hashmap_size=12,
                                                      base_resolution=4)),
        sd=SDNetworkConfig(
            sd=SDConfig(cross_attention_dim=48, latent_size=16, image_size=32),
            unet=tiny_unet_config(),
            vae=VAEConfig(block_out_channels=(16, 32), layers_per_block=1,
                          norm_groups=8)),
        train=TrainConfig(max_steps_eval=64, sample_budget_eval_per_ray=8))
    g = torch.Generator().manual_seed(4)
    params = {"sd": init_ip_from_unet(sd_network_init(0, cfg.sd, device="cpu")),
              "nerf": nerf_init(1, cfg.nerf, device="cpu")}
    params["nerf"]["hash"]["table"].mul_(1e4)
    grid = grid_init(cfg.nerf, device="cpu")
    grid = grid._replace(occ=torch.rand(grid.occ.shape, generator=g) < 0.4)
    intr = (16.0, 16.0, 8.0, 8.0)
    rt = get_rays(rand_poses(g, 2, radius=2.0), intr, 16, 16)
    rr = get_rays(rand_poses(g, 2, radius=2.0), intr, 16, 16)
    batch = {"target_image": torch.rand((2, 3, 32, 32), generator=g) * 2 - 1,
             "reference_image": torch.rand((2, 3, 32, 32), generator=g) * 2 - 1,
             "target_rays_o": rt["rays_o"], "target_rays_d": rt["rays_d"],
             "reference_rays_o": rr["rays_o"], "reference_rays_d": rr["rays_d"]}
    draws = {"vae_eps": torch.randn((2, 4, 16, 16), generator=g),
             "init_latents": torch.randn((2, 4, 16, 16), generator=g)}
    outs = {}
    for dev in ("cpu", "cuda"):
        step = make_inference_step(cfg, DDIMScheduler.create(cfg.sd.scheduler, device=dev),
                                   3, compute_dtype=torch.float32, guidance_scale=3.0,
                                   device=dev)
        outs[dev] = step(tree_map(lambda x: x.to(dev), params),
                         type(grid)(*(t.to(dev) for t in grid)),
                         {k: v.to(dev) for k, v in batch.items()},
                         draws={k: v.to(dev) for k, v in draws.items()})
    for k, ref in outs["cpu"].items():
        scale = 1.0 if k == "ssim" else float(ref.abs().max())
        err = float((outs["cuda"][k].cpu() - ref).abs().max())
        assert err <= 1e-3 * scale, (k, err, scale)


def test_device_prefetch_and_checkpoint_round_trip_on_the_card(cuda, tmp_path):
    """Batches reach the card in order and unchanged through the pinned
    pipeline; a checkpoint of tiny card-resident params, AdamW state and
    grid restores into another run's live tensors bit for bit."""
    import numpy as np

    from stable_nerf_tpu_torch import train as cli
    from stable_nerf_tpu_torch.data.prefetch import device_prefetch
    from stable_nerf_tpu_torch.models.nerf.grid import OccupancyGridState
    from stable_nerf_tpu_torch.training.checkpoints import CheckpointManager
    from stable_nerf_tpu_torch.training.joint import (joint_trainable_mask,
                                                      make_lr_scheduler, make_optimizer)
    from stable_nerf_tpu_torch.training.loop import build_initial_params
    from stable_nerf_tpu_torch.utils.tree import tree_leaves

    batches = [{"a": np.full((3, 64), i, np.float32), "b": np.arange(5) + i}
               for i in range(5)]
    out = list(device_prefetch(iter(batches), size=2))
    assert len(out) == 5
    for got, want in zip(out, batches):
        for k in want:
            assert got[k].is_cuda
            assert np.array_equal(got[k].cpu().numpy(), want[k])

    cfg = cli.build_config(cli.build_parser().parse_args(
        ["--tiny", "--image-size", "32", "--latent-size", "16", "--frozen-bf16",
         "--lr-schedule", "exponential"]))

    def state(seed, steps):
        params = build_initial_params(cfg, seed, seed + 1)
        mask = joint_trainable_mask(params)
        opt = make_optimizer(cfg.train, params, mask)
        sched = make_lr_scheduler(cfg.train, opt)
        g = torch.Generator(device=cuda).manual_seed(seed)
        for _ in range(steps):
            for group in opt.param_groups:
                for p in group["params"]:
                    p.grad = torch.randn(p.shape, generator=g, device=cuda)
            opt.step()
            opt.zero_grad()
            sched.step()
        grid = OccupancyGridState(
            torch.rand((1, 32 ** 3), generator=g, device=cuda),
            torch.rand((1, 32, 32, 32), generator=g, device=cuda) < 0.5,
            torch.tensor(0.5, device=cuda), torch.tensor(2, dtype=torch.int32, device=cuda))
        return params, opt, sched, grid

    params, opt, sched, grid = state(0, 2)
    mgr = CheckpointManager(str(tmp_path / "ck"))
    mgr.save(2, params, {"optimizer": opt.state_dict(), "lr_scheduler": sched.state_dict()},
             grid, extra={"epoch": 2})
    params2, opt2, sched2, grid2 = state(7, 0)
    got = mgr.restore(template={"params": params2, "opt_state": None,
                                "grid_state": grid2, "extra": None})
    opt2.load_state_dict(got["opt_state"]["optimizer"])
    sched2.load_state_dict(got["opt_state"]["lr_scheduler"])
    for a, b in zip(tree_leaves(params), tree_leaves(params2)):
        assert b.is_cuda and torch.equal(a, b) and a.dtype == b.dtype
    for a, b in zip(grid, got["grid_state"]):
        assert b.is_cuda and torch.equal(a, b)
    for p, p2 in zip([p for g in opt.param_groups for p in g["params"]],
                     [p for g in opt2.param_groups for p in g["params"]]):
        for k, v in opt.state[p].items():
            assert torch.equal(v.cpu(), opt2.state[p2][k].cpu()), k
        assert opt2.state[p2]["exp_avg"].is_cuda
    assert sched2.last_epoch == 2
