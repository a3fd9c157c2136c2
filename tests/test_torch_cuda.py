"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU and skips without one.  This file
imports neither JAX nor the JAX package, so it runs on a machine that has
only PyTorch:

    python -m pytest tests/test_torch_cuda.py -m cuda -q

Tolerance: the scatter kernel sums a row in per-thread runs, per-block
partial sums and f32 atomics whose order changes from run to run, so each
row's sum is held to 1e-5 of the row's sum of |updates| against the plain
version's index_add_; the encode's table
gradient (~10 updates a row) to 1e-5 relative and absolute.  The encode
kernel's rows, one-corner features and updates equal the plain version's
bit for bit; its interpolated features (eight products summed in another
order) are held to 1e-6 of the table's largest magnitude.  The gather
kernel only rounds and moves values: bit for bit.  The tiny inference
step on the card against the CPU: 1e-3 of each key's scale (float32 sums
in other orders through three U-Net passes and the VAE decode).  The demo
VAE artifact loads onto the card bit for bit; a fit step's loss on the
card within 1e-4 of the CPU's.
"""

import pytest
import torch

from stable_nerf_tpu_torch.config import HashGridConfig
from stable_nerf_tpu_torch.ops import encoding
from stable_nerf_tpu_torch.ops.hopper.encode import (hash_encode_backward,
                                                     hash_encode_forward)
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


@pytest.mark.parametrize("mode,sections", [("exact", 1), ("hybrid", 2), ("stochastic", 1)])
def test_hash_encode_table_grad_through_kernel(cuda, mode, sections):
    """The encode's custom backward on the card (the encode kernel's rows
    and updates, then one scatter launch per level section) against the
    same backward on the CPU (plain version)."""
    cfg = HashGridConfig(n_levels=6, log2_hashmap_size=12, base_resolution=4)
    kw = dict(custom_bwd=True, stochastic=mode != "exact",
              stochastic_min_level=3 if mode == "hybrid" else 0)
    g = torch.Generator().manual_seed(1)
    x = torch.rand((5000, 3), generator=g)
    table = torch.rand((cfg.n_levels * cfg.table_size, 2), generator=g) * 2 - 1
    gout = torch.randn((5000, cfg.output_dim), generator=g)
    grads = {}
    for dev in ("cpu", "cuda"):
        t = table.to(dev, copy=True).requires_grad_(True)
        before = (hash_scatter_add_per_level.launches, hash_encode_forward.launches,
                  hash_encode_backward.launches)
        (encoding.hash_grid_encode({"table": t}, x.to(dev), cfg, **kw)
         * gout.to(dev)).sum().backward()
        launched = (hash_scatter_add_per_level.launches - before[0],
                    hash_encode_forward.launches - before[1],
                    hash_encode_backward.launches - before[2])
        assert launched == ((sections, 1, sections) if dev == "cuda" else (0, 0, 0))
        grads[dev] = t.grad.cpu()
    torch.testing.assert_close(grads["cuda"], grads["cpu"], rtol=1e-5, atol=1e-5)


ENCODE_MODES = {"exact": (False, 0), "stochastic": (True, 0), "hybrid": (True, 3)}
ENCODE_GRIDS = {   # levels 0-3 dense and 4-5 hashed at T = 2^12; every level hashed at 2^9
    "dense_and_hashed": dict(n_levels=6, log2_hashmap_size=12, base_resolution=4),
    "hashed": dict(n_levels=5, log2_hashmap_size=9, base_resolution=16),
}


def _encode_positions(M, g, dev):
    """M uniform positions, the first ones at the cube's corners and centre
    and outside [0, 1] (the budget's padded slots sit at 0.5)."""
    x = torch.rand((M, 3), generator=g, device=dev)
    x[:8] = torch.tensor([[0, 0, 0], [1, 1, 1], [0.5, 0.5, 0.5], [-0.25, 0.5, 1.75],
                          [1.5, -0.5, 0.5], [0.999999, 1e-7, 0.5], [1, 0, 1],
                          [2.0, 3.0, -1.0]], device=dev)
    return x


@pytest.mark.parametrize("F", [1, 2, 4])
@pytest.mark.parametrize("grid", sorted(ENCODE_GRIDS))
@pytest.mark.parametrize("mode", sorted(ENCODE_MODES))
def test_encode_kernel_matches_plain(cuda, mode, grid, F):
    """Forward features and the backward's rows and updates against the
    plain functions on the same card: rows, one-corner features and
    updates bit for bit, interpolated features within 1e-6 of the table's
    largest magnitude (eight products summed in another order)."""
    cfg = HashGridConfig(n_features_per_level=F, **ENCODE_GRIDS[grid])
    stochastic, min_level = ENCODE_MODES[mode]
    L, T = cfg.n_levels, cfg.table_size
    g = torch.Generator(device=cuda).manual_seed(3)
    M = 20_003                                  # no multiple of the block
    x = _encode_positions(M, g, cuda)
    table = torch.rand((L * T, F), generator=g, device=cuda) * 2 - 1
    gout = torch.randn((M, L * F), generator=g, device=cuda)
    levels = encoding.level_table(cfg, stochastic, min_level)
    sections = encoding._hash_sections(x, cfg, stochastic, min_level)

    got = hash_encode_forward(x, table, levels, T)
    want = encoding._encode_sections(table, sections)
    torch.cuda.synchronize()
    for lv0, rows, _ in sections:
        a, b = lv0 * F, (lv0 + rows.shape[1]) * F
        if rows.shape[2] == 1:
            assert torch.equal(got[:, a:b], want[:, a:b])
        else:
            torch.testing.assert_close(got[:, a:b], want[:, a:b], rtol=1e-6,
                                       atol=1e-6 * float(table.abs().max()))
    g4 = gout.reshape(M, L, 1, F)
    for lv0, rows, cw in sections:
        lv1 = lv0 + rows.shape[1]
        local, upd = hash_encode_backward(x, gout, levels, lv0, lv1, T)
        assert local.dtype == torch.int32 and local.shape == rows.shape
        assert torch.equal(local, (rows - lv0 * T).to(torch.int32))
        assert torch.equal(upd, cw[..., None] * g4[:, lv0:lv1])


def test_encode_wrapper_raises_instead_of_falling_back(cuda):
    cfg = HashGridConfig(n_levels=4, log2_hashmap_size=10, base_resolution=4)
    levels = encoding.level_table(cfg)
    T = cfg.table_size
    x = torch.rand((64, 3), device=cuda)
    table = torch.rand((4 * T, 2), device=cuda)
    gout = torch.rand((64, 8), device=cuda)
    before = (hash_encode_forward.launches, hash_encode_backward.launches)
    with pytest.raises(ValueError):
        hash_encode_forward(torch.rand((3, 64), device=cuda).T, table, levels, T)
    with pytest.raises(TypeError):
        hash_encode_forward(x.double(), table, levels, T)
    with pytest.raises(TypeError):
        hash_encode_forward(x, table.to(torch.bfloat16), levels, T)
    with pytest.raises(ValueError):
        hash_encode_forward(x, torch.rand((4 * T, 3), device=cuda), levels, T)
    with pytest.raises(ValueError):
        hash_encode_backward(x, gout[:, :6], levels, 0, 4, T)
    with pytest.raises(ValueError):
        hash_encode_backward(x, torch.rand((16, 64), device=cuda).T, levels, 0, 4, T)
    with pytest.raises(TypeError):     # through the encode: no plain fallback
        encoding.hash_grid_encode({"table": table.to(torch.bfloat16)}, x, cfg,
                                  custom_bwd=True)
    assert (hash_encode_forward.launches, hash_encode_backward.launches) == before


def test_encode_dispatch_moves_launches_and_counters(cuda):
    """On the card: the custom backward and a call without gradient
    launch the kernel; autograd through the gather does not.  The
    counters count every encode's samples and the kernel's."""
    from stable_nerf_tpu_torch.utils import profiling

    cfg = HashGridConfig(n_levels=4, log2_hashmap_size=10, base_resolution=4)
    M = 1000
    x = torch.rand((M, 3), device=cuda)
    table = torch.rand((4 * cfg.table_size, 2), device=cuda)

    def run(custom_bwd, grad):
        t = table.clone().requires_grad_(grad)
        before = (hash_encode_forward.launches, hash_encode_backward.launches)
        profiling.reset_spans()
        with profiling.tracing():
            with torch.set_grad_enabled(grad):
                out = encoding.hash_grid_encode({"table": t}, x, cfg, custom_bwd=custom_bwd)
            if grad:
                out.sum().backward()
            counts = profiling.counters()
        profiling.reset_spans()
        return ((hash_encode_forward.launches - before[0],
                 hash_encode_backward.launches - before[1]),
                counts.get("nerf.encode_samples"), counts.get("nerf.encode_kernel_samples"))

    assert run(True, True) == ((1, 1), M, M)
    assert run(True, False) == ((1, 0), M, M)
    assert run(False, False) == ((1, 0), M, M)
    assert run(False, True) == ((0, 0), M, None)


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


GRAPH_STEPS = 3


def _tiny_serving(cuda):
    """test_inference_step_on_card_matches_cpu's tiny configuration on the
    card: (cfg, params, grid, two requests of 2 scenes each, as (batch,
    draws) pairs with other scenes and draws)."""
    from stable_nerf_tpu_torch.config import NeRFConfig, SDConfig, TrainConfig
    from stable_nerf_tpu_torch.data.rays import get_rays, rand_poses
    from stable_nerf_tpu_torch.models.diffusion.sd_network import (
        SDNetworkConfig, init_ip_from_unet, sd_network_init)
    from stable_nerf_tpu_torch.models.diffusion.unet import tiny_unet_config
    from stable_nerf_tpu_torch.models.diffusion.vae import VAEConfig
    from stable_nerf_tpu_torch.models.nerf.grid import grid_init
    from stable_nerf_tpu_torch.models.nerf.network import nerf_init
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
    requests = []
    for _ in range(2):
        rt = get_rays(rand_poses(g, 2, radius=2.0), intr, 16, 16)
        rr = get_rays(rand_poses(g, 2, radius=2.0), intr, 16, 16)
        batch = {"target_image": torch.rand((2, 3, 32, 32), generator=g) * 2 - 1,
                 "reference_image": torch.rand((2, 3, 32, 32), generator=g) * 2 - 1,
                 "target_rays_o": rt["rays_o"], "target_rays_d": rt["rays_d"],
                 "reference_rays_o": rr["rays_o"], "reference_rays_d": rr["rays_d"]}
        draws = {"vae_eps": torch.randn((2, 4, 16, 16), generator=g),
                 "init_latents": torch.randn((2, 4, 16, 16), generator=g)}
        requests.append(({k: v.to(cuda) for k, v in batch.items()},
                         {k: v.to(cuda) for k, v in draws.items()}))
    return (cfg, tree_map(lambda x: x.to(cuda), params),
            type(grid)(*(t.to(cuda) for t in grid)), requests)


def _card_step(cfg, cuda, monkeypatch, graph: bool, **kw):
    """The tiny inference step on the card, on the DDIM graph's path or,
    with ``graph`` False, on the eager loop."""
    from stable_nerf_tpu_torch.models.diffusion.scheduler import DDIMScheduler
    from stable_nerf_tpu_torch.training import inference

    with monkeypatch.context() as m:
        if not graph:
            m.setattr(inference, "ddim_graph_eligible", lambda *a, **k: False)
        return inference.make_inference_step(
            cfg, DDIMScheduler.create(cfg.sd.scheduler, device=cuda), GRAPH_STEPS,
            compute_dtype=torch.float32, device=cuda, **kw)


def _assert_same_request(got, want, atol=1e-6):
    assert got.keys() == want.keys()
    for k in want:
        if k == "ip_attn_maps":
            assert len(got[k]) == len(want[k]) > 0
            for a, b in zip(got[k], want[k]):
                assert float((a - b).abs().max()) <= atol, k
        else:
            assert float((got[k] - want[k]).abs().max()) <= atol, k


@pytest.mark.parametrize("guidance", [1.0, 3.0])
def test_ddim_graph_serves_as_the_eager_loop(cuda, monkeypatch, guidance):
    """Two requests with other scenes and draws through the graph: one
    capture, every step a replay, each result the eager loop's within 1e-6
    (the same kernels on the same inputs)."""
    from stable_nerf_tpu_torch.utils import profiling

    cfg, params, grid, requests = _tiny_serving(cuda)
    graph = _card_step(cfg, cuda, monkeypatch, True, guidance_scale=guidance)
    eager = _card_step(cfg, cuda, monkeypatch, False, guidance_scale=guidance)
    profiling.reset_spans()
    with profiling.tracing():
        got = [graph(params, grid, b, draws=d) for b, d in requests]
    counts = profiling.counters()
    profiling.reset_spans()
    assert counts["infer.ddim_graph_captures"] == 1
    assert counts["infer.ddim_graph_replays"] == counts["infer.ddim_steps"] == 2 * GRAPH_STEPS
    for (b, d), out in zip(requests, got):
        _assert_same_request(out, eager(params, grid, b, draws=d))


def test_ddim_graph_is_captured_again_for_a_new_weight_leaf(cuda, monkeypatch):
    from stable_nerf_tpu_torch.utils import profiling

    cfg, params, grid, requests = _tiny_serving(cuda)
    graph = _card_step(cfg, cuda, monkeypatch, True)
    eager = _card_step(cfg, cuda, monkeypatch, False)
    b, d = requests[0]
    before = graph(params, grid, b, draws=d)["denoised_image"]
    unet = dict(params["sd"]["unet"])
    unet["conv_out"] = {**unet["conv_out"], "bias": unet["conv_out"]["bias"] + 0.5}
    swapped = {**params, "sd": {**params["sd"], "unet": unet}}
    profiling.reset_spans()
    with profiling.tracing():
        got = graph(swapped, grid, b, draws=d)
    counts = profiling.counters()
    profiling.reset_spans()
    assert counts["infer.ddim_graph_captures"] == 1
    assert counts["infer.ddim_graph_replays"] == GRAPH_STEPS
    _assert_same_request(got, eager(swapped, grid, b, draws=d))
    assert float((got["denoised_image"] - before).abs().max()) > 1e-3


def test_ddim_graph_replays_show_in_the_profilers_trace(cuda, monkeypatch, tmp_path):
    """The device trace of a request sees the replayed kernels, as it sees
    the eager loop's: device_idle.serve and the breakdown read it."""
    from stable_nerf_tpu_torch.utils.profiling import (chrome_trace_intervals, device_time,
                                                       trace)

    cfg, params, grid, requests = _tiny_serving(cuda)
    b, d = requests[0]
    steps = {"graph": _card_step(cfg, cuda, monkeypatch, True),
             "eager": _card_step(cfg, cuda, monkeypatch, False)}
    seen = {}
    for name, step in steps.items():
        step(params, grid, b, draws=d)              # the graph is captured here
        torch.cuda.synchronize()
        with trace(str(tmp_path), name):
            step(params, grid, b, draws=d)
            torch.cuda.synchronize()
        seen[name] = device_time(chrome_trace_intervals(str(tmp_path / f"{name}.json")))
    print("device operations of a traced request, graph / eager:",
          seen["graph"]["launches"], seen["eager"]["launches"])
    assert seen["graph"]["busy_ms"] > 0
    assert seen["graph"]["launches"] >= 0.9 * seen["eager"]["launches"]


def test_ddim_graph_keeps_the_attention_maps(cuda, monkeypatch):
    """Under capture_attn_maps the final step runs eagerly: the maps and the
    image are the eager loop's."""
    from stable_nerf_tpu_torch.utils import profiling

    cfg, params, grid, requests = _tiny_serving(cuda)
    graph = _card_step(cfg, cuda, monkeypatch, True, capture_attn_maps=True)
    eager = _card_step(cfg, cuda, monkeypatch, False, capture_attn_maps=True)
    b, d = requests[1]
    profiling.reset_spans()
    with profiling.tracing():
        got = graph(params, grid, b, draws=d)
    counts = profiling.counters()
    profiling.reset_spans()
    assert counts["infer.ddim_graph_replays"] == GRAPH_STEPS - 1
    assert counts["infer.ddim_steps"] == GRAPH_STEPS
    _assert_same_request(got, eager(params, grid, b, draws=d))


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


def _tiny_sdxl_dir(root):
    """A tiny SDXL directory (the --tiny U-Net and VAE, two tiny text
    towers in SDXL's head counts), float16, written by the port's writer."""
    import chip_smoke
    from stable_nerf_tpu_torch import train as cli
    from stable_nerf_tpu_torch.models.diffusion import clip_text, weights
    from stable_nerf_tpu_torch.models.diffusion.unet import unet_init
    from stable_nerf_tpu_torch.models.diffusion.vae import vae_init

    cfg = cli.build_config(cli.build_parser().parse_args(
        ["--tiny", "--image-size", "32", "--latent-size", "16"]))
    g = torch.Generator().manual_seed(7)
    towers = (clip_text.CLIPTextConfig(hidden_size=24, num_layers=12, intermediate_size=16),
              clip_text.CLIPTextConfig(hidden_size=40, num_layers=32, num_heads=20,
                                       intermediate_size=16, hidden_act="gelu",
                                       projection_dim=32, pad_token_id=0))
    chip_smoke.write_sdxl_checkpoint(str(root), {
        "unet": weights.export_unet_state_dict(unet_init(g, cfg.sd.unet, with_ip=False)),
        "vae": weights.export_vae_state_dict(vae_init(g, cfg.sd.vae)),
        "text_encoder": chip_smoke.clip_text_state_dict(
            clip_text.clip_text_init(8, towers[0], device="cpu")),
        "text_encoder_2": chip_smoke.clip_text_state_dict(
            clip_text.clip_text_init(9, towers[1], device="cpu"))}, dtype=torch.float16)
    return cfg, towers


def test_load_sdxl_onto_the_card_equals_the_cpu(cuda, tmp_path):
    """load_sdxl of a tiny float16 directory straight onto the card: every
    leaf float32, on the card, equal to the CPU load bit for bit."""
    from stable_nerf_tpu_torch.models.diffusion.weights import load_sdxl
    from stable_nerf_tpu_torch.utils.tree import tree_leaves

    cfg, towers = _tiny_sdxl_dir(tmp_path)
    kw = dict(unet_cfg=cfg.sd.unet, vae_cfg=cfg.sd.vae, text_cfg_1=towers[0],
              text_cfg_2=towers[1])
    on_card = load_sdxl(str(tmp_path), **kw)
    on_cpu = load_sdxl(str(tmp_path), device="cpu", **kw)
    assert set(on_card) == {"vae", "unet", "text_encoder", "text_encoder_2"}
    a, b = tree_leaves(on_card), tree_leaves(on_cpu)
    assert len(a) == len(b) > 100
    for x, y in zip(a, b):
        assert x.is_cuda and x.dtype == torch.float32 and torch.equal(x.cpu(), y)


def test_text_towers_on_the_card_match_the_cpu(cuda, tmp_path):
    """The empty-prompt conditioning of two tiny towers on the card against
    the CPU: 1e-5 of each output's scale (float32 sums in other orders
    through 12 and 32 layers)."""
    from stable_nerf_tpu_torch.models.diffusion.clip_text import make_empty_prompt_conditioning
    from stable_nerf_tpu_torch.models.diffusion.weights import load_sdxl
    from stable_nerf_tpu_torch.utils.device import disable_tf32

    disable_tf32()
    cfg, towers = _tiny_sdxl_dir(tmp_path)
    kw = dict(unet_cfg=cfg.sd.unet, vae_cfg=cfg.sd.vae, text_cfg_1=towers[0],
              text_cfg_2=towers[1])
    card = load_sdxl(str(tmp_path), **kw)
    cpu = load_sdxl(str(tmp_path), device="cpu", **kw)
    got = make_empty_prompt_conditioning(card["text_encoder"], card["text_encoder_2"])
    want = make_empty_prompt_conditioning(cpu["text_encoder"], cpu["text_encoder_2"])
    for x, y in zip(got, want):
        assert x.is_cuda and x.shape == y.shape
        assert float((x.cpu() - y).abs().max()) <= 1e-5 * float(y.abs().max())


def test_native_png_decode_on_the_cards_machine(cuda):
    """native/dataloader.cpp builds there (g++, zlib) and decodes the PNGs
    that chip_smoke.py writes, pixel for pixel."""
    import numpy as np

    import chip_smoke
    from stable_nerf_tpu_torch.data import native_loader

    native_loader.build()
    pixels = np.random.default_rng(0).integers(0, 256, (37, 53, 4), dtype=np.uint8)
    data = chip_smoke.png_bytes(pixels)
    assert np.array_equal(native_loader.decode_png_uint8(data), pixels[..., :3])
    assert np.array_equal(native_loader.decode_png_uint8(chip_smoke.png_bytes(
        pixels[..., :3])), pixels[..., :3])


def test_build_initial_params_with_weights_on_the_card_equals_the_cpu(cuda, tmp_path):
    """The overlay copies host leaves (transposed views among them) into
    the card's tensors: every frozen leaf and IP head equal to the CPU
    build's bit for bit; the conditioning (rounded to bf16) within one bf16
    step."""
    import dataclasses

    from stable_nerf_tpu_torch.models.diffusion.weights import load_sdxl
    from stable_nerf_tpu_torch.training.loop import build_initial_params
    from stable_nerf_tpu_torch.utils.device import disable_tf32
    from stable_nerf_tpu_torch.utils.tree import tree_leaves

    disable_tf32()
    cfg, towers = _tiny_sdxl_dir(tmp_path)
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train,
                                                             frozen_dtype="bfloat16"))
    pre = load_sdxl(str(tmp_path), unet_cfg=cfg.sd.unet, vae_cfg=cfg.sd.vae,
                    text_cfg_1=towers[0], text_cfg_2=towers[1], device="cpu")
    on_card = build_initial_params(cfg, 0, 1, pre, log_fn=lambda m: None)
    on_cpu = build_initial_params(cfg, 0, 1, pre, device="cpu", log_fn=lambda m: None)
    for part in ("unet", "vae"):
        a, b = tree_leaves(on_card["sd"][part]), tree_leaves(on_cpu["sd"][part])
        assert len(a) == len(b) > 50
        for x, y in zip(a, b):
            assert x.is_cuda and x.dtype == y.dtype and torch.equal(x.cpu(), y)
    torch.testing.assert_close(on_card["sd"]["add_text_embeds"].float().cpu(),
                               on_cpu["sd"]["add_text_embeds"].float(), rtol=2 ** -7, atol=0)


def test_demo_vae_artifact_loads_onto_the_card(cuda):
    """runs/demo_vae/vae.npz onto the card (the default device): every
    leaf equal to the CPU load bit for bit; its VAE(white) latent
    background within 1e-4 of the CPU's."""
    import os

    from stable_nerf_tpu_torch import train as cli
    from stable_nerf_tpu_torch.models.diffusion.vae import vae_load_npz
    from stable_nerf_tpu_torch.utils.device import disable_tf32
    from stable_nerf_tpu_torch.utils.tree import tree_leaves

    disable_tf32()
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "runs", "demo_vae", "vae.npz")
    on_card, cfg, meta = vae_load_npz(path)
    on_cpu, cfg_cpu, _ = vae_load_npz(path, device="cpu")
    assert cfg == cfg_cpu and meta["latent_size"] == 16
    a, b = tree_leaves(on_card), tree_leaves(on_cpu)
    assert len(a) == len(b) == 156
    for x, y in zip(a, b):
        assert x.is_cuda and torch.equal(x.cpu(), y)
    args = cli.build_parser().parse_args(["--demo", "--vae-checkpoint", path])
    cli.apply_demo_defaults(args)
    jc = cli.build_config(args, cfg)
    card = cli.latent_background(on_card, jc, cuda)
    cpu = cli.latent_background(on_cpu, jc, torch.device("cpu"))
    assert max(abs(p - q) for p, q in zip(card, cpu)) <= 1e-4


def test_fit_step_scatter_matches_plain(cuda):
    """One step of scripts/fit_torch_nerf.py on the card at 32² (512 rays,
    64 march steps: one chunk): the scatter the encode's backward launches,
    its inputs captured, against the plain version on the same inputs; the
    step's loss (float32 compute) within 1e-4 of the same step on the CPU."""
    import chip_smoke
    from stable_nerf_tpu_torch.models.nerf.network import nerf_init
    from stable_nerf_tpu_torch.utils.device import disable_tf32
    from stable_nerf_tpu_torch.utils.tree import tree_map

    disable_tf32()
    fit = chip_smoke.load_script("fit_torch_nerf")
    args = fit.build_parser().parse_args(["--size", "32", "--rays-per-batch", "512",
                                          "--max-steps", "64", "--grid-size", "32",
                                          "--steps", "1"])
    cfg = fit.nerf_config(args)
    captured, wrapper = [], encoding.hash_scatter_add_per_level

    def record(idx, upd, *a, **kw):
        out = wrapper(idx, upd, *a, **kw)
        captured.append((idx, upd, a, kw, out))
        return out

    # one set of weights, grid and draws, made on the CPU and copied to the
    # card: a seed draws other numbers on each device's generator
    cpu = torch.device("cpu")
    params0 = nerf_init(0, cfg, device=cpu)
    state0 = fit.refresh(fit.init_state(cfg, fit.load_views(args, cpu), cpu), params0, cfg,
                         generator=torch.Generator().manual_seed(1))
    g = torch.Generator()
    losses = []
    for dev in (cuda, cpu):
        views = fit.load_views(args, dev)
        params = tree_map(lambda x: x.to(dev, copy=True), params0)
        state = type(state0)(*(x.to(dev) for x in state0))
        opt, sched = fit.make_optimizer(params, args.lr, args.steps, args.lr_decay)
        idx = torch.randint(0, views["pool_o"].shape[0], (512,), generator=g.manual_seed(2))
        perturb = torch.rand(512, generator=g.manual_seed(3))
        before = hash_scatter_add_per_level.launches
        encoding.hash_scatter_add_per_level = record
        try:
            losses.append(float(fit.train_step(
                params, opt, sched, state, views, cfg, idx.to(dev), perturb.to(dev),
                bg=args.bg, max_steps=args.max_steps, loss=args.loss, budget=None,
                compute_dtype=torch.float32)))
        finally:
            encoding.hash_scatter_add_per_level = wrapper
        if dev.type == "cuda":
            assert hash_scatter_add_per_level.launches == before + 1
    idx, upd, a, kw, out = captured[0]
    assert idx.is_cuda and tuple(idx.shape) == (512 * 64, 16, 8)
    plain = hash_scatter_add_plain(idx, upd, a[0] * a[1], False)
    scale = torch.zeros_like(plain).index_add_(0, idx.reshape(-1).long(),
                                               upd.reshape(-1, 2).abs())
    assert float(((out - plain).abs() / scale.clamp_min(1e-30)).max()) <= 1e-5
    assert abs(losses[0] - losses[1]) <= 1e-4 * abs(losses[1])


@pytest.fixture
def small_bench(monkeypatch):
    """bench_torch at a small size through its one size hook: a NeRF with
    a 32³ grid and 4 levels of 2^12 rows, the tiny U-Net at 16² latents."""
    import bench_torch
    from stable_nerf_tpu_torch.config import NeRFConfig
    from stable_nerf_tpu_torch.models.diffusion.unet import tiny_unet_config

    nerf = NeRFConfig(channel_dim=4, grid_size=32, encoding_sigma=HashGridConfig(
        n_levels=4, log2_hashmap_size=12, base_resolution=4))
    monkeypatch.setattr(bench_torch, "_sizes", lambda: (nerf, tiny_unet_config(), 16))
    return bench_torch


def test_bench_nerf_render_on_the_card_at_a_small_size(cuda, small_bench):
    """bench_torch.bench_nerf_render with a small grid and table: a finite
    rate, and 2 scatter launches a step (2^18 samples in chunks of 2^17)."""
    import math

    rays_per_sec, dt, launches = small_bench.bench_nerf_render()
    assert math.isfinite(rays_per_sec) and rays_per_sec > 0 and dt > 0
    assert launches == 2


def test_bench_sd_denoise_on_the_card_at_a_small_size(cuda, small_bench):
    """bench_torch.bench_sd_denoise with the tiny U-Net at 16² latents and
    2 DDIM steps: finite times, the card's name, the analytic count, and
    FlopCounterMode's count of the same forward within 1% of it (norms,
    softmax and pointwise work go uncounted in both)."""
    import math

    from stable_nerf_tpu_torch.models.diffusion.unet import tiny_unet_config
    from stable_nerf_tpu_torch.utils.flops import unet_forward_flops

    (sps, ms, mfu, kind, peak, flops, counted, (hkind, hgb)) = small_bench.bench_sd_denoise(
        n_steps=2, batch=2)
    assert math.isfinite(sps) and ms > 0 and kind == torch.cuda.get_device_name(0)
    assert flops == unet_forward_flops(tiny_unet_config(), 2, 16)
    assert abs(counted - flops) <= 0.01 * flops
    assert hkind == "allocator_peak" and hgb > 0
    assert mfu is None if peak is None else 0 < mfu <= 1


def test_profiling_helpers_read_the_cards_kernels(cuda, tmp_path):
    """utils/profiling.py on a short run: the Chrome trace that ``trace``
    writes gives every kernel, linked to its op (a product may launch more
    than one kernel; tanh launches one), and a busy time within the
    block's wall time."""
    import time

    from stable_nerf_tpu_torch.utils.profiling import (chrome_trace_intervals, device_time,
                                                       measured_hbm_gb, trace)

    a = torch.randn(512, 512, device=cuda)
    torch.cuda.synchronize()
    with trace(str(tmp_path), "short"):
        t = time.perf_counter()
        for _ in range(4):
            a = torch.tanh(a @ a)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    saved = chrome_trace_intervals(str(tmp_path / "short.json"))
    dt = device_time(saved)
    assert dt["launches"] == len(saved) >= 8
    assert 0 < dt["busy_ms"] <= wall_ms
    assert sum(op == "aten::mm" for *_, op in saved) >= 4
    assert sum(op == "aten::tanh" for *_, op in saved) == 4
    assert measured_hbm_gb()[1] > 0
