"""The serving path's DDIM step as a CUDA graph (training/inference.py), on
the CPU: the scheduler's table lookup without a host read, the rule that
decides when a graph may serve, the step counters of the eager loop, and
the graph cache's keys, with a stand-in for the captured graph that replays
the step it was built from as a captured graph replays its kernels: on the
weights it saw at capture.  The graph itself runs only on a card
(tests/test_torch_cuda.py).  This file imports neither JAX nor the JAX
package."""

import pytest
import torch

import chip_smoke
from stable_nerf_tpu_torch.config import SchedulerConfig
from stable_nerf_tpu_torch.models.diffusion.scheduler import DDIMScheduler
from stable_nerf_tpu_torch.training import inference
from stable_nerf_tpu_torch.utils import profiling

SEED = 5
CPU = torch.device("cpu")
STEPS = 3


class _IndexedScheduler(DDIMScheduler):
    """The scheduler as it was: the tables indexed by a 0-d tensor."""

    def _lookup(self, t):
        return self.alphas_cumprod[t]


@pytest.mark.parametrize("prediction_type", ["epsilon", "v_prediction"])
def test_scheduler_step_equals_the_indexed_lookup_at_every_timestep(prediction_type):
    s = DDIMScheduler.create(SchedulerConfig(prediction_type=prediction_type), device="cpu")
    old = _IndexedScheduler(*s)
    g = torch.Generator().manual_seed(SEED)
    ts = torch.as_tensor(s.timesteps(50))
    assert int(ts[-1]) - 1000 // 50 < 0              # the last step takes the final alpha
    for t in ts:
        assert t.dim() == 0
        assert torch.equal(s._lookup(t), s.alphas_cumprod[int(t)])
        eps, x = torch.randn((2, 4, 8, 8), generator=g), torch.randn((2, 4, 8, 8), generator=g)
        new = s.step(eps, t, x, num_inference_steps=50)
        want = old.step(eps, t, x, num_inference_steps=50)
        assert all(torch.equal(a, b) for a, b in zip(new, want)), int(t)


def test_lookup_keeps_the_index_shape():
    s = DDIMScheduler.create(device="cpu")
    t = torch.tensor([[1, 981], [501, 0]])
    assert torch.equal(s._lookup(t), s.alphas_cumprod[t])


@pytest.mark.parametrize("device,axes,eligible", [
    ("cuda", {}, True),
    ("cuda", {"tp_axis": object()}, False),
    ("cuda", {"sp_axis": object()}, False),
    ("cuda", {"tp_axis": object(), "sp_axis": object()}, False),
    ("cpu", {}, False),
])
def test_graph_serves_only_on_a_card_without_collectives(device, axes, eligible):
    assert inference.ddim_graph_eligible(torch.device(device), **axes) is eligible


def _serve(capture_attn_maps=False):
    cfg = chip_smoke.tiny_joint_config()
    params, _, grid, sched, batch = chip_smoke.make_setup(cfg, CPU, SEED)
    step = inference.make_inference_step(cfg, sched, STEPS, compute_dtype=torch.float32,
                                         capture_attn_maps=capture_attn_maps, device=CPU)
    draws = {"vae_eps": torch.randn((1, 4, 16, 16), generator=torch.Generator().manual_seed(1)),
             "init_latents": torch.randn((1, 4, 16, 16),
                                         generator=torch.Generator().manual_seed(2))}
    return step, params, grid, batch, draws


@pytest.mark.parametrize("capture_attn_maps", [False, True])
def test_cpu_request_runs_the_eager_loop_and_counts_its_steps(capture_attn_maps):
    step, params, grid, batch, draws = _serve(capture_attn_maps)
    with profiling.tracing():
        out = step(params, grid, batch, draws=draws)
    c = profiling.counters()
    profiling.reset_spans()
    assert c["infer.ddim_steps"] == STEPS
    assert c.get("infer.ddim_graph_replays", 0) == 0
    assert "infer.ddim_graph_captures" not in c
    assert ("ip_attn_maps" in out) is capture_attn_maps


class _StandInGraph(inference._DDIMGraph):
    """What a captured graph does, on the CPU: each replay runs the update
    it was built from, on its own buffers, with the weights it saw."""

    built = []

    def __init__(self, key, update, latents, t, image_embeds):
        self.key, self.update = key, update
        self.x, self.t, self.embeds = latents.clone(), t.clone(), image_embeds.clone()
        profiling.count("infer.ddim_graph_captures", 1)
        _StandInGraph.built.append(self)

    def step(self, t):
        self.t.copy_(t)
        self.x.copy_(self.update(self.x, self.t, self.embeds))
        return self.x


@pytest.fixture
def stand_in(monkeypatch):
    """The graph path on the CPU; returns a switch back to the eager loop."""
    _StandInGraph.built = []
    on = {"graph": True}
    monkeypatch.setattr(inference, "ddim_graph_eligible", lambda *a, **k: on["graph"])
    monkeypatch.setattr(inference, "_DDIMGraph", _StandInGraph)
    yield on
    profiling.reset_spans()


def _eager(serve_args, params, grid, batch, draws, on):
    on["graph"] = False
    step = inference.make_inference_step(*serve_args[0], **serve_args[1])
    on["graph"] = True
    return step(params, grid, batch, draws=draws)


@pytest.mark.parametrize("guidance", [1.0, 3.0])
def test_graph_cache_captures_once_and_follows_the_weights(stand_in, guidance):
    cfg = chip_smoke.tiny_joint_config()
    params, _, grid, sched, batch = chip_smoke.make_setup(cfg, CPU, SEED)
    args = ((cfg, sched, STEPS), {"compute_dtype": torch.float32, "guidance_scale": guidance,
                                  "device": CPU})
    step = inference.make_inference_step(*args[0], **args[1])
    g = torch.Generator().manual_seed(3)
    draws = [{"vae_eps": torch.randn((1, 4, 16, 16), generator=g),
              "init_latents": torch.randn((1, 4, 16, 16), generator=g)} for _ in range(2)]

    def request(d, p=params):
        with profiling.tracing():
            return step(p, grid, batch, draws=d)["denoised_image"]

    def eager(d, p=params):
        return _eager(args, p, grid, batch, d, stand_in)["denoised_image"]

    for d in draws:                            # two requests, one capture
        assert torch.equal(request(d), eager(d))
    c = profiling.counters()
    assert c["infer.ddim_graph_captures"] == 1
    assert c["infer.ddim_graph_replays"] == c["infer.ddim_steps"] == 2 * STEPS

    bias = params["sd"]["unet"]["conv_out"]["bias"]
    with torch.no_grad():                      # in place: the same leaf, read anew
        bias.add_(0.25)
    assert torch.equal(request(draws[0]), eager(draws[0]))
    assert profiling.counters()["infer.ddim_graph_captures"] == 1

    before = request(draws[0])                 # a new leaf: captured again
    sd = dict(params["sd"])
    sd["unet"] = dict(sd["unet"])
    sd["unet"]["conv_out"] = {**sd["unet"]["conv_out"], "bias": bias + 0.5}
    swapped = {**params, "sd": sd}
    got = request(draws[0], swapped)
    assert profiling.counters()["infer.ddim_graph_captures"] == 2
    assert torch.equal(got, eager(draws[0], swapped)) and not torch.equal(got, before)

    batch2 = chip_smoke.make_batch(cfg, CPU, torch.Generator().manual_seed(4), 2)
    d2 = {k: torch.cat([v, v]) for k, v in draws[0].items()}
    with profiling.tracing():                  # another batch: captured again
        step(swapped, grid, batch2, draws=d2)
    assert profiling.counters()["infer.ddim_graph_captures"] == 3
    assert len(_StandInGraph.built) == 3


def test_graph_leaves_the_map_capturing_step_eager(stand_in):
    cfg = chip_smoke.tiny_joint_config()
    params, _, grid, sched, batch = chip_smoke.make_setup(cfg, CPU, SEED)
    args = ((cfg, sched, STEPS), {"compute_dtype": torch.float32, "capture_attn_maps": True,
                                  "device": CPU})
    d = {"vae_eps": torch.randn((1, 4, 16, 16), generator=torch.Generator().manual_seed(1)),
         "init_latents": torch.randn((1, 4, 16, 16), generator=torch.Generator().manual_seed(2))}
    step = inference.make_inference_step(*args[0], **args[1])
    with profiling.tracing():
        out = step(params, grid, batch, draws=d)
    c = profiling.counters()
    assert c["infer.ddim_graph_replays"] == STEPS - 1 and c["infer.ddim_steps"] == STEPS
    want = _eager(args, params, grid, batch, d, stand_in)
    assert torch.equal(out["denoised_image"], want["denoised_image"])
    assert len(out["ip_attn_maps"]) == len(want["ip_attn_maps"]) > 0
    assert all(torch.equal(a, b) for a, b in zip(out["ip_attn_maps"], want["ip_attn_maps"]))
