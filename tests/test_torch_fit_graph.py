"""The NeRF fit step as a CUDA graph (training/fit_graph.py, reached through
scripts/fit_torch_nerf.py::train_step), on the CPU: the rule that decides
when a graph may serve, the capture key, the step counters, the losses
each call returns, and the graph path's bookkeeping with a stand-in for
the captured graph that runs the step it was built from on its own
buffers at every replay.  The graph itself runs only on a card
(tests/test_torch_cuda.py).  This file imports neither JAX nor the JAX
package."""

import dataclasses
import types

import pytest
import torch

import chip_smoke
from stable_nerf_tpu_torch.models.nerf.network import nerf_init
from stable_nerf_tpu_torch.training import fit_graph
from stable_nerf_tpu_torch.utils import profiling
from stable_nerf_tpu_torch.utils.tree import tree_leaves

SEED = 7
CPU = torch.device("cpu")
RAYS = 256
FIT = chip_smoke.load_script("fit_torch_nerf")


@pytest.fixture(autouse=True)
def fresh_spans():
    profiling.reset_spans()
    yield
    profiling.reset_spans()


def _fit(opt_of=None):
    """A fit at 32² (256 rays, 32 march steps), the grid refreshed once:
    (args, cfg, params, opt, sched, state, views, draw)."""
    args = FIT.build_parser().parse_args(["--size", "32", "--rays-per-batch", str(RAYS),
                                          "--max-steps", "32", "--grid-size", "32",
                                          "--steps", "20", "--device", "cpu"])
    cfg = FIT.nerf_config(args)
    views = FIT.load_views(args, CPU)
    params = nerf_init(SEED, cfg, device=CPU)
    g = torch.Generator().manual_seed(SEED)
    state = FIT.refresh(FIT.init_state(cfg, views, CPU), params, cfg, generator=g)
    opt, sched = (opt_of or FIT.make_optimizer)(params, args.lr, args.steps, args.lr_decay)

    def draw():
        return (torch.randint(0, views["pool_o"].shape[0], (RAYS,), generator=g),
                torch.rand(RAYS, generator=g))

    return args, cfg, params, opt, sched, state, views, draw


def _sgd(params, *_):
    return torch.optim.SGD([x.requires_grad_() for x in tree_leaves(params)], lr=0.0), None


def _tensor_lr(params, lr, steps, decay):
    """The Adam and schedule ``make_optimizer`` builds on a card, its lr a
    0-d tensor the schedule fills (``capturable`` itself needs a card)."""
    opt = torch.optim.Adam([x.requires_grad_() for x in tree_leaves(params)],
                           lr=torch.tensor(lr), betas=(0.9, 0.99), eps=1e-15, foreach=False)
    factor = FIT.lr_factor(FIT.TrainConfig(lr_schedule="exponential", lr_decay_steps=steps,
                                           lr_decay_factor=decay))
    return opt, torch.optim.lr_scheduler.LambdaLR(opt, factor)


def _step(fit, cfg=None, budget=None, state=None):
    args, cfg0, params, opt, sched, state0, views, draw = fit
    return FIT.train_step(params, opt, sched, state if state is not None else state0, views,
                          cfg or cfg0, *draw(), bg=args.bg, max_steps=args.max_steps,
                          loss=args.loss, budget=budget, compute_dtype=torch.float32)


# ---------------------------------------------------------------- the rule

def _on(device):
    return types.SimpleNamespace(device=torch.device(device))


def _adam(**kw):
    return torch.optim.Adam([torch.zeros(2, requires_grad=True)], lr=1e-2, **kw)


@pytest.mark.parametrize("opt,budget,custom_bwd,devices,eligible", [
    (_adam(capturable=True), None, True, ["cuda:0", "cuda:0"], True),
    (_adam(capturable=True), None, True, ["cpu", "cpu"], False),          # the CPU
    (_adam(capturable=True), None, True, ["cuda:0", "cpu"], False),       # a tensor elsewhere
    (_adam(capturable=True), None, True, ["cuda:0", "cuda:1"], False),
    (_adam(), None, True, ["cuda:0"], False),                             # not capturable
    (torch.optim.SGD([torch.zeros(2, requires_grad=True)], lr=0.0), None, True,
     ["cuda:0"], False),                                                  # not Adam
    (_adam(capturable=True), 4096, True, ["cuda:0"], False),              # a sample budget
    (_adam(capturable=True), None, False, ["cuda:0"], False),             # autograd's scatter
])
def test_graph_serves_only_a_dense_capturable_adam_step_on_one_card(opt, budget, custom_bwd,
                                                                     devices, eligible):
    tensors = [_on(d) for d in devices]
    assert fit_graph.fit_graph_eligible(opt, budget, custom_bwd, tensors) is eligible


@pytest.mark.parametrize("case", ["cpu", "sgd", "budget"])
def test_ineligible_steps_run_eagerly_and_count_no_replay(case):
    fit = _fit(opt_of=_sgd if case == "sgd" else None)
    with profiling.tracing():
        losses = [_step(fit, budget=4096 if case == "budget" else None) for _ in range(3)]
    c = profiling.counters()
    assert c["fit.steps"] == 3 and c["fit.graph_replays"] == 0
    assert "fit.graph_captures" not in c
    assert all(torch.isfinite(x) for x in losses)
    names = {r["name"] for r in profiling.span_records()}
    assert {"fit.step", "fit.backward", "fit.optimizer"} <= names


def test_make_optimizer_keeps_a_float_lr_on_the_cpu():
    params = nerf_init(SEED, FIT.nerf_config(FIT.build_parser().parse_args([])), device=CPU)
    opt, sched = FIT.make_optimizer(params, 1e-2, 3000, 0.1)
    assert isinstance(opt.param_groups[0]["lr"], float)
    assert not opt.param_groups[0]["capturable"]


def test_schedule_fills_a_tensor_lr_in_place_with_the_float_schedules_values():
    """What the capturable Adam on a card relies on: LambdaLR writes into
    the tensor lr a replay reads, and writes the float schedule's value."""
    p = [torch.zeros(3, requires_grad=True)]
    lr = torch.tensor(1e-2)
    tensor_opt = torch.optim.Adam(p, lr=lr, foreach=False)
    float_opt = torch.optim.Adam([torch.zeros(3, requires_grad=True)], lr=1e-2)
    factor = FIT.lr_factor(FIT.TrainConfig(lr_schedule="exponential", lr_decay_steps=10,
                                           lr_decay_factor=0.1))
    scheds = [torch.optim.lr_scheduler.LambdaLR(o, factor) for o in (tensor_opt, float_opt)]
    for _ in range(5):
        for o, s in zip((tensor_opt, float_opt), scheds):
            o.step()
            s.step()
        assert tensor_opt.param_groups[0]["lr"] is lr
        assert float(lr) == pytest.approx(float_opt.param_groups[0]["lr"], rel=1e-6)


# ------------------------------------------------------------- the losses

def test_each_eager_call_returns_a_loss_of_its_own():
    fit = _fit()
    losses = [_step(fit) for _ in range(3)]
    kept = [float(x) for x in losses]
    assert len({x.data_ptr() for x in losses}) == 3
    _step(fit)
    assert [float(x) for x in losses] == kept


# ---------------------------------------------------------------- the key

def _key(fit, cfg=None, rays=RAYS, state=None, leaves=None, **settings):
    args, cfg0, params, opt, _, state0, views, _ = fit
    s = dict(max_steps=args.max_steps, bg=args.bg, loss=args.loss,
             compute_dtype=torch.bfloat16)
    s.update(settings)
    tensors = [*(leaves or tree_leaves(params)), views["pool_o"], views["pool_d"],
               views["pool_gt"]]
    inputs = ((state or state0).occ, torch.zeros(rays, dtype=torch.int64), torch.zeros(rays))
    return fit_graph.fit_graph_key(opt, (cfg or cfg0, *s.values()), tensors, inputs)


def test_key_ignores_a_new_grid_state_and_the_scheduled_lr():
    fit = _fit(opt_of=_tensor_lr)
    args, cfg, params, opt, sched, state, views, _ = fit
    _step(fit)                                        # the optimizer's state exists
    before = _key(fit)
    fresh = FIT.refresh(state, params, cfg, generator=torch.Generator().manual_seed(1))
    assert fresh.occ.data_ptr() != state.occ.data_ptr()
    assert _key(fit, state=fresh) == before
    sched.step()
    assert _key(fit) == before


@pytest.mark.parametrize("change", ["stochastic", "custom_bwd", "rays", "max_steps", "bg",
                                    "loss", "compute_dtype", "leaf", "optimizer_state",
                                    "float_lr"])
def test_key_changes_with_what_the_capture_reads(change):
    fit = _fit(opt_of=None if change == "float_lr" else _tensor_lr)
    args, cfg, params, opt, sched, _, _, _ = fit
    _step(fit)
    before = _key(fit)
    if change == "stochastic":
        after = _key(fit, cfg=FIT.warmup_config(cfg, args))
    elif change == "custom_bwd":
        after = _key(fit, cfg=dataclasses.replace(cfg, hash_custom_bwd=False))
    elif change == "rays":
        after = _key(fit, rays=RAYS * 2)
    elif change == "max_steps":
        after = _key(fit, max_steps=args.max_steps * 2)
    elif change == "bg":
        after = _key(fit, bg=0.0)
    elif change == "loss":
        after = _key(fit, loss="l1")
    elif change == "compute_dtype":
        after = _key(fit, compute_dtype=torch.float32)
    elif change == "leaf":
        leaves = tree_leaves(params)
        after = _key(fit, leaves=[leaves[0].detach().clone(), *leaves[1:]])
    elif change == "optimizer_state":
        p = opt.param_groups[0]["params"][0]
        opt.state[p]["exp_avg"] = opt.state[p]["exp_avg"].clone()
        after = _key(fit)
    else:                             # a float lr is a constant of the capture
        sched.step()
        after = _key(fit)
    assert after != before


# ------------------------------------------------ the graph path's bookkeeping

class _Replayer:
    def __init__(self, run):
        self.run = run

    def replay(self):
        self.run()


class _StandInGraph(fit_graph.FitGraph):
    """What a captured graph does, on the CPU: the call's own step runs
    once at capture; each replay runs the step again on the buffers and
    writes its loss into one static output."""

    def __init__(self, key_of, fn, opt, inputs):
        self.inputs = [x.clone() for x in inputs]
        self.first = fn(*self.inputs)
        self.loss = torch.empty_like(self.first)
        self.graph = _Replayer(lambda: self.loss.copy_(fn(*self.inputs)))
        self.key = key_of()
        profiling.count("fit.graph_captures", 1)


@pytest.fixture
def stand_in(monkeypatch):
    monkeypatch.setattr(FIT, "fit_graph_eligible", lambda *a, **k: True)
    monkeypatch.setattr(fit_graph, "FitGraph", _StandInGraph)


def test_graph_path_steps_as_the_eager_path_and_counts_one_capture(stand_in, monkeypatch):
    """Six steps, a refresh after the third: the same losses and weights as
    six eager steps from the same weights and draws, one capture, five
    replays, and every loss a tensor of its own."""
    runs = {}
    for graph in (True, False):
        fit = _fit(opt_of=_tensor_lr)
        args, cfg, params, _, _, state, _, _ = fit
        monkeypatch.setattr(FIT, "fit_graph_eligible", lambda *a, **k: graph)
        losses = []
        with profiling.tracing():
            for i in range(6):
                if i == 3:
                    state = FIT.refresh(state, params, cfg,
                                        generator=torch.Generator().manual_seed(2))
                losses.append(_step(fit, state=state))
        runs[graph] = (losses, [x.detach().clone() for x in tree_leaves(params)],
                       profiling.counters())
        profiling.reset_spans()
    (g_losses, g_params, g_counts), (e_losses, e_params, e_counts) = runs[True], runs[False]
    assert len({x.data_ptr() for x in g_losses}) == 6
    assert [float(x) for x in g_losses] == [float(x) for x in e_losses]
    assert all(torch.equal(a, b) for a, b in zip(g_params, e_params))
    assert g_counts == {**g_counts, "fit.steps": 6, "fit.graph_replays": 5,
                        "fit.graph_captures": 1}
    assert e_counts["fit.steps"] == 6 and e_counts["fit.graph_replays"] == 0


def test_a_new_config_is_captured_again_and_a_new_optimizer_has_its_own_graph(stand_in):
    fit = _fit(opt_of=_tensor_lr)
    args, cfg, *_ = fit
    with profiling.tracing():
        _step(fit, cfg=FIT.warmup_config(cfg, args))
        _step(fit, cfg=FIT.warmup_config(cfg, args))
        _step(fit)                                    # --stochastic-until's switch
        _step(fit)
        _step(_fit(opt_of=_tensor_lr))
    c = profiling.counters()
    assert c["fit.graph_captures"] == 3 and c["fit.graph_replays"] == 2
    assert c["fit.steps"] == 5


# ------------------------------------------------- the render path's constants

@pytest.mark.parametrize("values", [2.0 * 3 ** 0.5 / 256, (-1.0, -1.0, -1.0, 1.0, 1.0, 1.0),
                                    [0.4997452, 0.7217328, 0.42126554, 0.56418204]])
def test_device_constant_is_made_once_with_torch_tensors_values(values):
    from stable_nerf_tpu_torch.utils.device import device_constant

    got = device_constant(values, CPU)
    want = torch.tensor(values, dtype=torch.float32)
    assert got.dtype == torch.float32 and torch.equal(got, want)
    assert device_constant(values, "cpu") is got
    again = list(values) if isinstance(values, tuple) else values
    assert device_constant(again, CPU) is got
    assert device_constant(torch.tensor(values).mul(2).tolist(), CPU) is not got
