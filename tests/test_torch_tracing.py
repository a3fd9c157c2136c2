"""The port's spans and counters (utils/profiling.py) and the benchmark
readers of them (benchmark/metrics/), on the CPU, with one test for the
card.

A tiny joint step, NeRF fit step and request (chip_smoke.py's dry-run
sizes) record nothing while spans are off; under ``torch.profiler`` each
records every span of its stages, parented as the stages nest, under one
unit, with one ``user_annotation`` event each in the Chrome trace.  The
renderer's counters equal the counts worked out from the march.  This
file imports neither JAX nor the JAX package: its card test runs as

    python -m pytest --noconftest tests/test_torch_tracing.py -m cuda -q
"""

import collections
import contextlib
import json
import threading
import warnings

import pytest
import torch

import chip_smoke
from benchmark.harness import spec
from stable_nerf_tpu_torch.utils import profiling

SEED = 11
CPU = torch.device("cpu")

JOINT = {"joint.step": None, "joint.vae_encode": "joint.step", "joint.render": "joint.step",
         "nerf.march": "joint.render", "nerf.mlp": "joint.render",
         "nerf.hash_encode": "nerf.mlp", "nerf.composite": "joint.render",
         "joint.unet": "joint.step", "joint.backward": "joint.step",
         "nerf.hash_encode_backward": "joint.backward", "joint.optimizer": "joint.step"}
FIT = {"fit.step": None, "nerf.march": "fit.step", "nerf.mlp": "fit.step",
       "nerf.hash_encode": "nerf.mlp", "nerf.composite": "fit.step",
       "fit.backward": "fit.step", "nerf.hash_encode_backward": "fit.backward",
       "fit.optimizer": "fit.step"}
REQUEST = {"infer.request": None, "infer.encode": "infer.request",
           "infer.render": "infer.request", "nerf.march": "infer.render",
           "nerf.mlp": "infer.render", "nerf.hash_encode": "nerf.mlp",
           "nerf.composite": "infer.render", "infer.denoise": "infer.request",
           "infer.ddim_step": "infer.denoise", "infer.decode": "infer.request"}
DDIM_STEPS = 3


@pytest.fixture(autouse=True)
def fresh_spans():
    profiling.reset_spans()
    yield
    profiling.reset_spans()


def _joint(dev, g=None):
    """A tiny joint train step: a call that runs one step, drawing from
    ``g``."""
    from stable_nerf_tpu_torch.training.joint import make_optimizer, make_train_step

    cfg = chip_smoke.tiny_joint_config()
    params, mask, grid, sched, batch = chip_smoke.make_setup(cfg, dev, SEED)
    step = make_train_step(cfg, sched, make_optimizer(cfg.train, params, mask),
                           compute_dtype=torch.float32, device=dev)
    g = g if g is not None else torch.Generator(device=dev).manual_seed(SEED)
    return lambda: step(params, grid, batch, generator=g)


def _request(dev):
    """A tiny request of DDIM_STEPS steps."""
    from stable_nerf_tpu_torch.training.inference import make_inference_step

    cfg = chip_smoke.tiny_joint_config()
    params, _, grid, sched, batch = chip_smoke.make_setup(cfg, dev, SEED)
    serve = make_inference_step(cfg, sched, DDIM_STEPS, compute_dtype=torch.float32,
                                device=dev)
    g = torch.Generator(device=dev).manual_seed(SEED)
    return lambda: serve(params, grid, batch, generator=g)


def _fit(dev):
    """A NeRF fit step of scripts/fit_torch_nerf.py at 32² (256 rays)."""
    from stable_nerf_tpu_torch.models.nerf.network import nerf_init

    fit = chip_smoke.load_script("fit_torch_nerf")
    args = fit.build_parser().parse_args(["--size", "32", "--rays-per-batch", "256",
                                          "--max-steps", "32", "--grid-size", "32",
                                          "--steps", "10", "--device", dev.type])
    cfg = fit.nerf_config(args)
    views = fit.load_views(args, dev)
    params = nerf_init(SEED, cfg, device=dev)
    g = torch.Generator(device=dev).manual_seed(SEED)
    state = fit.refresh(fit.init_state(cfg, views, dev), params, cfg, generator=g)
    opt, sched = fit.make_optimizer(params, args.lr, args.steps, args.lr_decay)

    def step():
        idx = torch.randint(0, views["pool_o"].shape[0], (256,), generator=g, device=dev)
        return fit.train_step(params, opt, sched, state, views, cfg, idx,
                              torch.rand(256, generator=g, device=dev), bg=args.bg,
                              max_steps=args.max_steps, loss="mse", budget=None)

    return step


UNITS = {"joint": (_joint, JOINT), "fit": (_fit, FIT), "request": (_request, REQUEST)}


def test_spans_off_record_nothing():
    units = [make(CPU) for make, _ in UNITS.values()]
    profiling.reset_spans()
    assert not profiling.spans_enabled()
    for unit in units:
        unit()
    assert profiling.span_records() == [] and profiling.counters() == {}


def test_off_spans_are_one_shared_object_and_call_no_record_function(monkeypatch):
    def refuse(*_):
        raise AssertionError("record_function called with spans off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert profiling.span("a") is profiling.span("b")
    with profiling.span("a"):
        profiling.count("c", 1)
    assert profiling.span_records() == [] and profiling.counters() == {}


@pytest.mark.parametrize("unit", sorted(UNITS))
def test_profiled_unit_records_every_span_under_one_unit(tmp_path, unit):
    make, tree = UNITS[unit]
    run = make(CPU)
    run()                                     # warm: the profiled call alone records
    profiling.reset_spans()
    with profiling.trace(str(tmp_path), "unit"):
        run()
    recs = profiling.span_records()
    by_id = {r["id"]: r for r in recs}
    assert {r["name"] for r in recs} == set(tree)
    root = [r for r in recs if r["parent"] is None]
    assert [r["name"] for r in root] == [next(iter(tree))]
    for r in recs:
        assert r["unit"] == root[0]["id"] and r["device_ms"] is None and r["host_ms"] >= 0
        assert (by_id[r["parent"]]["name"] if r["parent"] else None) == tree[r["name"]], r
    if unit == "request":
        assert sum(r["name"] == "infer.ddim_step" for r in recs) == DDIM_STEPS
    with open(tmp_path / "unit.json") as f:
        events = json.load(f)["traceEvents"]
    annotated = collections.Counter(e["name"] for e in events
                                    if e.get("cat") == "user_annotation" and e["name"] in tree)
    assert annotated == collections.Counter(r["name"] for r in recs)


def test_tracing_turns_spans_on_without_a_profiler():
    assert not torch._C._autograd._profiler_enabled()
    with profiling.tracing():
        assert profiling.spans_enabled()
        with profiling.span("outer") as outer:
            with profiling.span("inner"):
                profiling.count("n", 2)
                profiling.count("n", torch.tensor(3))
        with profiling.tracing():             # nests
            pass
        assert profiling.spans_enabled()
    assert not profiling.spans_enabled()
    with profiling.span("after"):
        pass
    inner, out = profiling.span_records()
    assert (inner["name"], out["name"]) == ("inner", "outer")
    assert inner["parent"] == out["id"] == outer.id and inner["unit"] == out["unit"] == out["id"]
    assert out["host_ms"] >= inner["host_ms"] >= 0
    assert profiling.counters() == {"n": 5}


def test_a_span_on_another_thread_takes_the_waiting_threads_span():
    """Autograd's worker thread runs a backward while the caller waits in
    its span: a span opened on a thread with none of its own takes the
    innermost one open elsewhere."""
    with profiling.tracing():
        with profiling.span("caller.backward"):
            t = threading.Thread(target=lambda: profiling.span("worker").__enter__().__exit__())
            t.start()
            t.join(timeout=30)
            assert not t.is_alive()
        with profiling.span("alone"):
            pass
    worker, caller, alone = profiling.span_records()
    assert worker["parent"] == caller["id"] and worker["unit"] == caller["id"]
    assert worker["thread"] != caller["thread"]
    assert alone["parent"] is None and alone["unit"] == alone["id"]


def test_records_are_bounded_and_the_rest_counted(monkeypatch):
    monkeypatch.setattr(profiling, "MAX_SPAN_RECORDS", 3)
    with profiling.tracing():
        for i in range(5):
            with profiling.span(f"s{i}"):
                pass
    assert [r["name"] for r in profiling.span_records()] == ["s0", "s1", "s2"]
    assert profiling.counters() == {"spans.dropped": 2}


def test_data_spans_split_the_prefetch():
    import numpy as np

    from stable_nerf_tpu_torch.data.prefetch import device_prefetch

    batches = ({"x": np.full((2, 3), i, np.float32)} for i in range(3))
    with profiling.tracing():
        got = [float(b["x"][0, 0]) for b in device_prefetch(batches, size=2, device=CPU)]
    assert got == [0.0, 1.0, 2.0]
    recs = profiling.span_records()
    by_id = {r["id"]: r for r in recs}
    # the first next fills the pipeline (2 loads), the second loads the
    # third batch, the third finds the source empty, the fourth ends it
    nexts = [r for r in recs if r["name"] == "data.next"]
    assert len(nexts) == 4 and all(r["parent"] is None for r in nexts)
    children = collections.Counter((r["name"], by_id[r["parent"]]["name"]) for r in recs
                                   if r["parent"])
    assert children == {("data.load", "data.next"): 4, ("data.pin", "data.next"): 3}


@pytest.mark.parametrize("budget", [None, 700])
def test_render_counters_equal_the_marchs_counts(budget):
    from stable_nerf_tpu_torch.models.nerf.renderer import render
    from stable_nerf_tpu_torch.ops.marching import march_rays_lattice
    from stable_nerf_tpu_torch.ops.ray_ops import near_far_from_aabb

    cfg = chip_smoke.tiny_joint_config()
    params, _, grid, _, batch = chip_smoke.make_setup(cfg, CPU, SEED)
    grid = grid._replace(occ=torch.rand(grid.occ.shape,
                                        generator=torch.Generator().manual_seed(1)) < 0.3)
    o, d = batch["target_rays_o"].reshape(-1, 3), batch["target_rays_d"].reshape(-1, 3)
    n = cfg.nerf
    with profiling.tracing(), torch.no_grad():
        render(params["nerf"], grid, o, d, n, max_steps=16, sample_budget=budget)
    b = n.bound
    aabb = torch.tensor([-b, -b, -b, b, b, b], dtype=torch.float32)
    nears, fars = near_far_from_aabb(o, d, aabb, n.min_near)
    valid = march_rays_lattice(o, d, nears, fars, grid.occ, bound=b, cascade=n.cascade,
                               grid_size=n.grid_size, max_steps=16)[3]
    dense = valid.numel()
    assert budget is None or int(valid.sum()) > budget       # the budget drops samples
    want_samples = dense if budget is None else budget
    want_valid = int(valid.sum()) if budget is None else min(int(valid.sum()), budget)
    # the encode counts the samples the network evaluates; on the CPU no
    # kernel serves them
    assert profiling.counters() == {"render.samples": want_samples,
                                    "render.valid_samples": want_valid,
                                    "nerf.encode_samples": want_samples}


# ------------------------------------------------ the benchmark's readers

def _table(device=True):
    """Two joint steps, two fit steps, a request of two DDIM steps and a
    data.next of each step, host ms 3x the device ms; spans outside a unit
    of the reader's root (a refresh's encode, an eval render) are left out
    by the readers."""
    rows, ids = [], iter(range(1, 10 ** 6))

    def add(name, ms, parent=None):
        sid = next(ids)
        unit = parent["unit"] if parent else sid
        rows.append({"name": name, "id": sid, "parent": parent["id"] if parent else None,
                     "unit": unit, "thread": 1, "host_ms": 3.0 * ms,
                     "device_ms": ms if device else None})
        return rows[-1]

    for _ in range(2):
        nxt = add("data.next", 5.0)
        add("data.load", 1.0, nxt)
        add("data.pin", 2.0, nxt)
        step = add("joint.step", 100.0)
        for name, ms in (("joint.vae_encode", 20.0), ("joint.render", 30.0),
                         ("joint.unet", 15.0), ("joint.backward", 25.0),
                         ("joint.optimizer", 5.0)):
            add(name, ms, step)
        fit = add("fit.step", 40.0)
        for _ in range(2):
            add("nerf.hash_encode", 4.0, add("nerf.mlp", 6.0, fit))
            add("nerf.hash_encode_backward", 5.0, add("fit.backward", 10.0, fit))
    refresh = add("grid.refresh", 50.0)
    add("nerf.hash_encode", 99.0, refresh)
    add("joint.vae_encode", 99.0)                      # an eval step's, no joint.step
    req = add("infer.request", 300.0)
    den = add("infer.denoise", 200.0, req)
    add("infer.ddim_step", 90.0, den)
    add("infer.ddim_step", 110.0, den)
    return rows


READINGS = {"vae_encode_ms.train": 20.0, "nerf_render_ms.train": 30.0,
            "unet_forward_ms.train": 15.0, "backward_ms.train": 25.0,
            "optimizer_ms.train": 5.0, "host_enqueue_ms.train": 300.0,
            "batch_pin_ms.train": 6.0, "valid_sample_share.train": 25.0,
            "ddim_step_device_ms.serve": 100.0, "ddim_step_host_ms.serve": 300.0,
            "hash_encode_ms.fit": 18.0, "hash_encode_ms.fit_stochastic": 18.0,
            "host_enqueue_ms.fit_stochastic": 120.0}


@pytest.mark.parametrize("name", sorted(READINGS))
def test_reader_reads_the_span_table(monkeypatch, name):
    entry = [m for m in spec.benchmark()["per_layer"] if m["name"] == name]
    assert len(entry) == 1 and entry[0]["source"] in ("program_span", "program_counter")
    read = spec.metric_reader(name)
    run = {"trace": {"units": 2}}
    counts = {"render.samples": 400, "render.valid_samples": 100}
    monkeypatch.setattr(profiling, "span_records", _table)
    monkeypatch.setattr(profiling, "counters", lambda: dict(counts))
    assert read(run) == pytest.approx(READINGS[name])
    assert read({"trace": None}) is None                     # an untraced run
    monkeypatch.setattr(profiling, "span_records", lambda: _table(device=False))
    counts.clear()
    assert read(run) is None                                 # the CPU's table, or none


@pytest.mark.parametrize("counts,share", [
    ({"infer.ddim_steps": 50, "infer.ddim_graph_replays": 50}, 100.0),
    ({"infer.ddim_steps": 50, "infer.ddim_graph_replays": 49,
      "infer.ddim_graph_captures": 1}, 98.0),
    ({"infer.ddim_steps": 50, "infer.ddim_graph_replays": 0}, 0.0),
    ({"infer.ddim_steps": 50}, None),                  # a program that counts no replays
    ({"render.samples": 400, "render.valid_samples": 100}, None),    # nor steps
])
def test_ddim_graph_share_reads_the_step_counters(monkeypatch, counts, share):
    entry = [m for m in spec.benchmark()["per_layer"] if m["name"] == "ddim_graph_share.serve"]
    assert len(entry) == 1 and entry[0]["source"] == "program_counter"
    assert entry[0]["moves"] == "request_ms" and entry[0]["workloads"] == ["sdxl_ngp.serve"]
    read = spec.metric_reader("ddim_graph_share.serve")
    monkeypatch.setattr(profiling, "counters", lambda: dict(counts))
    assert read({"trace": {"units": 1}}) == (None if share is None else pytest.approx(share))
    assert read({"trace": None}) is None                      # an untraced run
    monkeypatch.delattr(profiling, "span_records")
    assert read({"trace": {"units": 1}}) is None              # a program without counters


def test_readers_give_none_on_a_program_without_spans(monkeypatch):
    monkeypatch.delattr(profiling, "span_records")
    for name in READINGS:
        assert spec.metric_reader(name)({"trace": {"units": 2}}) is None, name


# ----------------------------------------------------------------- the card

@pytest.mark.cuda
def test_card_spans_time_the_device_and_add_no_synchronize():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the spans' device times come from CUDA events")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    step = _joint(dev, g.manual_seed(SEED))
    for _ in range(3):
        step()
    torch.cuda.synchronize()

    def synchronizing_sites(on):
        """(file, line) of each synchronizing call in one step, on the same
        draws every time."""
        g.manual_seed(SEED + 1)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                with profiling.tracing() if on else contextlib.nullcontext():
                    step()
            finally:
                torch.cuda.set_sync_debug_mode("default")
        return collections.Counter((w.filename, w.lineno) for w in caught
                                   if "synchroniz" in str(w.message))

    profiling.reset_spans()
    runs = [(on, synchronizing_sites(on)) for on in (False, True, False, True)]
    print("synchronizing calls a tiny joint step:", runs)
    offs = [c for on, c in runs if not on]
    assert profiling.span_records() and all(c in offs for on, c in runs if on)
    assert not any("profiling" in f for _, c in runs for f, _ in c)
    assert not any(f.endswith("encoding.py") for _, c in runs for f, _ in c)
    profiling.reset_spans()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]):
        step()
    recs = profiling.span_records()
    assert {r["name"] for r in recs} == set(JOINT)
    by_id = {r["id"]: r for r in recs}
    backward = [r for r in recs if r["name"] == "nerf.hash_encode_backward"]
    assert backward and all(by_id[r["parent"]]["name"] == "joint.backward" for r in backward)
    assert backward[0]["thread"] != by_id[backward[0]["parent"]]["thread"]   # autograd's
    assert all(r["device_ms"] is not None and r["device_ms"] >= 0 for r in recs)
    for parent in recs:
        kids = [r["device_ms"] for r in recs if r["parent"] == parent["id"]]
        assert parent["device_ms"] + 0.5 >= sum(kids), parent["name"]
