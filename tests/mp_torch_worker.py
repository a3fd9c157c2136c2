"""One rank of the port's multi-process tests (tests/test_torch_parallel.py,
tests/test_torch_tp.py, tests/test_torch_sp.py, tests/test_torch_run_sd_sharded.py).

Not a pytest module.  Started by ``stable_nerf_tpu_torch.train.launch_local``,
which appends ``--coordinator HOST:PORT --num-processes N --process-id I``.
Imports torch and the port only, never JAX.

  python tests/mp_torch_worker.py steps INPUTS OUTDIR <coordinator flags>
      the least-squares data-parallel step, process_shard_indices,
      replicate and barrier, and one data-parallel and one fully-sharded
      joint train step on INPUTS (torch.save of the test's weights, batch
      and per-rank draws); writes OUTDIR/steps_<rank>.pt.
  python tests/mp_torch_worker.py cli OUTDIR <train.py flags> <coordinator flags>
      ``stable_nerf_tpu_torch.train.main`` on the flags; writes the whole
      params and the grid it returns to OUTDIR/cli_<rank>.pt.
  python tests/mp_torch_worker.py cases INPUTS OUTDIR <coordinator flags>
      the tensor- and sequence-parallel cases of INPUTS["cases"]
      (tests/test_torch_tp.py, tests/test_torch_sp.py,
      tests/test_torch_run_sd_sharded.py), each on a mesh of
      its own sizes over this world; writes OUTDIR/cases_<rank>.pt.
"""

import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def _flag(argv, name):
    return argv[argv.index(name) + 1]


def _mesh(argv):
    from stable_nerf_tpu_torch.parallel import make_mesh

    return make_mesh("cpu", init_method=f"tcp://{_flag(argv, '--coordinator')}",
                     rank=int(_flag(argv, "--process-id")),
                     world_size=int(_flag(argv, "--num-processes")))


def least_squares(mesh):
    """tests/test_joint_training.py's least-squares step at this world: the
    gradient must be the global batch's mean gradient, not the sum."""
    import torch

    from stable_nerf_tpu_torch.parallel import (all_reduce_mean_, make_parallel_train_step,
                                                shard_batch)

    x = torch.arange(32, dtype=torch.float32).reshape(8, 4) / 10.0
    batch = shard_batch({"x": x, "y": torch.ones(8)}, mesh)
    w = torch.zeros(4, requires_grad=True)

    def step_fn(params, grid_state, batch, generator=None, draws=None):
        loss = torch.mean((batch["x"] @ params["w"] - batch["y"]) ** 2)
        loss.backward()
        grad = params["w"].grad
        all_reduce_mean_([grad], mesh)
        loss = loss.detach().reshape(1)
        all_reduce_mean_([loss], mesh)
        with torch.no_grad():
            params["w"] -= 0.1 * grad
        return {"loss": loss[0], "grad": grad.clone()}

    step = make_parallel_train_step(step_fn, mesh)
    m = step({"w": w}, None, batch, generator=torch.Generator().manual_seed(0))
    return {"w": w.detach().clone(), **m}


def collectives(mesh, outdir):
    import torch

    from stable_nerf_tpu_torch.parallel import (barrier, fold_generator,
                                                process_shard_indices, replicate)

    tree = {"a": torch.full((3,), float(mesh.rank + 1)),
            "b": [torch.tensor(mesh.rank, dtype=torch.int32),
                  torch.tensor([mesh.rank == 0, True])],
            "c": torch.arange(6.0).reshape(2, 3).t() * (mesh.rank + 1)}
    replicate(tree, mesh)
    # barrier: rank 1 writes a file just before it, rank 0 reads it just after
    mark = os.path.join(outdir, "barrier_mark")
    if mesh.rank == 1:
        time.sleep(0.5)
        with open(mark, "w") as f:
            f.write("1")
    barrier(mesh)
    return {"shard": process_shard_indices(10, mesh).tolist(),
            "shard_uneven": process_shard_indices(11, mesh).tolist(),
            "replicated": tree, "mark_seen": os.path.exists(mark),
            "folded": torch.rand(4, generator=fold_generator(
                torch.Generator().manual_seed(5), mesh.rank))}


def joint_steps(mesh, inputs):
    """One data-parallel and one fully-sharded joint train step from the
    same weights, each rank on its rows of the global batch and the draws
    the test gives it."""
    import torch

    from stable_nerf_tpu_torch.models.diffusion.scheduler import DDIMScheduler
    from stable_nerf_tpu_torch.parallel import (make_parallel_train_step,
                                                place_joint_for_fsdp, shard_batch)
    from stable_nerf_tpu_torch.training import joint as tj
    from stable_nerf_tpu_torch.utils.tree import partition, tree_leaves, tree_map

    cfg, grid = inputs["cfg"], inputs["grid"]
    batch = shard_batch(inputs["batch"], mesh)
    sched = DDIMScheduler.create(cfg.sd.scheduler, device="cpu")
    out = {}
    for mode in ("dp", "fsdp"):
        params = tree_map(torch.clone, inputs["params"])
        mask = tj.joint_trainable_mask(params)
        layout = None
        sd_bytes = sum(x.numel() * x.element_size() for x in tree_leaves(params["sd"]))
        if mode == "fsdp":
            params, layout = place_joint_for_fsdp(params, mesh, min_size=inputs["min_size"])
        opt = tj.make_optimizer(cfg.train, params, mask)
        step = make_parallel_train_step(
            tj.make_train_step(cfg, sched, opt, compute_dtype=torch.float32,
                               device="cpu", mesh=mesh, fsdp=layout), mesh)
        m = step(params, grid, batch, draws=inputs[f"draws_{mode}"][mesh.rank])
        rec = {"metrics": {k: float(v) for k, v in m.items()}}
        if layout is not None:
            rec["specs"] = layout.specs()
            rec["sd_bytes_whole"] = sd_bytes
            rec["sd_bytes_resting"] = sum(x.numel() * x.element_size()
                                          for x in tree_leaves(params["sd"]))
            rec["moment_elems"] = sum(v.numel() for s in opt.state.values()
                                      for k, v in s.items() if k == "exp_avg")
            params = layout.gather(params, with_grad=False)
        rec["trainable"] = tree_map(lambda x: None if x is None else x.detach().clone(),
                                    partition(params, mask)[0])
        out[mode] = rec
    return out


def case_unet(case, mesh):
    """The U-Net on the case's mesh: make_tp_unet_apply (no seq axis) or
    make_sp_unet_apply; with ``capture``, unet_apply itself on this rank's
    slices with the maps captured; a ValueError is recorded."""
    import torch

    from stable_nerf_tpu_torch.models.diffusion.unet import unet_apply
    from stable_nerf_tpu_torch.parallel import (make_sp_unet_apply, make_tp_unet_apply,
                                                shard_unet_for_tp)

    x = case["inputs"]
    args = (x["sample"], x["t"], x["ehs"], x["text_embeds"], x["time_ids"])
    data_axis = "data" if case.get("data_axis") else None
    tp_axis = "model" if case["tp"] > 1 else None
    try:
        if case.get("capture"):
            model = mesh.axes["model"] if tp_axis else None
            local = shard_unet_for_tp(case["params"], model) if model else case["params"]
            eps, aux = unet_apply(local, *args[:3], added_text_embeds=args[3],
                                  added_time_ids=args[4], cfg=case["cfg"],
                                  capture_ip_attn_maps=True, tp_axis=model,
                                  sp_axis=mesh.axes["seq"])
            return {"eps": eps, "maps": aux["ip_attn_maps"]}
        if case["sp"] == 1:
            local, fn = make_tp_unet_apply(case["params"], mesh, case["cfg"],
                                           data_axis=data_axis)
        else:
            local, fn = make_sp_unet_apply(case["params"], mesh, case["cfg"],
                                           tp_axis=tp_axis, data_axis=data_axis)
        with torch.no_grad():
            return {"eps": fn(local, *args)}
    except ValueError as e:            # the case asks for the refusal
        return {"error": str(e)}


def case_ring(case, mesh):
    """ring_sdpa on this rank's token block of the case's q, k, v: the
    output block and the gradients of sum(output²) summed over the ranks."""
    import torch

    from stable_nerf_tpu_torch.models.diffusion.nn import ring_sdpa

    seq = mesh.axes["seq"]
    n = case["q"].shape[2] // seq.world
    blk = [t[:, :, seq.rank * n:(seq.rank + 1) * n].clone().requires_grad_(True)
           for t in (case["q"], case["k"], case["v"])]
    out = ring_sdpa(*blk, seq)
    (out.float() ** 2).sum().backward()
    return {"out": out.detach(), "grads": [t.grad for t in blk],
            "hops": mesh.counts.get("ring_hops", 0)}


def case_infer(case, mesh):
    """make_sharded_inference_step at the case's tp and sp, float32, the
    case's draws injected."""
    import torch

    from stable_nerf_tpu_torch.models.diffusion.scheduler import DDIMScheduler
    from stable_nerf_tpu_torch.training.inference import make_sharded_inference_step

    cfg = case["cfg"]
    build = make_sharded_inference_step(
        cfg, DDIMScheduler.create(cfg.sd.scheduler, device="cpu"), case["steps"],
        mesh=mesh, tp=case["tp"], sp=case["sp"], compute_dtype=torch.float32,
        guidance_scale=case["guidance"])
    local, fn = build(case["params"])
    return fn(local, case["grid"], case["batch"], draws=case["draws"])


def case_train(case, mesh):
    """One float32 joint train step on a (data × model) mesh, tensor
    parallel (with ``fsdp``, fully sharded over the data axis too), each
    data rank on its rows of the case's global batch and draws: the
    metrics, the whole updated trainables and (with ``moments``) the AdamW
    moments in the single-device layout."""
    import torch

    from stable_nerf_tpu_torch.models.diffusion.scheduler import DDIMScheduler
    from stable_nerf_tpu_torch.parallel import (make_parallel_train_step,
                                                place_joint_for_fsdp, place_joint_for_tp)
    from stable_nerf_tpu_torch.training import joint as tj
    from stable_nerf_tpu_torch.utils.tree import partition, tree_map

    cfg = case["cfg"]
    data, model = mesh.axes["data"], mesh.axes["model"]
    params = tree_map(torch.clone, case["params"])
    mask = tj.joint_trainable_mask(params, cfg.train.trainable_scope)
    layout = None
    if case.get("fsdp"):
        params, layout = place_joint_for_fsdp(params, data, tp_axis=model,
                                              min_size=case["min_size"])
        tp = layout.tp
    else:
        params, tp = place_joint_for_tp(params, model)
    opt = tj.make_optimizer(cfg.train, params, mask)
    step = make_parallel_train_step(
        tj.make_train_step(cfg, DDIMScheduler.create(cfg.sd.scheduler, device="cpu"), opt,
                           compute_dtype=torch.float32, device="cpu", mesh=data,
                           fsdp=layout, tp_axis=model), data)
    # chip_smoke.py imports torch and the port only
    from chip_smoke import rows_of

    m = step(params, case["grid"], rows_of(case["batch"], data.rank, data.world),
             draws=rows_of(case["draws"], data.rank, data.world))
    rec = {"metrics": {k: float(v) for k, v in m.items()}}
    paths = tj.optimizer_param_paths(params, mask)
    if layout is not None:
        rec["specs"] = layout.specs()
        opt_sd = layout.optimizer_state_dict(opt)
        params = layout.gather(params, with_grad=False)
    else:
        opt_sd = opt.state_dict()
    whole = tp.gather(params)
    rec["trainable"] = tree_map(lambda x: None if x is None else x.detach().clone(),
                                partition(whole, mask)[0])
    if case.get("moments"):
        rec["moments"] = {paths[i]: s["exp_avg"] for i, s in
                          tp.gather_optimizer_state(opt_sd, paths)["state"].items()}
    return rec


def case_run_sd(case, mesh):
    """scripts/run_torch_sd.py's sharded denoise on the case's whole params
    (cut here by its ``shard_params``), start latents and conditioning, in
    float32."""
    import torch

    from chip_smoke import load_script
    from stable_nerf_tpu_torch.models.diffusion.scheduler import DDIMScheduler

    run_sd = load_script("run_torch_sd")
    cfg = case["cfg"]
    local = run_sd.shard_params(case["params"], mesh)
    return run_sd.denoise(local, case["latents"], case["cond"], cfg,
                          DDIMScheduler.create(cfg.scheduler, device="cpu"), case["steps"],
                          compute_dtype=torch.float32, mesh=mesh)


CASES = {"unet": case_unet, "ring": case_ring, "infer": case_infer, "train": case_train,
         "run_sd": case_run_sd}


def cases(inputs):
    """Every case of ``inputs["cases"]`` on a mesh of its sizes over this
    world (each mesh a new set of groups; every rank runs every case)."""
    from stable_nerf_tpu_torch.parallel import make_mesh_3d

    out = {}
    for case in inputs["cases"]:
        mesh = make_mesh_3d("cpu", sp=case["sp"], tp=case["tp"])
        out[case["name"]] = CASES[case["kind"]](case, mesh)
    return out


def main():
    import torch

    torch.set_num_threads(1)
    mode, argv = sys.argv[1], sys.argv[2:]
    if mode == "steps":
        inputs_path, outdir = argv[0], argv[1]
        mesh = _mesh(argv)
        inputs = torch.load(inputs_path, weights_only=False)
        result = {"rank": mesh.rank, "world": mesh.world, "backend": mesh.backend,
                  "least_squares": least_squares(mesh),
                  "collectives": collectives(mesh, outdir),
                  **joint_steps(mesh, inputs)}
        torch.save(result, os.path.join(outdir, f"steps_{mesh.rank}.pt"))
        from stable_nerf_tpu_torch.parallel import close_mesh

        close_mesh()
    elif mode == "cases":
        inputs_path, outdir = argv[0], argv[1]
        mesh = _mesh(argv)
        result = {"rank": mesh.rank, **cases(torch.load(inputs_path, weights_only=False))}
        torch.save(result, os.path.join(outdir, f"cases_{mesh.rank}.pt"))
        from stable_nerf_tpu_torch.parallel import close_mesh

        close_mesh()
    elif mode == "cli":
        outdir, flags = argv[0], argv[1:]
        from stable_nerf_tpu_torch import train as cli

        params, grid, history = cli.main(flags)
        rank = int(_flag(flags, "--process-id"))
        torch.save({"params": params, "grid": list(grid), "history": history},
                   os.path.join(outdir, f"cli_{rank}.pt"))
    else:
        raise SystemExit(f"unknown mode {mode!r}")


if __name__ == "__main__":
    main()
