"""One rank of the port's multi-process tests (tests/test_torch_parallel.py).

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
