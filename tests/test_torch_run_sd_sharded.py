"""scripts/run_torch_sd.py --sp/--tp on the CPU, against run_sd.py's
``shard_map`` body.

The sharded denoise (``shard_params`` then ``denoise(..., mesh=)``, the
``--tiny`` stack, 3 DDIM steps, float32) runs on real processes over gloo
(tests/mp_torch_worker.py ``cases``, started by ``train.launch_local``
with a 120 s timeout): tp 2 and sp 2 on a world of 2, sp 2 × tp 2 on a
world of 4.  The JAX side is run_sd.py's body (a jitted ``lax.scan`` of
``sd_forward`` and the DDIM step under ``jax.shard_map`` on a data 1 ×
seq × model mesh of 2 or 4 of conftest's 8 virtual devices) on the same
params, start latents and conditioning, in float32.  Tolerance 1e-4 of the
largest magnitude, as tests/test_torch_sd_scripts.py holds the
single-process denoise: float32 sums in other orders through three U-Net
passes, the sharded heads summed and the ring's online softmax included.

Then the script itself: two processes of ``--tiny --tp 2`` end to end
(rank 0 writes both images), and its refusals of too few cards or
processes (exit 1) before any process group is made.
"""

import concurrent.futures
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from stable_nerf_tpu.config import SDConfig as JSDConfig
from stable_nerf_tpu.models.diffusion import DDIMScheduler as JDDIMScheduler
from stable_nerf_tpu.models.diffusion import sd_network as jsd
from stable_nerf_tpu.models.diffusion import vae as jvae
from stable_nerf_tpu.models.diffusion.unet import tiny_unet_config as jtiny_unet
from stable_nerf_tpu.parallel import make_mesh_3d as jmake_mesh_3d
from stable_nerf_tpu.parallel.sp import serving_param_specs as jserving_param_specs
from stable_nerf_tpu_torch import convert
from stable_nerf_tpu_torch import train as tcli
from stable_nerf_tpu_torch.models.diffusion.sd_network import (init_ip_from_unet,
                                                               sd_network_init)
from test_torch_sd_scripts import TINY_VAE, _scale_close, _script

torch.set_num_threads(2)
WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)), "mp_torch_worker.py")
SCRIPT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "scripts",
                      "run_torch_sd.py")
TIMEOUT_S = 120
STEPS = 3
TOL = 1e-4
# (world, [(case name, sp, tp)]): every case of a world runs in one launch
WORLDS = {2: [("tp2", 1, 2), ("sp2", 2, 1)], 4: [("sp2_tp2", 2, 2)]}


@pytest.fixture(scope="module")
def run_sd():
    return _script("run_torch_sd")


@pytest.fixture(scope="module")
def tiny(run_sd):
    """run_sd.py --tiny's configs, the port's params (seed 0, IP heads from
    to_k/to_v) with their JAX copy, start latents and zero conditioning."""
    cfg = run_sd.network_config(True, 512)
    jcfg = jsd.SDNetworkConfig(sd=JSDConfig(cross_attention_dim=48, latent_size=32,
                                            image_size=64),
                               unet=jtiny_unet(), vae=jvae.VAEConfig(**TINY_VAE))
    params = init_ip_from_unet(sd_network_init(0, cfg, device="cpu"))
    enc = cfg.sd.latent_size
    latents = np.random.default_rng(3).standard_normal((1, 4, enc, enc)).astype(np.float32)
    cond = np.zeros((2, cfg.sd.cond_channels, enc, enc), np.float32)
    return cfg, jcfg, params, convert.params_to_jax(params), latents, cond


def jax_denoise(jparams, latents, cond, jcfg, sp, tp):
    """run_sd.py:112-158 in float32: the denoise scan under shard_map on a
    (data 1 × seq × model) mesh of the first sp·tp devices."""
    mesh = jmake_mesh_3d(sp * tp, sp=sp, tp=tp)
    tp_axis = "model" if tp > 1 else None
    sp_axis = "seq" if sp > 1 else None
    params, pspecs = jserving_param_specs(jax.tree.map(jnp.asarray, jparams), tp,
                                          unet_keys=("unet",))
    scheduler = JDDIMScheduler.create(jcfg.scheduler)
    ts = jnp.asarray(scheduler.timesteps(STEPS))
    cond = jnp.asarray(cond)

    def denoise_local(params, latents):
        def body(x, t):
            eps = jsd.sd_forward(params, x, t, cond, jcfg, compute_dtype=jnp.float32,
                                 tp_axis=tp_axis, sp_axis=sp_axis)
            x, _ = scheduler.step(eps, t, x, num_inference_steps=STEPS)
            return x, None
        out, _ = jax.lax.scan(body, latents, ts)
        return out

    mapped = jax.shard_map(denoise_local, mesh=mesh, in_specs=(pspecs, P()),
                           out_specs=P(), check_vma=False)
    return np.asarray(jax.jit(mapped)(params, jnp.asarray(latents)))


def _launch(world, cases, out):
    out = out / f"world{world}"
    out.mkdir()
    path = out / "inputs.pt"
    torch.save({"cases": cases}, path)
    rc = tcli.launch_local([], world, command=[sys.executable, WORKER, "cases", str(path),
                                               str(out)], timeout=TIMEOUT_S)
    assert rc == 0, f"a cases worker exited {rc}"
    return [torch.load(out / f"cases_{r}.pt", weights_only=False) for r in range(world)]


@pytest.fixture(scope="module")
def sharded(tiny, tmp_path_factory):
    """{case: (each rank's latents, JAX's)}: the launches run while JAX
    compiles its three references."""
    cfg, jcfg, params, jparams, latents, cond = tiny
    out = tmp_path_factory.mktemp("run_sd_sharded")
    with concurrent.futures.ThreadPoolExecutor(len(WORLDS)) as pool:
        launches = {world: pool.submit(_launch, world, [
            {"name": name, "kind": "run_sd", "sp": sp, "tp": tp, "cfg": cfg, "params": params,
             "latents": torch.from_numpy(latents), "cond": torch.from_numpy(cond),
             "steps": STEPS} for name, sp, tp in cases], out)
            for world, cases in WORLDS.items()}
        want = {name: jax_denoise(jparams, latents, cond, jcfg, sp, tp)
                for cases in WORLDS.values() for name, sp, tp in cases}
        ranks = {world: f.result() for world, f in launches.items()}
    return {name: ([r[name].numpy() for r in ranks[world]], want[name])
            for world, cases in WORLDS.items() for name, _, _ in cases}


@pytest.mark.parametrize("name", ["tp2", "sp2", "sp2_tp2"])
def test_sharded_denoise_equals_run_sd_shard_map(sharded, name):
    got, want = sharded[name]
    for rank, latents in enumerate(got):
        assert latents.shape == want.shape, rank
        _scale_close(latents, want, TOL)
    # every rank returns the same latents, bit for bit
    for latents in got[1:]:
        np.testing.assert_array_equal(latents, got[0])


def test_sharded_denoise_equals_the_single_process_one(run_sd, tiny, sharded):
    """The sharded latents against the script's own unsharded denoise on
    the same inputs (the same 1e-4 of the largest magnitude)."""
    from stable_nerf_tpu_torch.models.diffusion.scheduler import DDIMScheduler

    cfg, _, params, _, latents, cond = tiny
    single = run_sd.denoise(params, torch.from_numpy(latents), torch.from_numpy(cond), cfg,
                            DDIMScheduler.create(cfg.scheduler, device="cpu"), STEPS,
                            compute_dtype=torch.float32).numpy()
    for name in ("tp2", "sp2", "sp2_tp2"):
        _scale_close(sharded[name][0][0], single, TOL)


def test_script_serves_sharded_end_to_end(tmp_path):
    """Two processes of the script at ``--tiny --tp 2``: both exit 0, rank 0
    writes the reconstruction and the denoised image."""
    out = tmp_path / "sd"
    rc = tcli.launch_local(["--tiny", "--steps", "2", "--device", "cpu", "--tp", "2",
                            "--out", str(out)], 2, command=[sys.executable, SCRIPT],
                           timeout=TIMEOUT_S)
    assert rc == 0
    assert sorted(n.split(".png")[0] for n in os.listdir(out)) == ["denoised", "vae_recon"]


@pytest.mark.parametrize("argv", [
    ["--tp", "2"],                                           # one CPU process for 2 ranks
    ["--sp", "2", "--tp", "2", "--coordinator", "localhost:1", "--num-processes", "2",
     "--process-id", "0"],                                   # 2 processes for 4 ranks
    ["--tp", "2", "--coordinator", "localhost:1", "--num-processes", "3",
     "--process-id", "0"],                                   # 3 processes: not a multiple
], ids=["one_device", "two_of_four", "not_a_multiple"])
def test_script_refuses_too_few_processes(run_sd, argv, capsys):
    assert run_sd.main([*argv, "--tiny", "--device", "cpu"]) == 1
    assert "needs" in capsys.readouterr().err
