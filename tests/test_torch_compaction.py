"""The port's sample compaction (ops/compaction.py) and budget policies
(training/joint.py) against the JAX package's on the CPU.

Masks and payloads come from a numpy seed and go to both packages.  The
plan is integer arithmetic, and gather and scatter only move values, so
everything here is exact; the budget policies are Python arithmetic and
must return the same integers (or None).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stable_nerf_tpu.config import TrainConfig as JTrainConfig
from stable_nerf_tpu.ops import compaction as jcomp
from stable_nerf_tpu.training import joint as jj
from stable_nerf_tpu_torch import convert
from stable_nerf_tpu_torch.ops import compaction as tcomp
from stable_nerf_tpu_torch.training import joint as tj

N, K = 37, 24


def _mask(kind, rng):
    if kind == "all_invalid":
        return np.zeros((N, K), bool)
    if kind == "all_valid":
        return np.ones((N, K), bool)
    return rng.random((N, K)) < 0.3      # ~266 valid of 888


# under budget, over budget (binding), exactly the valid count, budget >= NK
@pytest.mark.parametrize("kind,budget", [
    ("sparse", 512), ("sparse", 100), ("sparse", 1), ("all_invalid", 64),
    ("all_valid", 300), ("all_valid", N * K), ("sparse", N * K + 50)])
def test_compact_plan_gather_scatter_match_jax(rng, kind, budget):
    valid = _mask(kind, rng)
    jplan = jcomp.compact_plan(jnp.asarray(valid), budget)
    tplan = tcomp.compact_plan(torch.from_numpy(valid), budget)
    assert tplan.src_idx.dtype == torch.int32 and tplan.n_valid.dtype == torch.int32
    for got, want in zip(tplan, jplan):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int(tplan.n_valid) == min(int(valid.sum()), budget)

    x3 = rng.standard_normal((N, K, 3)).astype(np.float32)
    x1 = rng.standard_normal((N, K)).astype(np.float32)
    xflat = rng.standard_normal((N * K,)).astype(np.float32)
    for x in (x3, x1, xflat):
        packed = tcomp.gather_compact(tplan, torch.from_numpy(x))
        np.testing.assert_array_equal(
            packed.numpy(), np.asarray(jcomp.gather_compact(jplan, jnp.asarray(x))))
    v = rng.standard_normal((budget, 4)).astype(np.float32)
    for vals in (v, v[:, 0].copy()):
        back = tcomp.scatter_back(tplan, torch.from_numpy(vals), N * K)
        np.testing.assert_array_equal(
            back.numpy(), np.asarray(jcomp.scatter_back(jplan, jnp.asarray(vals), N * K)))


def test_compaction_round_trip_is_step_major_and_differentiable(rng):
    """Over budget, the kept samples are the first ``budget`` valid ones in
    (step, ray) order; values survive gather → scatter on exactly those, and
    the gradient reaches exactly those."""
    valid = _mask("sparse", rng)
    budget = 100
    plan = tcomp.compact_plan(torch.from_numpy(valid), budget)
    order = np.flatnonzero(valid.T.reshape(-1))[:budget]          # (k, n) order
    kept = np.zeros(N * K, bool)
    kept[(order % N) * K + order // N] = True
    np.testing.assert_array_equal(plan.new_valid.numpy().reshape(-1), kept)
    x = torch.from_numpy(rng.standard_normal((N, K, 2)).astype(np.float32))
    x.requires_grad_(True)
    back = tcomp.scatter_back(plan, tcomp.gather_compact(plan, x) * 2.0, N * K)
    np.testing.assert_array_equal(back.detach().numpy(),
                                  (x.detach().numpy().reshape(-1, 2) * 2.0)
                                  * kept[:, None])
    back.sum().backward()
    np.testing.assert_array_equal(x.grad.numpy().reshape(-1, 2),
                                  2.0 * np.repeat(kept[:, None], 2, 1))


@pytest.mark.parametrize("occ", [0.0, 1e-4, 0.004, 0.01, 0.03, 0.125, 0.3, 0.6,
                                 2 / 3, 0.9, 1.0])
@pytest.mark.parametrize("n_rays,max_steps", [(8192, 512), (4096, 256), (100, 8)])
def test_suggest_sample_budget_matches_jax(occ, n_rays, max_steps):
    for kw in ({}, {"headroom": 1.0, "min_budget": 1}, {"headroom": 4.0}):
        assert (tcomp.suggest_sample_budget(occ, n_rays, max_steps, **kw)
                == jcomp.suggest_sample_budget(occ, n_rays, max_steps, **kw))


_TRAIN_VARIANTS = {
    "default": {},
    "override": {"sample_budget_eval": 12345},
    "dense": {"sample_budget_eval_per_ray": 0},
    "auto_off": {"sample_budget_eval_auto": False},
    "wide": {"sample_budget_eval_per_ray": 1000},
    "short": {"max_steps_eval": 128, "sample_budget_eval_per_ray": 16},
}


@pytest.mark.parametrize("variant", sorted(_TRAIN_VARIANTS))
@pytest.mark.parametrize("n_rays", [8192, 4096, 64])
def test_eval_budgets_match_jax(variant, n_rays):
    jcfg = JTrainConfig(**_TRAIN_VARIANTS[variant])
    tcfg = convert.config_from_jax(jcfg)
    for f in ("num_inference_steps", "sample_budget_eval_auto", "max_steps_eval"):
        assert getattr(tcfg, f) == getattr(jcfg, f)
    assert tj.eval_sample_budget(n_rays, tcfg) == jj.eval_sample_budget(n_rays, jcfg)
    for occ in (None, 0.0, 0.002, 0.02, 0.08, 0.2, 0.7, 1.0):
        assert (tj.eval_budget_for_occupancy(occ, n_rays, tcfg)
                == jj.eval_budget_for_occupancy(occ, n_rays, jcfg)), occ


@pytest.mark.parametrize("hbm_gib", [12, 16, 24, 40, 80])
@pytest.mark.parametrize("state_gb", [0.5, 4.6, 9.0])
@pytest.mark.parametrize("n_rays,max_steps", [(8192, 256), (32768, 256), (8192, 1024)])
def test_derive_train_sample_budget_matches_jax(hbm_gib, state_gb, n_rays, max_steps):
    """The same arithmetic as the reference for the same constants, given
    explicitly (the port's defaults are the card's own, the reference's a
    TPU's)."""
    for kw in ({"bytes_per_sample": 2048, "fixed_temp_frac": 0.65},
               {"bytes_per_sample": 3500, "fixed_temp_frac": 0.2,
                "reserve_bytes": 2 ** 30, "min_budget": 2 ** 14}):
        args = (n_rays, max_steps, int(state_gb * 1e9), hbm_gib * 2 ** 30)
        assert (tj.derive_train_sample_budget(*args, **kw)
                == jj.derive_train_sample_budget(*args, **kw))


def test_device_hbm_limit_and_config_defaults():
    assert tj.device_hbm_limit("cpu") is None
    assert tj.device_hbm_limit(torch.device("cpu")) is None
    t = dataclasses.asdict(convert.config_from_jax(JTrainConfig()))
    j = dataclasses.asdict(JTrainConfig())
    assert {k: j[k] for k in t} == t
