"""The port's analytic U-Net FLOP count against the JAX package's, and
against ``torch.utils.flop_counter.FlopCounterMode`` on a real forward.

``unet_forward_flops`` is integer arithmetic over the config: it must equal
the JAX function's integer exactly for the SDXL, tiny and demo configs at
every batch and latent size.  FlopCounterMode counts the convolutions and
matrix products that ``unet_apply`` runs; the analytic count walks the same
ones and leaves out norms, softmax and pointwise work, which
FlopCounterMode does not count either.  They are held within 1%: room for
a product one count sees and the other does not (the time embedding's
MLPs on one token, say), none of which exist today.
"""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from stable_nerf_tpu.models.diffusion import unet as junet
from stable_nerf_tpu.utils.flops import unet_forward_flops as jax_flops
from stable_nerf_tpu_torch.models.diffusion import unet as tunet
from stable_nerf_tpu_torch.utils.flops import unet_forward_flops

CONFIGS = {
    "sdxl": (junet.sdxl_unet_config, tunet.sdxl_unet_config),
    "tiny": (junet.tiny_unet_config, tunet.tiny_unet_config),
    "demo": (junet.demo_unet_config, tunet.demo_unet_config),
}


@pytest.mark.parametrize("latent", [16, 32, 64])
@pytest.mark.parametrize("batch", [1, 2, 4, 8])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_unet_forward_flops_equal_jax(name, batch, latent):
    jax_cfg, port_cfg = (f() for f in CONFIGS[name])
    got = unet_forward_flops(port_cfg, batch, latent)
    assert isinstance(got, int)
    assert got == jax_flops(jax_cfg, batch, latent)


def test_sdxl_count_at_the_bench_shape():
    """The bench's numerator: 1,531.37 GFLOP a forward at batch 1 and
    3,062.74 at batch 2, 64² latents."""
    cfg = tunet.sdxl_unet_config()
    assert unet_forward_flops(cfg, 1, 64) == 1_531_369_226_240
    assert unet_forward_flops(cfg, 2, 64) == 2 * unet_forward_flops(cfg, 1, 64)


@pytest.mark.parametrize("name,tokens", [("tiny", 4), ("demo", 32)])
def test_flop_counter_agrees_with_the_analytic_count(name, tokens):
    """One float32 forward on the CPU at batch 2, 16² latents, with
    ``tokens`` conditioning tokens (2 views × ip_num_tokens)."""
    cfg = CONFIGS[name][1]()
    g = torch.Generator().manual_seed(0)
    params = tunet.unet_init(g, cfg, with_ip=True)
    B, H = 2, 16
    x = torch.randn((B, 4, H, H), generator=g)
    ctx = torch.randn((B, tokens, cfg.cross_attention_dim), generator=g)
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        tunet.unet_apply(params, x, 500, ctx,
                         added_text_embeds=torch.zeros((B, cfg.pooled_projection_dim)),
                         added_time_ids=torch.zeros((B, 6)), cfg=cfg)
    want = unet_forward_flops(cfg, B, H, cond_tokens=tokens)
    assert abs(counter.get_total_flops() - want) <= 0.01 * want
