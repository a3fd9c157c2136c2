"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU and skips without one.  This file
imports neither JAX nor the JAX package, so it runs on a machine that has
only PyTorch:

    python -m pytest tests/test_torch_cuda.py -m cuda -q

Tolerance: the scatter kernel adds with f32 atomics, whose order changes
from run to run, so each row's sum is held to 1e-5 of the row's sum of
|updates| against the plain version's index_add_; the encode's table
gradient (~10 updates a row) to 1e-5 relative and absolute.
"""

import pytest
import torch

from stable_nerf_tpu_torch.config import HashGridConfig
from stable_nerf_tpu_torch.ops import encoding
from stable_nerf_tpu_torch.ops.hopper.scatter import (hash_scatter_add_per_level,
                                                      hash_scatter_add_plain)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("L,T,F,payload_bf16", [
    (16, 2 ** 12, 2, False),    # K1-shaped: L'·T a multiple of 4096
    (16, 2 ** 12, 2, True),     # payload_bf16
    (3, 1024, 2, False),        # K2-shaped: 3·1024 is not a multiple of 4096
    (4, 1024, 3, False),        # a width other than the grid's 2 features
])
def test_kernel_matches_plain(cuda, L, T, F, payload_bf16):
    g = torch.Generator(device=cuda).manual_seed(0)
    M, C = 20_000, 8
    idx = (torch.randint(0, T, (M, L, C), generator=g, device=cuda)
           + torch.arange(L, device=cuda)[None, :, None] * T).to(torch.int32)
    idx[:100, 0, 0] = 7                      # a hot row
    idx[-10:, -1, -1] = L * T                # padding rows, dropped
    idx[-10:, 0, -1] = -1
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
