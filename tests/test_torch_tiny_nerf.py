"""The port's tiny NeRF (stable_nerf_tpu_torch/models/nerf/tiny.py) and its
frequency encoding against the JAX package's on the CPU: the same params
(JAX's init, converted), the same rays and the same in-bin jitter (JAX's
draw injected).  Forward within 1e-5 relative, gradients within 1e-4
relative to each leaf's largest (float32 sums in other orders), and a
few Adam steps of a fit within 1e-5 (1% of a step of lr 1e-3)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from stable_nerf_tpu.config import TinyNeRFConfig as JTinyCfg
from stable_nerf_tpu.models.nerf import tiny as jtiny
from stable_nerf_tpu.ops.encoding import freq_encoding as jfreq
from stable_nerf_tpu_torch import convert
from stable_nerf_tpu_torch.config import TinyNeRFConfig
from stable_nerf_tpu_torch.models.nerf import tiny as ttiny
from stable_nerf_tpu_torch.ops.encoding import freq_encoding as tfreq

torch.set_num_threads(2)
JCFG = JTinyCfg(n_samples=16, width=32)


def _to_port(jp):
    return ttiny.TinyNeRFParams(*[
        tuple(torch.tensor(np.asarray(x)) for x in f) if isinstance(f, tuple)
        else torch.tensor(np.asarray(f)) for f in jp])


def _rays(rng, n):
    o = rng.uniform(-0.5, 0.5, (n, 3)).astype(np.float32)
    o[:, 2] += 4.0
    d = rng.standard_normal((n, 3)).astype(np.float32) * 0.1
    d[:, 2] = -1.0
    return o, d / np.linalg.norm(d, axis=-1, keepdims=True)


@pytest.mark.parametrize("n_freqs,include", [(6, True), (4, False), (1, True)])
def test_freq_encoding_equals_jax(rng, n_freqs, include):
    x = rng.uniform(-3, 3, (5, 7, 3)).astype(np.float32)
    want = np.asarray(jfreq(jnp.asarray(x), n_freqs, include_input=include))
    got = tfreq(torch.from_numpy(x), n_freqs, include_input=include)
    assert got.shape == want.shape == (5, 7, 3 * (2 * n_freqs + include))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("viewdirs", [True, False])
def test_init_matches_jax_structure_and_config_converts(viewdirs):
    jcfg = dataclasses.replace(JCFG, use_viewdirs=viewdirs)
    cfg = convert.config_from_jax(jcfg)
    assert cfg == TinyNeRFConfig(n_samples=16, width=32, use_viewdirs=viewdirs)
    jp = jtiny.tiny_nerf_init(jax.random.PRNGKey(0), jcfg)
    tp = ttiny.tiny_nerf_init(0, cfg, device="cpu")
    jl, tl = jax.tree.leaves(jp), [x for f in tp for x in (f if isinstance(f, tuple) else [f])]
    assert [x.shape for x in jl] == [tuple(x.shape) for x in tl]
    for x in tl:
        assert x.dtype == torch.float32
    # U(±1/√in) kernels, zero biases, as JAX draws them
    for w in tp.weights:
        assert float(w.abs().max()) <= (1.0 / w.shape[0]) ** 0.5
    assert all(float(b.abs().max()) == 0.0 for b in tp.biases)


@pytest.mark.parametrize("viewdirs", [True, False])
def test_apply_equals_jax(rng, viewdirs):
    jcfg = dataclasses.replace(JCFG, use_viewdirs=viewdirs)
    jp = jtiny.tiny_nerf_init(jax.random.PRNGKey(1), jcfg)
    x = rng.uniform(-1, 1, (40, 3)).astype(np.float32)
    d = rng.standard_normal((40, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    js, jc = jtiny.tiny_nerf_apply(jp, jnp.asarray(x), jnp.asarray(d), jcfg)
    ts, tc = ttiny.tiny_nerf_apply(_to_port(jp), torch.from_numpy(x), torch.from_numpy(d),
                                   convert.config_from_jax(jcfg))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("jitter,white_bg", [(True, True), (False, False)])
def test_render_and_grads_equal_jax(rng, jitter, white_bg):
    jp = jtiny.tiny_nerf_init(jax.random.PRNGKey(2), JCFG)
    o, d = _rays(rng, 24)
    key = jax.random.PRNGKey(5) if jitter else None
    gt = rng.uniform(0, 1, (24, 3)).astype(np.float32)

    def jloss(p):
        out = jtiny.render_tiny(p, jnp.asarray(o), jnp.asarray(d), JCFG, key=key,
                                white_bg=white_bg)
        return jnp.mean((out["image"] - gt) ** 2), out

    (jl, jout), jg = jax.value_and_grad(jloss, has_aux=True)(jp)
    u = (torch.from_numpy(np.array(jax.random.uniform(key, (24, JCFG.n_samples))))
         if jitter else None)
    tp = _to_port(jp)
    leaves = [x for f in tp for x in (f if isinstance(f, tuple) else [f])]
    for x in leaves:
        x.requires_grad_(True)
    tout = ttiny.render_tiny(tp, torch.from_numpy(o), torch.from_numpy(d),
                             convert.config_from_jax(JCFG), u=u, white_bg=white_bg)
    tl = ((tout["image"] - torch.from_numpy(gt)) ** 2).mean()
    tl.backward()
    for k in ("image", "depth", "weights_sum"):
        np.testing.assert_allclose(tout[k].detach().numpy(), np.asarray(jout[k]),
                                   rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    for a, b in zip(leaves, jax.tree.leaves(jg)):
        b = np.asarray(b)
        np.testing.assert_allclose(a.grad.numpy(), b, rtol=0,
                                   atol=1e-4 * max(float(np.abs(b).max()), 1e-12))


def test_render_draws_from_a_generator_or_uses_bin_centres(rng):
    tp = _to_port(jtiny.tiny_nerf_init(jax.random.PRNGKey(3), JCFG))
    cfg = convert.config_from_jax(JCFG)
    o, d = (torch.from_numpy(a) for a in _rays(rng, 6))
    a = ttiny.render_tiny(tp, o, d, cfg, generator=torch.Generator().manual_seed(0))
    b = ttiny.render_tiny(tp, o, d, cfg, generator=torch.Generator().manual_seed(0))
    torch.testing.assert_close(a["image"], b["image"], rtol=0, atol=0)
    centre = ttiny.render_tiny(tp, o, d, cfg)
    half = ttiny.render_tiny(tp, o, d, cfg, u=torch.full((6, cfg.n_samples), 0.5))
    torch.testing.assert_close(centre["image"], half["image"], rtol=0, atol=0)
    want = jtiny.render_tiny(jtiny.tiny_nerf_init(jax.random.PRNGKey(3), JCFG),
                             jnp.asarray(o.numpy()), jnp.asarray(d.numpy()), JCFG)
    np.testing.assert_allclose(centre["depth"].numpy(), np.asarray(want["depth"]),
                               rtol=1e-5, atol=1e-6)


def test_adam_fit_steps_equal_jax(rng):
    """Five Adam(1e-3) steps of a fit to random colours, in both packages."""
    jp = jtiny.tiny_nerf_init(jax.random.PRNGKey(4), JCFG)
    o, d = _rays(rng, 32)
    gt = rng.uniform(0, 1, (32, 3)).astype(np.float32)
    opt = optax.adam(1e-3)
    state = opt.init(jp)
    tp = _to_port(jp)
    leaves = [x for f in tp for x in (f if isinstance(f, tuple) else [f])]
    for x in leaves:
        x.requires_grad_(True)
    topt = torch.optim.Adam(leaves, lr=1e-3)
    cfg = convert.config_from_jax(JCFG)

    @jax.jit
    def jstep(p, s):
        g = jax.grad(lambda q: jnp.mean((jtiny.render_tiny(
            q, jnp.asarray(o), jnp.asarray(d), JCFG, white_bg=True)["image"] - gt) ** 2))(p)
        u, s = opt.update(g, s)
        return optax.apply_updates(p, u), s

    for _ in range(5):
        jp, state = jstep(jp, state)
        loss = ((ttiny.render_tiny(tp, torch.from_numpy(o), torch.from_numpy(d), cfg,
                                   white_bg=True)["image"] - torch.from_numpy(gt)) ** 2).mean()
        topt.zero_grad()
        loss.backward()
        topt.step()
    for a, b in zip(leaves, jax.tree.leaves(jp)):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), rtol=0, atol=1e-5)
