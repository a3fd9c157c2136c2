"""The port's CLIP text towers, CLIP vision tower and tokenizer against the
JAX package's and HF transformers', on the CPU.

Tiny ``transformers`` models (random weights from a seed) give the state
dicts; both packages convert them and run the same token ids or pixels.
Tolerance: 2e-5 absolute on hidden, penultimate and pooled states and on
the conditioning (float32 sums in other orders through 2-3 layers of
width 16-64); 3e-5 on the vision embeds, as the JAX package's own tests
hold them against HF.  The tokenizer: token for token.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

# transformers would otherwise import TensorFlow where it is installed (~15 s)
os.environ.setdefault("USE_TF", "0")
import transformers  # noqa: E402

from stable_nerf_tpu.models.diffusion import clip_text as jclip
from stable_nerf_tpu.models.diffusion import clip_vision as jvis
from stable_nerf_tpu.models.diffusion.tokenizer import CLIPTokenizer as JTokenizer
from stable_nerf_tpu_torch.models.diffusion import clip_text as tclip
from stable_nerf_tpu_torch.models.diffusion import clip_vision as tvis
from stable_nerf_tpu_torch.models.diffusion.tokenizer import CLIPTokenizer, _bytes_to_unicode

ATOL = 2e-5


def _cfgs(module, bigg, vocab=1000):
    kw = dict(vocab_size=vocab, hidden_size=32, num_layers=3, num_heads=4,
              intermediate_size=64, max_positions=77)
    if bigg:      # bigG's differences: gelu, a projection without bias, padding with 0
        kw |= dict(hidden_size=48, num_heads=6, hidden_act="gelu", projection_dim=24,
                   pad_token_id=0)
    if vocab < 49408:
        kw |= dict(bos_token_id=vocab - 2, eos_token_id=vocab - 1)
        if not bigg:
            kw["pad_token_id"] = vocab - 1
    return module.CLIPTextConfig(**kw)


def _hf_text(cfg, seed):
    hf_cfg = transformers.CLIPTextConfig(
        vocab_size=cfg.vocab_size, hidden_size=cfg.hidden_size,
        num_hidden_layers=cfg.num_layers, num_attention_heads=cfg.num_heads,
        intermediate_size=cfg.intermediate_size, max_position_embeddings=cfg.max_positions,
        hidden_act=cfg.hidden_act, projection_dim=cfg.projection_dim or cfg.hidden_size,
        eos_token_id=cfg.eos_token_id, bos_token_id=cfg.bos_token_id,
        pad_token_id=cfg.pad_token_id)
    torch.manual_seed(seed)
    cls = (transformers.CLIPTextModelWithProjection if cfg.projection_dim
           else transformers.CLIPTextModel)
    return cls(hf_cfg).eval()


def _close(a, b, atol=ATOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0, atol=atol)


@pytest.mark.parametrize("bigg", [False, True])
def test_text_tower_states_equal_hf_and_jax(bigg):
    tcfg, jcfg = _cfgs(tclip, bigg), _cfgs(jclip, bigg)
    model = _hf_text(tcfg, seed=int(bigg))
    sd = model.state_dict()
    port = tclip.params_from_hf_state_dict(sd, tcfg, strict=True)
    ref = jclip.params_from_hf_state_dict(sd, jcfg, strict=True)
    assert ("text_projection" in port) == bigg
    ids = np.random.default_rng(0).integers(0, tcfg.vocab_size - 2, (2, 77))
    ids[:, 0] = tcfg.bos_token_id
    ids[0, 5] = ids[0, 9] = tcfg.eos_token_id     # pooled at the FIRST eos
    ids[1, 40] = tcfg.eos_token_id
    got = tclip.clip_text_apply(port, torch.from_numpy(ids), tcfg)
    want = jclip.clip_text_apply(ref, jnp.asarray(ids, jnp.int32), jcfg)
    with torch.no_grad():
        hf = model(torch.from_numpy(ids), output_hidden_states=True)
    for k in ("last_hidden_state", "penultimate", "pooled"):
        _close(got[k], want[k])
    _close(got["last_hidden_state"], hf.last_hidden_state)
    _close(got["penultimate"], hf.hidden_states[-2])
    _close(got["pooled"], hf.text_embeds if bigg else hf.pooler_output)


def test_empty_prompt_ids_equal_jax():
    for name in ("clip_l_config", "open_clip_bigg_config"):
        got = tclip.empty_prompt_ids(getattr(tclip, name)(), batch=2)
        want = np.asarray(jclip.empty_prompt_ids(getattr(jclip, name)(), batch=2))
        assert got.dtype == torch.int64
        np.testing.assert_array_equal(got.numpy(), want)
    assert tclip.open_clip_bigg_config().pad_token_id == 0
    assert tclip.empty_prompt_ids(tclip.clip_l_config())[0, 2:].eq(49407).all()


def test_sdxl_conditioning_and_prompts_equal_hf_and_jax():
    """make_empty_prompt_conditioning (SDXL's real token ids) and
    encode_prompt's 4-tuple on two tiny towers."""
    t1, t2 = _cfgs(tclip, False, 49408), _cfgs(tclip, True, 49408)
    j1, j2 = _cfgs(jclip, False, 49408), _cfgs(jclip, True, 49408)
    m1, m2 = _hf_text(t1, 0), _hf_text(t2, 1)
    p1, p2 = (tclip.params_from_hf_state_dict(m.state_dict(), c, strict=True)
              for m, c in ((m1, t1), (m2, t2)))
    r1, r2 = (jclip.params_from_hf_state_dict(m.state_dict(), c)
              for m, c in ((m1, j1), (m2, j2)))
    embeds, pooled, time_ids = tclip.make_empty_prompt_conditioning(p1, p2, t1, t2)
    want = jclip.make_empty_prompt_conditioning(r1, r2, j1, j2)
    for a, b in zip((embeds, pooled, time_ids), want):
        assert tuple(a.shape) == tuple(b.shape)
        _close(a, b)
    with torch.no_grad():
        o1 = m1(tclip.empty_prompt_ids(t1), output_hidden_states=True)
        o2 = m2(tclip.empty_prompt_ids(t2), output_hidden_states=True)
    _close(embeds, torch.cat([o1.hidden_states[-2], o2.hidden_states[-2]], -1))
    _close(pooled, o2.text_embeds)
    assert float(pooled.abs().max()) > 0
    assert time_ids.tolist() == [[1024.0, 1024.0, 0.0, 0.0, 1024.0, 1024.0]]
    ids = torch.randint(0, 49406, (1, 77), generator=torch.Generator().manual_seed(3))
    ids[0, 7] = 49407
    got = tclip.encode_prompt(p1, p2, ids, ids, tclip.empty_prompt_ids(t1),
                              tclip.empty_prompt_ids(t2), t1, t2)
    jids = jnp.asarray(ids.numpy(), jnp.int32)
    ref = jclip.encode_prompt(r1, r2, jids, jids, jclip.empty_prompt_ids(j1),
                              jclip.empty_prompt_ids(j2), j1, j2)
    for a, b in zip(got, ref):
        _close(a, b)


def test_strict_text_converter_names_the_unconsumed_key():
    cfg = _cfgs(tclip, False)
    sd = dict(_hf_text(cfg, 0).state_dict())
    sd["text_model.extra.weight"] = torch.zeros(2)
    with pytest.raises(ValueError, match="text_model.extra.weight"):
        tclip.params_from_hf_state_dict(sd, cfg, strict=True)
    tclip.params_from_hf_state_dict(sd, cfg)               # not strict: ignored


@pytest.mark.parametrize("size", [32, 64, 24])
def test_vision_embeds_equal_hf_and_jax(size):
    """At the encoder's size against HF; shrunk (64) or grown (24) to it
    through clip_resize against the JAX package's jax.image.resize."""
    tcfg = tvis.CLIPVisionConfig(image_size=32, patch_size=8, hidden_size=64, num_layers=2,
                                 num_heads=4, intermediate_size=128, projection_dim=48)
    jcfg = jvis.CLIPVisionConfig(image_size=32, patch_size=8, hidden_size=64, num_layers=2,
                                 num_heads=4, intermediate_size=128, projection_dim=48)
    hf_cfg = transformers.CLIPVisionConfig(
        image_size=32, patch_size=8, hidden_size=64, num_hidden_layers=2,
        num_attention_heads=4, intermediate_size=128, projection_dim=48,
        hidden_act="quick_gelu")
    torch.manual_seed(0)
    model = transformers.CLIPVisionModelWithProjection(hf_cfg).eval()
    port = tvis.clip_vision_params_from_hf(model.state_dict(), tcfg)
    ref = jvis.clip_vision_params_from_hf(model.state_dict(), jcfg)
    x = np.random.default_rng(size).normal(size=(2, 3, size, size)).astype(np.float32)
    got = tvis.clip_encode_images(port, torch.from_numpy(x), tcfg)
    _close(got, jvis.clip_encode_images(ref, jnp.asarray(x), jcfg), 3e-5)
    if size == 32:
        with torch.no_grad():
            _close(got, model(torch.from_numpy(x)).image_embeds, 3e-5)
        out = tvis.clip_vision_apply(port, torch.from_numpy(x), tcfg)
        assert out["last_hidden_state"].shape == (2, 17, 64)
    else:
        _close(tvis.clip_resize(torch.from_numpy(x), 32),
               jvis.clip_resize(jnp.asarray(x), 32), 1e-5)


@pytest.fixture(scope="module")
def tok_dir(tmp_path_factory):
    """A tiny CLIP-style vocabulary: single-byte tokens and a few merges
    (the one tests/test_tokenizer.py builds)."""
    d = tmp_path_factory.mktemp("tok")
    chars = sorted(set(_bytes_to_unicode().values()))
    vocab = {c: i for i, c in enumerate(chars)}
    for c in chars:
        vocab[c + "</w>"] = len(vocab)
    merges = [("h", "e"), ("l", "l"), ("he", "ll"), ("w", "o"), ("r", "l"),
              ("wo", "rl"), ("t", "h"), ("th", "e</w>")]
    for a, b in merges:
        vocab.setdefault(a + b, len(vocab))
    vocab["<|startoftext|>"] = len(vocab)
    vocab["<|endoftext|>"] = len(vocab)
    with open(d / "vocab.json", "w") as f:
        json.dump(vocab, f)
    with open(d / "merges.txt", "w") as f:
        f.write("#version: 0.2\n" + "".join(f"{a} {b}\n" for a, b in merges))
    return str(d)


PROMPTS = ["", "hello world", "The  quick   brown fox!", "a photo of the 3 cats, isn't it?",
           "HELLO THERE", "we'll see: it's 42½ — naïve café 日本 😀!!", "x1y22\tz &amp; <b>",
           "<|startoftext|>hello<|endoftext|> there's"]


def test_tokenizer_equals_jax_and_hf(tok_dir):
    port, ref = CLIPTokenizer.from_dir(tok_dir), JTokenizer.from_dir(tok_dir)
    hf = transformers.CLIPTokenizer(vocab_file=os.path.join(tok_dir, "vocab.json"),
                                    merges_file=os.path.join(tok_dir, "merges.txt"))
    for p in PROMPTS:
        assert port.encode(p) == ref.encode(p), p
    for p in PROMPTS[:5]:
        assert port.encode(p) == hf(p, add_special_tokens=False)["input_ids"], p
    np.testing.assert_array_equal(port(PROMPTS, max_length=20), ref(PROMPTS, max_length=20))
    np.testing.assert_array_equal(
        port(PROMPTS[:5], max_length=20),
        np.asarray(hf(PROMPTS[:5], padding="max_length", truncation=True,
                      max_length=20)["input_ids"]))
