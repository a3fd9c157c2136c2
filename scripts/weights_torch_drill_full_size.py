#!/usr/bin/env python
"""A full-size SDXL weights directory on disk, through the port's loader
and back, bit for bit (counterpart of scripts/weights_drill_full_size.py).

The strict converter and its precheck are exercised elsewhere at tiny
configurations or on templates; this drill runs the path a real
2.57 B-parameter checkpoint takes, with its bytes on disk, its float16
storage and its host memory:

  1. ``synthesize``: a full-size random SDXL directory in the HF hub layout
     (``unet/`` and ``vae/`` ``diffusion_pytorch_model.safetensors``,
     float16 as the published ``stabilityai/stable-diffusion-xl-base-1.0``;
     stock, so without IP-adapter keys), keys and shapes from the
     converter's templates, written by the port's own safetensors writer;
  2. ``check``: ``precheck_sdxl_checkpoint`` (headers only),
     ``checkpoint_fingerprint``, ``load_sdxl(strict=True, device="cpu")``
     (every key consumed, every leaf filled, the IP heads cloned from
     to_k/to_v), ``export_unet_state_dict`` / ``export_vae_state_dict``,
     and every exported tensor compared with the bytes on disk as float16
     bits.

The load path runs on the host (a training run then copies the loaded
tree to the card leaf by leaf): the drill needs no card.  Prints one JSON
line with the JAX drill's keys (sizes, seconds, fingerprint,
``bit_identical``, peak host RSS) and exits 0 exactly when the round trip
is bit-identical.  ``--dir`` (default: a new temporary directory) and
``--keep`` stand for the JAX drill's ``DRILL_DIR`` and ``DRILL_KEEP``.

Usage: python scripts/weights_torch_drill_full_size.py [--dir DIR] [--keep]
"""

from __future__ import annotations

import argparse
import json
import os
import resource
import shutil
import sys
import tempfile
import time

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from stable_nerf_tpu_torch.models.diffusion import weights  # noqa: E402
from stable_nerf_tpu_torch.utils.safetensors import save_file  # noqa: E402
from stable_nerf_tpu_torch.utils.tree import tree_leaves  # noqa: E402

FILE = "diffusion_pytorch_model.safetensors"


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--dir", default=None,
                    help="where to write the directory (default: a new temporary one)")
    ap.add_argument("--keep", action="store_true", help="leave the directory behind")
    return ap


def synthesize(ckpt_dir: str, seed: int = 0) -> dict:
    """Write the random float16 U-Net (stock: no IP keys) and VAE under
    ``ckpt_dir``; {sub: {"keys", "params", "bytes_on_disk"}}."""
    rng = np.random.default_rng(seed)
    stats = {}
    for sub, template in (("unet", weights.unet_state_dict_template(with_ip=False)),
                          ("vae", weights.vae_state_dict_template())):
        d = os.path.join(ckpt_dir, sub)
        os.makedirs(d, exist_ok=True)
        sd = {k: rng.standard_normal(tuple(v.shape), np.float32).astype(np.float16)
              for k, v in template.items()}
        path = os.path.join(d, FILE)
        save_file(sd, path)
        stats[sub] = {"keys": len(sd), "params": int(sum(x.size for x in sd.values())),
                      "bytes_on_disk": os.path.getsize(path)}
        del sd
    return stats


def _f16_bits(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float16).view(torch.int16)


def check(ckpt_dir: str) -> dict:
    """precheck → fingerprint → strict load on the host → export → the
    exported tensors against the bytes on disk as float16 bits."""
    result = {}
    t0 = time.time()
    weights.precheck_sdxl_checkpoint(ckpt_dir)
    result["precheck_s"] = round(time.time() - t0, 2)
    result["fingerprint"] = weights.checkpoint_fingerprint(ckpt_dir)
    t0 = time.time()
    loaded = weights.load_sdxl(ckpt_dir, with_ip=True, with_text_encoders=False,
                               strict=True, device="cpu")
    result["load_strict_s"] = round(time.time() - t0, 1)
    result["unet_tree_params"] = int(sum(x.numel() for x in tree_leaves(loaded["unet"])))
    result["vae_tree_params"] = int(sum(x.numel() for x in tree_leaves(loaded["vae"])))
    t0 = time.time()
    mismatches = []
    for sub, exported in (
            ("unet", weights.export_unet_state_dict(loaded["unet"], include_ip=False)),
            ("vae", weights.export_vae_state_dict(loaded["vae"]))):
        disk = weights.load_state_dict(os.path.join(ckpt_dir, sub, FILE))
        if set(exported) != set(disk):
            mismatches.append(f"{sub}: key sets differ ({sorted(set(disk) ^ set(exported))[:5]})")
            continue
        for k, v in disk.items():
            a = exported[k]
            if tuple(a.shape) != tuple(v.shape) or not torch.equal(_f16_bits(a), _f16_bits(v)):
                mismatches.append(f"{sub}:{k}")
                if len(mismatches) > 5:
                    break
        del exported, disk
    result["roundtrip_compare_s"] = round(time.time() - t0, 1)
    result["bit_identical"] = not mismatches
    if mismatches:
        result["mismatches"] = mismatches[:6]
    return result


def peak_rss_gb() -> float:
    """This process's peak resident set, GB (ru_maxrss is KiB on Linux)."""
    return round(resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2 ** 20, 2)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    out_dir = args.dir or tempfile.mkdtemp(prefix="sdxl_drill_")
    result = {"checkpoint_dir": out_dir}
    try:
        t0 = time.time()
        result["synthesized"] = synthesize(out_dir)
        result["synthesize_s"] = round(time.time() - t0, 1)
        result.update(check(out_dir))
        result["peak_rss_gb"] = peak_rss_gb()
        print(json.dumps(result))
    finally:
        if not args.keep:
            shutil.rmtree(out_dir, ignore_errors=True)
    return 0 if result.get("bit_identical") else 1


if __name__ == "__main__":
    sys.exit(main())
