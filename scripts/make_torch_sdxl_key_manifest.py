#!/usr/bin/env python
"""The full-size SDXL key manifests from the port's converter templates
(counterpart of scripts/make_sdxl_key_manifest.py).

Lists every state-dict key, with its shape, that a real
``stabilityai/stable-diffusion-xl-base-1.0`` checkpoint must provide for
its ``unet/`` and ``vae/`` subdirectories, from
``models/diffusion/weights.py::{unet,vae}_state_dict_template`` at the
full configurations, built on the meta device (no memory).  The output
is the JAX script's format byte for byte: one JSON object a file, keys
sorted, ``indent=0``, a final newline.  The committed manifests in
tests/fixtures/ are the JAX package's; this script writes elsewhere by
default, and the tests hold its output to them byte for byte.

Prints each file's key and parameter counts (the SDXL base U-Net has
~2.567 B parameters, the VAE ~83.65 M).

Usage: python scripts/make_torch_sdxl_key_manifest.py [--out-dir output_sdxl_key_manifest]
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)

from stable_nerf_tpu_torch.models.diffusion.unet import sdxl_unet_config  # noqa: E402
from stable_nerf_tpu_torch.models.diffusion.vae import VAEConfig  # noqa: E402
from stable_nerf_tpu_torch.models.diffusion.weights import (  # noqa: E402
    unet_state_dict_template, vae_state_dict_template)

NAMES = ("sdxl_unet_keys.json", "sdxl_vae_keys.json")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out-dir", default="output_sdxl_key_manifest")
    return ap


def manifests() -> dict:
    """{file name: {key: shape list}} of the U-Net and the VAE."""
    return {NAMES[0]: {k: list(v.shape) for k, v in
                       sorted(unet_state_dict_template(sdxl_unet_config()).items())},
            NAMES[1]: {k: list(v.shape) for k, v in
                       sorted(vae_state_dict_template(VAEConfig()).items())}}


def write(out_dir: str) -> dict:
    """Write both manifests under ``out_dir``; {path: (keys, params)}."""
    os.makedirs(out_dir, exist_ok=True)
    out = {}
    for name, manifest in manifests().items():
        path = os.path.join(out_dir, name)
        with open(path, "w") as f:
            json.dump(manifest, f, indent=0, sort_keys=True)
            f.write("\n")
        out[path] = (len(manifest), sum(math.prod(s) for s in manifest.values()))
    return out


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    for path, (keys, params) in write(args.out_dir).items():
        print(f"{os.path.normpath(path)}: {keys} keys, {params:,} params")
    return 0


if __name__ == "__main__":
    sys.exit(main())
