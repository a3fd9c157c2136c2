"""Parameter trees and configurations to and from the JAX package's layout.

The reference keeps the NeRF params in NamedTuples (NeRFParams →
HashGridParams, MLPParams) and the SD params in nested dicts and lists;
the port keeps plain dicts and lists with the same field names and the same
array layouts, so conversion only renames containers and copies arrays.
Both directions are strict: every leaf must be an array and is consumed
once, and a given template must match key for key and shape for shape.

Nothing here imports JAX: a NamedTuple is recognised by its ``_fields``
and an array by ``__array__``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def params_from_jax(tree: Any, *, device="cpu", like: Optional[Any] = None) -> Any:
    """A JAX param tree (leaves anything ``np.asarray`` accepts) → the
    port's tree of float32/int tensors on ``device``.

    like: optional port tree (e.g. from the port's init) that the result
      must match exactly in keys, list lengths and leaf shapes.
    """
    def visit(x, ref, path):
        if _is_namedtuple(x):
            x = dict(zip(x._fields, x))
        if isinstance(x, dict):
            if ref is not None and set(ref) != set(x):
                raise KeyError(f"{path or '<root>'}: keys {sorted(x)} vs "
                               f"template {sorted(ref)}")
            return {k: visit(v, None if ref is None else ref[k], f"{path}/{k}")
                    for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            if ref is not None and len(ref) != len(x):
                raise ValueError(f"{path}: {len(x)} items vs template {len(ref)}")
            return [visit(v, None if ref is None else ref[i], f"{path}/{i}")
                    for i, v in enumerate(x)]
        if not hasattr(x, "__array__"):
            raise TypeError(f"{path}: leaf of type {type(x).__name__} is not an array")
        arr = np.asarray(x)
        if ref is not None and tuple(ref.shape) != arr.shape:
            raise ValueError(f"{path}: shape {arr.shape} vs template "
                             f"{tuple(ref.shape)}")
        if arr.dtype.name == "bfloat16":     # ml_dtypes bf16 from JAX
            return torch.from_numpy(arr.astype(np.float32)).to(device, torch.bfloat16)
        return torch.from_numpy(np.array(arr, copy=True)).to(device)

    return visit(tree, like, "")


def params_to_jax(params: Any, like: Optional[Any] = None) -> Any:
    """The port's tree → numpy arrays in the JAX layout.  With ``like`` (a
    JAX tree), NamedTuple nodes are rebuilt with their own types, so the
    result can be fed to the JAX package directly."""
    def visit(x, ref, path):
        if isinstance(x, dict):
            if ref is not None:
                fields = ref._fields if _is_namedtuple(ref) else tuple(ref)
                if set(fields) != set(x):
                    raise KeyError(f"{path or '<root>'}: keys {sorted(x)} vs "
                                   f"{sorted(fields)}")
                if _is_namedtuple(ref):
                    return type(ref)(**{k: visit(x[k], getattr(ref, k), f"{path}/{k}")
                                        for k in ref._fields})
            return {k: visit(v, None if ref is None else ref[k], f"{path}/{k}")
                    for k, v in x.items()}
        if isinstance(x, list):
            out = [visit(v, None if ref is None else ref[i], f"{path}/{i}")
                   for i, v in enumerate(x)]
            return tuple(out) if isinstance(ref, tuple) else out
        if not isinstance(x, torch.Tensor):
            raise TypeError(f"{path}: leaf of type {type(x).__name__} is not a tensor")
        # a copy: .numpy() of a CPU tensor shares its memory, and the
        # port updates params in place
        x = x.detach().cpu()
        return (x.float() if x.is_floating_point() else x).numpy().copy()

    return visit(params, like, "")


def _port_config_classes():
    from . import config
    from .models.diffusion.sd_network import SDNetworkConfig
    from .models.diffusion.unet import UNetConfig
    from .models.diffusion.vae import VAEConfig
    from .training.joint import JointConfig

    classes = [config.HashGridConfig, config.SHConfig, config.MLPConfig,
               config.NeRFConfig, config.SDConfig, config.SchedulerConfig,
               config.TrainConfig, config.TinyNeRFConfig, VAEConfig, UNetConfig, SDNetworkConfig,
               JointConfig]
    return {c.__name__: c for c in classes}


def _default(f: dataclasses.Field) -> Any:
    if f.default_factory is not dataclasses.MISSING:
        return f.default_factory()
    return f.default


def config_from_jax(cfg: Any) -> Any:
    """A JAX configuration dataclass (any of the joint step's) → the port's
    class of the same name, field by field.  A field the port does not
    have is accepted only at its default: a setting the port would ignore
    raises instead."""
    classes = _port_config_classes()

    def visit(x):
        if not dataclasses.is_dataclass(x):
            return x
        name = type(x).__name__
        if name not in classes:
            raise TypeError(f"no port counterpart of config class {name}")
        port_fields = {f.name for f in dataclasses.fields(classes[name])}
        values = {}
        for f in dataclasses.fields(x):
            value = getattr(x, f.name)
            if f.name in port_fields:
                values[f.name] = visit(value)
            elif value != _default(f):
                raise TypeError(f"{name}.{f.name} = {value!r} is not ported")
        return classes[name](**values)

    return visit(cfg)
