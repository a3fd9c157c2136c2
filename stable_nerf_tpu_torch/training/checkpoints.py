"""Resumable checkpoints: params, optimizer, occupancy grid and epoch
(counterpart of stable_nerf_tpu/training/checkpoints.py).

The methods and their meaning follow the JAX package's manager; the
storage differs.  Each step is one ``torch.save`` file, written to a
temporary name, flushed to disk and then renamed over ``<step>.pt``, so a
crash never leaves a half-written step that ``latest_step`` would report;
leftover temporary files are swept when a manager opens the directory.
Saves are synchronous.  Files load with ``weights_only=True``: tensors,
dicts, lists and numbers only.

A full-state checkpoint keeps the param tree under ``"params"``; a
trainable-only one keeps the trainable partition under ``"trainable"``
and records in ``FORMAT.json`` the inputs the frozen partition is rebuilt
from, with a checksum of it.
"""

from __future__ import annotations

import glob
import json
import os
import re
from typing import Any, Dict, Optional, Tuple

import torch

from ..utils.tree import partition, tree_leaves

FORMAT_FILE = "FORMAT.json"
_STEP_FILE = re.compile(r"^(\d+)\.pt$")


def frozen_partition_checksum(params: Any, mask: Any) -> Dict[str, float]:
    """Sum of |x| over the floating leaves of each top-level ``sd`` subtree
    of the FROZEN partition, in float32.  A trainable-only restore trusts
    that re-running the seeded init rebuilds the frozen partition; this
    catches one that does not.  Positive terms, so no cancellation hides a
    difference; compared with a relative tolerance on restore."""
    _, frozen = partition(params, mask)
    out = {}
    with torch.no_grad():
        for key, sub in frozen.get("sd", {}).items():
            leaves = [x for x in tree_leaves(sub)
                      if isinstance(x, torch.Tensor) and x.is_floating_point()]
            if leaves:
                total = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
                for x in leaves:            # leaf order and f32 sums, as JAX
                    total = total + x.float().abs().sum()
                out[key] = float(total)
    return out


def verify_frozen_checksum(recorded: Optional[Dict[str, float]],
                           rebuilt: Dict[str, float], *, rtol: float = 1e-3,
                           log_fn=print) -> None:
    """Compare a recorded frozen checksum with the rebuilt partition's.  A
    subtree off by more than ``rtol`` relative raises ValueError (the
    restored trainables would sit on another frozen model); a smaller
    non-zero drift is logged."""
    if not recorded:
        return
    bad, drift = {}, {}
    for k, want in recorded.items():
        got = rebuilt.get(k)
        if got is None:
            bad[k] = (want, None)
            continue
        rel = abs(got - want) / max(abs(want), 1e-30)
        if rel > rtol:
            bad[k] = (want, got)
        elif rel > 0:
            drift[k] = rel
    if bad:
        raise ValueError(
            "frozen-partition checksum mismatch after reconstruction — the "
            "rebuilt frozen model is NOT the one this checkpoint was "
            f"trained against (recorded vs rebuilt): {bad}")
    if drift:
        log_fn(f"checkpoints: frozen checksum drift within tolerance "
               f"(max rel {max(drift.values()):.2e}) — expected across "
               f"backend/version changes")


def copy_into(live: Any, loaded: Any, path: str = "", keep: Tuple[str, ...] = ()) -> Any:
    """Copy a loaded tree into the live tensors of ``live`` in place (no
    grad) and return ``live``'s tree.  Keys, lengths, shapes and dtypes
    must match, but a dict key named in ``keep`` that the loaded tree lacks
    keeps its live value; a None in ``live`` takes the loaded subtree as it
    is."""
    if live is None:
        return loaded
    if isinstance(live, tuple) and hasattr(live, "_fields"):
        if not isinstance(loaded, dict):
            raise TypeError(f"{path}: {type(live).__name__} vs {type(loaded).__name__}")
        return type(live)(**copy_into(live._asdict(), loaded, path, keep))
    if isinstance(live, dict):
        kept = {k for k in keep if k in live and k not in loaded} \
            if isinstance(loaded, dict) else set()
        if not isinstance(loaded, dict) or set(live) != set(loaded) | kept:
            got = sorted(loaded) if isinstance(loaded, dict) else type(loaded).__name__
            raise KeyError(f"{path or '<root>'}: checkpoint has {got}, expected "
                           f"{sorted(live)}")
        return {k: v if k in kept else copy_into(v, loaded[k], f"{path}/{k}", keep)
                for k, v in live.items()}
    if isinstance(live, (list, tuple)):
        if not isinstance(loaded, (list, tuple)) or len(loaded) != len(live):
            raise ValueError(f"{path}: checkpoint structure differs")
        return [copy_into(v, w, f"{path}/{i}", keep)
                for i, (v, w) in enumerate(zip(live, loaded))]
    if isinstance(live, torch.Tensor):
        if not isinstance(loaded, torch.Tensor) or loaded.shape != live.shape \
                or loaded.dtype != live.dtype:
            desc = (f"{tuple(loaded.shape)} {loaded.dtype}"
                    if isinstance(loaded, torch.Tensor) else type(loaded).__name__)
            raise ValueError(f"{path}: checkpoint has {desc}, expected "
                             f"{tuple(live.shape)} {live.dtype}")
        with torch.no_grad():
            if loaded.device != live.device and not loaded.is_contiguous():
                # a transposed view (a converted linear): moved as it is laid
                # out, re-laid out by the device, not element by element on
                # the host (one leaf's extra memory there)
                loaded = loaded.to(live.device)
            live.copy_(loaded)
        return live
    return loaded


def _to_saveable(tree: Any) -> Any:
    """NamedTuples (the grid state) become dicts: ``weights_only`` loads
    plain containers only."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return {k: _to_saveable(v) for k, v in tree._asdict().items()}
    if isinstance(tree, dict):
        return {k: _to_saveable(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to_saveable(v) for v in tree]
    if isinstance(tree, torch.Tensor):
        return tree.detach()
    return tree


class CheckpointManager:
    # FORMAT.json keys that record the frozen partition's reconstruction
    # inputs: a run that differs on any of them may not write more steps
    # into a directory that holds them
    RECONSTRUCTION_KEYS = ("version", "trainable_only", "seed", "pretrained_sd",
                           "frozen_dtype", "trainable_scope", "sdxl_fingerprint")

    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)
        self._sweep_stale_tmp()

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"{step}.pt")

    def _sweep_stale_tmp(self):
        """Remove the temporary files of saves that never finished."""
        for p in glob.glob(os.path.join(self.directory, "*.pt.tmp")):
            os.remove(p)

    def all_steps(self):
        """The steps on disk, ascending."""
        return sorted(int(m.group(1)) for m in map(_STEP_FILE.match,
                                                   os.listdir(self.directory)) if m)

    def save(self, step: int, params: Any, opt_state: Any, grid_state: Any,
             extra: Optional[Dict] = None, wait: bool = False,
             params_key: str = "params", fmt: Optional[Dict] = None) -> bool:
        """Write step ``step``; returns False and writes nothing when a step
        at least as late is already on disk (as orbax does).  The oldest
        steps beyond ``max_to_keep`` are deleted.  ``wait`` is accepted for
        the JAX package's interface: every save has finished on return."""
        if fmt:
            self.write_format(fmt)
        latest = self.latest_step()
        if latest is not None and step <= latest:
            return False
        state = _to_saveable({params_key: params, "opt_state": opt_state,
                              "grid_state": grid_state, "extra": extra or {}})
        path = self._path(step)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            torch.save(state, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        dir_fd = os.open(self.directory, os.O_RDONLY)
        try:
            os.fsync(dir_fd)
        finally:
            os.close(dir_fd)
        for old in self.all_steps()[:-self.max_to_keep]:
            os.remove(self._path(old))
        return True

    def write_format(self, fmt: Dict):
        """Write the FORMAT.json sidecar.  One already on disk stands for
        the steps there: this run's ``fmt`` must agree with it on every
        reconstruction key both record, or the write is refused."""
        path = os.path.join(self.directory, FORMAT_FILE)
        if os.path.exists(path):
            with open(path) as f:
                on_disk = json.load(f)
            conflicts = {k: (on_disk[k], fmt.get(k)) for k in self.RECONSTRUCTION_KEYS
                         if k in on_disk and k in fmt and on_disk[k] != fmt[k]}
            if conflicts:
                raise ValueError(
                    f"refusing to write checkpoints under {self.directory}: "
                    f"its FORMAT.json records frozen-reconstruction inputs "
                    f"that differ from this run's — {conflicts} (on-disk vs "
                    f"this run).  Use a fresh --workdir, or rerun with the "
                    f"recorded inputs.")
            return
        with open(path, "w") as f:
            json.dump(fmt, f, indent=1)

    def read_format(self) -> Dict:
        """The FORMAT.json sidecar, or {} for full-state checkpoints."""
        path = os.path.join(self.directory, FORMAT_FILE)
        if os.path.exists(path):
            with open(path) as f:
                return json.load(f)
        return {}

    def restore(self, step: Optional[int] = None, template: Optional[Any] = None):
        """The state of ``step`` (default the latest; None when there is
        none), loaded on the CPU.  With a ``template`` (a tree of live
        tensors; None where a subtree is taken as loaded) the state is
        copied into the template's tensors, so nothing on the card is held
        twice, and the template's tree is returned."""
        step = step if step is not None else self.latest_step()
        if step is None:
            return None
        state = torch.load(self._path(step), map_location="cpu", weights_only=True)
        if template is None:
            return state
        return copy_into(template, state)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def wait_until_finished(self):
        """Saves are synchronous: nothing is in flight."""

    def close(self):
        """Nothing is held open."""
