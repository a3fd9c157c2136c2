"""Faults planted under the timed path, to show that the check fails them,
and the control: the plain reference one precision step down, in the
program's place.

``plant(name, kind)`` patches the program for the block.  A kind module
(``harness/kinds/<kind>.py``) may bring faults of its own: where its
``FAULTS`` lists ``name``, its context manager ``plant(name)`` is planted.
Otherwise the faults here are:

* ``unchanged``: the optimizer's update returns the state unchanged;
* ``half_batch``: half of the batch left out, the mean taken over the rest
  (the joint step's NeRF loss over half of each view's rays; the fit step
  on half of its rays);
* ``altered``: an answer altered where it is produced (a served request's
  first decoded image negated).
"""

from __future__ import annotations

import contextlib
from typing import Dict

import torch

from . import compare, program

FAULTS = ("unchanged", "half_batch", "altered")


@contextlib.contextmanager
def _patched(obj, name, value):
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


def known(kind=None) -> tuple:
    """The faults ``plant`` knows for cells of ``kind``."""
    return FAULTS + tuple(f for f in getattr(kind, "FAULTS", ()) if f not in FAULTS)


@contextlib.contextmanager
def plant(name: str, kind=None):
    if name in getattr(kind, "FAULTS", ()):
        with kind.plant(name):
            yield
    elif name == "unchanged":
        with _patched(torch.optim.AdamW, "step", lambda self, closure=None: None), \
                _patched(torch.optim.Adam, "step", lambda self, closure=None: None):
            yield
    elif name == "half_batch":
        import stable_nerf_tpu_torch.training.joint as joint

        fit = program.fit_module()
        step = fit.train_step

        def half_l1(pred, gt):
            k = pred.shape[1] // 2
            return (pred[:, :k] - gt[:, :k]).abs().mean()

        def half_fit(params, opt, sched, state, pool, cfg, idx, perturb, **kw):
            k = idx.shape[0] // 2
            return step(params, opt, sched, state, pool, cfg, idx[:k], perturb[:k], **kw)

        with _patched(joint, "l1_loss", half_l1), _patched(fit, "train_step", half_fit):
            yield
    elif name == "altered":
        import stable_nerf_tpu_torch.training.inference as inference

        decode = inference.decode_latents

        def altered(*a, **kw):
            out = decode(*a, **kw)
            out[0] = -out[0]
            return out

        with _patched(inference, "decode_latents", altered):
            yield
    else:
        raise ValueError(f"unknown fault {name!r}; known: {known(kind)}")


def control_numbers(kind, ctx, requests=(0, 1)) -> Dict[str, float]:
    """The cell's compared numbers with the control in the program's place."""
    if kind.UNIT == "requests":
        ref = kind.reference_outputs(ctx, requests, "reference")
        ctl = kind.reference_outputs(ctx, requests, "control")
        return compare.image_gaps([ctl[r][0] for r in requests], [ref[r][0] for r in requests],
                                  [ctl[r][1] for r in requests], [ref[r][1] for r in requests])
    return compare.training_gaps(kind.reference_record(ctx, "control"),
                                 kind.reference_record(ctx, "reference"))
