"""The ``C()`` schedule mini-language + learning-rate schedulers.

Host-side (pure Python) port of the reference's universal knob format
(utils/misc.py:218-274 in gsgen3d/gsgen) and lr schedulers
(utils/schedulers.py:6-40).  Schedules are evaluated on the host each
step and enter the train step as plain Python floats.

Accepted specs (identical to the reference):
  scalar                                 -> constant
  [v0, v1, end]                          -> [0, v0, v1, end]
  [start, v0, v1, end]                   -> linear interp, clamped
  [start, v0, v1, end, 'linear'|'sqrt'|'alternative']

A float ``end`` means ``int(end * max_steps)`` (the reference documents
this intent at utils/misc.py:236-241; its implementation of the float
branch is buggy — we implement the documented behavior).
"""

from __future__ import annotations

import math
from typing import Any, Sequence, Union

Scalar = Union[int, float]


def C(value: Any, step: int, max_steps: int | None = None) -> float:
    if isinstance(value, (int, float)):
        return float(value)
    value = list(value)
    if len(value) == 3:
        value = [0] + value
    if len(value) == 4:
        start_step, v0, v1, end_step = value
        interp = "linear"
    elif len(value) == 5:
        start_step, v0, v1, end_step, interp = value
    else:
        raise ValueError(f"bad schedule spec {value}")

    if isinstance(end_step, float) and not float(end_step).is_integer():
        if max_steps is None:
            raise ValueError("max_steps required for fractional end_step")
        end_step = int(end_step * max_steps)
    end_step = int(end_step)

    if interp == "linear":
        t = max(min(1.0, (step - start_step) / (end_step - start_step)), 0.0)
        return v0 + (v1 - v0) * t
    if interp == "sqrt":
        w = math.sqrt(
            max(min(1.0, (step - start_step) / (end_step - start_step)), 0.0))
        return v1 - (v1 - v0) * w
    if interp == "alternative":
        return v0 if ((step - start_step) // (end_step - start_step)) % 2 == 0 else v1
    raise ValueError(f"unknown interp {interp}")


def exp_decay(tot_steps, lr_start, lr_end, warmup_steps=0):
    def fn(step):
        if warmup_steps and step < warmup_steps:
            return lr_start * (step / warmup_steps)
        t = min(max((step - warmup_steps) / (tot_steps - warmup_steps), 0.0), 1.0)
        return math.exp(math.log(lr_start) * (1 - t) + math.log(lr_end) * t)
    return fn


def cosine_decay(tot_steps, lr_start, lr_end, warmup_steps=0):
    def fn(step):
        if warmup_steps and step < warmup_steps:
            return lr_start * (step / warmup_steps)
        t = (step - warmup_steps) / (tot_steps - warmup_steps)
        return lr_end + (lr_start - lr_end) * (1 + math.cos(math.pi * t)) / 2
    return fn


def no_decay(tot_steps, lr_start, lr_end, warmup_steps=0):
    return lambda step: lr_start


LR_SCHEDULERS = dict(nothing=no_decay, cosine=cosine_decay, exp=exp_decay)


def make_lr_schedule(spec: Any, max_steps: int | None = None):
    """Per-field lr spec -> callable step -> lr.

    Reference setup_lr (gs/gaussian_splatting.py:267-292): a 4-list
    ``[lr_start, lr_end, steps, type]`` selects an lr scheduler; a
    5-list (or scalar / 3-list) is a ``C()`` spec.
    """
    if isinstance(spec, (int, float)):
        return lambda step: float(spec)
    spec = list(spec)
    if len(spec) == 4 and isinstance(spec[3], str):
        lr_start, lr_end, steps, kind = spec
        return LR_SCHEDULERS[kind](steps, lr_start, lr_end)
    return lambda step: C(spec, step, max_steps)
