"""Activation registry for scene parameter fields.

Each named activation maps the raw (stored) parameter to its physical
value; its inverse maps initial physical values into raw space
(reference utils/activations.py:37-57 in gsgen3d/gsgen).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

MIN_SCALE = 1e-3


def _logit(x, eps=1e-7):
    x = torch.clamp(x, eps, 1.0 - eps)
    return torch.log(x) - torch.log1p(-x)


def _softplus_inv(x):
    # log(expm1(x)), stable for small & large x
    return x + torch.log(-torch.expm1(-x))


ACTIVATIONS = dict(
    abs=torch.abs,
    relu=torch.relu,
    sigmoid=torch.sigmoid,
    nothing=lambda x: x,
    exp=torch.exp,
    biased_relu=lambda x: torch.relu(x) + MIN_SCALE,
    biased_abs=lambda x: torch.abs(x) + MIN_SCALE,
    softplus=F.softplus,
)

INV_ACTIVATIONS = dict(
    abs=torch.abs,
    relu=lambda x: x,
    sigmoid=_logit,
    nothing=lambda x: x,
    exp=torch.log,
    biased_relu=lambda x: x - MIN_SCALE,
    biased_abs=lambda x: torch.abs(x - MIN_SCALE),
    softplus=_softplus_inv,
)


def act(name: str):
    return ACTIVATIONS[name]


def inv_act(name: str):
    return INV_ACTIVATIONS[name]
