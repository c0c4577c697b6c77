"""Functional Adam with per-field learning rates.

Port of the JAX package's ``training/optimizer.py``: moments are dicts of
tensors keyed like the parameters, learning rates arrive per step, and
densify/prune (a later slice) zero moment rows in place of reallocating
(:func:`mask_state_rows`).  Numerics follow ``torch.optim.Adam``: betas
(0.9, 0.999), bias correction, eps added after the sqrt, eps=1e-15.  The
bias corrections are float32 powers, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Union

import torch

Tensors = Dict[str, torch.Tensor]


@dataclasses.dataclass
class AdamState:
    mu: Tensors     # first moments, keyed like the params
    nu: Tensors     # second moments
    count: int      # steps taken


def adam_init(params: Tensors) -> AdamState:
    return AdamState(mu={k: torch.zeros_like(v) for k, v in params.items()},
                     nu={k: torch.zeros_like(v) for k, v in params.items()},
                     count=0)


@torch.no_grad()
def adam_update(grads: Tensors, state: AdamState, params: Tensors,
                lrs: Union[float, Dict[str, float]], b1: float = 0.9,
                b2: float = 0.999, eps: float = 1e-15):
    """One Adam step; returns (new_params, new_state)."""
    count = state.count + 1
    dev = next(iter(params.values())).device
    t = torch.tensor(float(count), dtype=torch.float32, device=dev)
    c1 = 1.0 - torch.tensor(b1, dtype=torch.float32, device=dev) ** t
    c2 = 1.0 - torch.tensor(b2, dtype=torch.float32, device=dev) ** t
    mu, nu, new = {}, {}, {}
    for k, p in params.items():
        g = grads[k]
        mu[k] = b1 * state.mu[k] + (1.0 - b1) * g
        nu[k] = b2 * state.nu[k] + (1.0 - b2) * g * g
        lr = lrs[k] if isinstance(lrs, dict) else lrs
        new[k] = p - lr * (mu[k] / c1) / (torch.sqrt(nu[k] / c2) + eps)
    return new, AdamState(mu=mu, nu=nu, count=count)


def mask_state_rows(state: AdamState, keep: torch.Tensor) -> AdamState:
    """Zero the moments of rows where ``keep`` is False (every moment
    whose leading dim matches ``keep``)."""
    n = keep.shape[0]

    def mask(x):
        if x.dim() >= 1 and x.shape[0] == n:
            k = keep.reshape((n,) + (1,) * (x.dim() - 1))
            return torch.where(k, x, torch.zeros_like(x))
        return x

    return AdamState(mu={k: mask(v) for k, v in state.mu.items()},
                     nu={k: mask(v) for k, v in state.nu.items()},
                     count=state.count)
