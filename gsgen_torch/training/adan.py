"""Adan optimizer (Adaptive Nesterov Momentum, arXiv 2208.06677).

Port of the JAX package's ``training/adan.py`` (reference
utils/optimizers.py:23-300 in gsgen3d/gsgen) over a dict of tensors, the
same update rule in the reference's convention:

  m_t = (1-b1) m + b1 g
  v_t = (1-b2) v + b2 (g - g_prev)            (g - g_prev = 0 at count 1)
  n_t = (1-b3) n + b3 (g + (1-b2)(g - g_prev))^2
  p  -= lr / (sqrt(n_t / c3) + eps) * (m_t / c1 + (1-b2) v_t / c2)

with ``c_i = 1 - (1 - b_i)^t`` as float32 powers, and decoupled weight
decay (``p * (1 - lr * weight_decay)`` before the step).  No config
selects it, in either package.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch

Tensors = Dict[str, torch.Tensor]


@dataclasses.dataclass
class AdanState:
    m: Tensors
    v: Tensors
    n: Tensors
    g_prev: Tensors
    count: int      # steps taken


def adan_init(params: Tensors) -> AdanState:
    def z():
        return {k: torch.zeros_like(p) for k, p in params.items()}
    return AdanState(m=z(), v=z(), n=z(), g_prev=z(), count=0)


@torch.no_grad()
def adan_update(grads: Tensors, state: AdanState, params: Tensors, lr,
                b1: float = 0.98, b2: float = 0.92, b3: float = 0.99,
                eps: float = 1e-8, weight_decay: float = 0.0):
    """One Adan step; returns (new_params, new_state)."""
    count = state.count + 1
    dev = next(iter(params.values())).device
    t = torch.tensor(float(count), dtype=torch.float32, device=dev)

    def corr(b):
        return 1.0 - torch.tensor(1.0 - b, dtype=torch.float32,
                                  device=dev) ** t

    c1, c2, c3 = corr(b1), corr(b2), corr(b3)
    m, v, n, new = {}, {}, {}, {}
    for k, p in params.items():
        g = grads[k]
        gd = torch.zeros_like(g) if count == 1 else g - state.g_prev[k]
        m[k] = (1 - b1) * state.m[k] + b1 * g
        v[k] = (1 - b2) * state.v[k] + b2 * gd
        u = g + (1 - b2) * gd
        n[k] = (1 - b3) * state.n[k] + b3 * u * u
        step = (m[k] / c1 + (1 - b2) * v[k] / c2) / (
            torch.sqrt(n[k] / c3) + eps)
        new[k] = p * (1.0 - lr * weight_decay) - lr * step
    return new, AdanState(m=m, v=v, n=n, g_prev=dict(grads), count=count)
