"""The guidance interface.

Port of the JAX package's ``guidance/base.py``.  A guidance is an object
whose ``loss`` takes the rendered views and their camera metadata and
returns a dict of scalar losses (``loss_sds``, and ``loss_vsd`` /
``loss_lora`` for VSD, which the trainer weights).  Where the JAX package
passes the frozen weights and an RNG key explicitly to keep the step
jittable, the port's guidance owns its (frozen) modules and draws from a
``torch.Generator``; the trainer passes ``sched`` (host-evaluated
schedule scalars such as the annealed max t), the per-view camera
tensors, and ``train``, the trainable leaves (``trainable_params``,
VSD's LoRA and camera embedding).  Diffusion guidance never needs
gradients through its own weights.  :class:`..guidance.mock.MockGuidance`,
:class:`..guidance.sds.SDSGuidance` and :class:`..guidance.vsd.VSDGuidance`
implement it.
"""

from __future__ import annotations

from typing import Dict, Optional, Protocol, runtime_checkable

import torch


@runtime_checkable
class Guidance(Protocol):
    def loss(self, rgb: torch.Tensor, embedding, elevation: torch.Tensor,
             azimuth: torch.Tensor, camera_distance: torch.Tensor,
             generator: Optional[torch.Generator] = None,
             sched: Optional[Dict[str, float]] = None, **views
             ) -> Dict[str, torch.Tensor]:
        ...
