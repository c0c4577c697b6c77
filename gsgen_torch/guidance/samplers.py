"""The ``guidance.scheduler`` block: training schedule and sampler choice.

Port of the configuration half of the JAX package's
``guidance/samplers.py`` (``SamplerConfig``, ``resolve_scheduler``),
which ``SDSGuidance`` reads when a config sets ``guidance.scheduler``.
The sampling loops (DDIM, PNDM, ancestral, ``cfg_sample``), used only by
the trainer's guidance-eval images, are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from .diffusion import NoiseSchedule, scaled_linear_schedule


@dataclasses.dataclass(frozen=True)
class SamplerConfig:
    """guidance.scheduler block (conf/guidance/sd_pndm.yaml shape)."""

    type: str = "ddim"            # ddim | pndm | ancestral
    num_steps: int = 25
    eta: float = 0.0              # DDIM stochasticity (0 = deterministic)
    steps_offset: int = 1         # diffusers SD schedulers' offset


def resolve_scheduler(sched_d: Optional[dict],
                      default_schedule: Optional[NoiseSchedule] = None):
    """guidance.scheduler config block -> (NoiseSchedule, SamplerConfig).

    The block carries the training schedule's beta parameters
    (beta_start/end/schedule, num_train_timesteps) and the sampling loop's
    type; missing keys fall back to SD's scaled_linear defaults.
    """
    d = dict(sched_d or {})
    if any(k in d for k in ("beta_start", "beta_end", "num_train_timesteps",
                            "beta_schedule")) or default_schedule is None:
        kind = d.get("beta_schedule", "scaled_linear")
        if kind != "scaled_linear":
            raise ValueError(f"beta_schedule {kind!r}: only the SD "
                             "scaled_linear schedule is wired")
        schedule = scaled_linear_schedule(
            int(d.get("num_train_timesteps", 1000)),
            float(d.get("beta_start", 0.00085)),
            float(d.get("beta_end", 0.012)))
    else:
        schedule = default_schedule
    scfg = SamplerConfig(type=d.get("type", "ddim"),
                         num_steps=int(d.get("num_steps", 25)),
                         eta=float(d.get("eta", 0.0)),
                         steps_offset=int(d.get("steps_offset", 1)))
    return schedule, scfg


def cfg_sample(*args, **kwargs):
    """CFG sampling from pure noise: not ported yet."""
    raise NotImplementedError("guidance sampling loops (cfg_sample) wait "
                              "for the guidance-eval slice")
