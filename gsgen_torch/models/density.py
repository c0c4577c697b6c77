"""Densify / prune schedule configuration.

The configs and the host-side trigger of the JAX package's
``models/density.py``; the densify and prune events themselves are the
next slice of the port, so the trainer raises ``NotImplementedError``
when one comes due.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class DensifyConfig:
    enabled: bool = True
    type: str = "official"
    warm_up: int = 2000
    end: int = 9999
    period: int = 1000
    mean2d_thresh: float = 0.02
    split_thresh: float = 0.02
    n_splits: int = 2
    split_shrink: float = 0.8
    use_legacy: bool = True
    K: int = 3
    surface_shrink: float = 1.5
    scale_max: float = 0.1


@dataclasses.dataclass(frozen=True)
class PruneConfig:
    enabled: bool = False
    warm_up: int = 0
    end: int = 0
    period: int = 500
    radii2d_thresh: float = 1000.0
    alpha_thresh: float = 1000.0
    radii3d_thresh: float = 0.0


def should_run(step: int, enabled: bool, warm_up: int, end: int,
               period: int) -> bool:
    """Whether a densify/prune event is due at ``step``."""
    return (enabled and warm_up <= step <= end and period > 0
            and step % period == 0)
