"""Field statistics for the training logs.

Port of ``field_stats`` of the JAX package's ``utils/profiling.py``: the
scalar form of per-field histograms.  Its XLA trace capture
(``profile_steps``) is not ported: the port's traces come from
``torch.profiler`` (``chip_smoke.py``).
"""

from __future__ import annotations

from typing import Dict

import torch


@torch.no_grad()
def field_stats(tree: Dict[str, torch.Tensor], prefix: str = "fields"
                ) -> Dict[str, float]:
    """min / max / mean / rms of each tensor of a {name: tensor} dict,
    brought to the host in one transfer."""
    dense = {k: v for k, v in tree.items() if v is not None and v.dim() > 0}
    if not dense:
        return {}
    names, stats = [], []
    for name, x in dense.items():
        x = x.to(torch.float32)
        names += [f"{prefix}/{name}/{s}" for s in ("min", "max", "mean",
                                                   "rms")]
        stats += [x.min(), x.max(), x.mean(), torch.sqrt(torch.mean(x * x))]
    return dict(zip(names, torch.stack(stats).cpu().tolist()))
