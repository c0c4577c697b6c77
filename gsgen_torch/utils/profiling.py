"""Profiling: torch.profiler traces of chosen steps and field statistics.

Port of the JAX package's ``utils/profiling.py``: :func:`trace` captures a
``torch.profiler`` trace (the JAX package's XLA trace of
``trainer.profile_steps``) and writes it as a Chrome trace, viewable in
Perfetto (ui.perfetto.dev) or ``chrome://tracing``; :func:`field_stats`
is the scalar form of per-field histograms.
"""

from __future__ import annotations

import contextlib
from pathlib import Path
from typing import Dict

import torch


@contextlib.contextmanager
def trace(logdir, name: str = "trace", cuda: bool = False):
    """Profile the block (host ops, and the card's kernels when ``cuda``)
    and write ``<logdir>/<name>.json``, a Chrome trace.  The caller
    synchronises the card before leaving the block."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    out = Path(logdir)
    out.mkdir(parents=True, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(str(out / f"{name}.json"))


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
