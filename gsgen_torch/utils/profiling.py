"""Profiling: torch.profiler traces of chosen steps, the program's spans
and counters, and field statistics.

Port of the JAX package's ``utils/profiling.py``: :func:`trace` captures a
``torch.profiler`` trace (the JAX package's XLA trace of
``trainer.profile_steps``) and writes it as a Chrome trace, viewable in
Perfetto (ui.perfetto.dev) or ``chrome://tracing``; :func:`field_stats`
is the scalar form of per-field histograms.

Spans and counters mark the train step's layers for whoever profiles it
(``profile_steps``, or any ``torch.profiler`` around the step).  While a
profiler records, :func:`span` enters a range named ``gsgen:<name>``, so
the trace holds the span on the clock of the device's ops and of the
runtime's launch calls; :func:`backward_span` opens and closes a span
from autograd hooks, for a layer's backward; :func:`count` adds to a
counter that :func:`counters` reads.  While none records, each reads one
flag and does nothing else: no range, no hook, no counter update.  The
spans of one step nest inside its ``gsgen:step`` span, which records the
step's index (shown as its args where the profiler records shapes).

A range is an operator-scope ``RecordFunction`` (``cpu_op`` in the
trace), not ``record_function``'s user scope: the profiler copies a
user-scope range onto the device's timeline, where a reader that counts
device work would take the copy for a kernel as long as the span.
"""

from __future__ import annotations

import contextlib
import threading
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Union

import torch
import torch.autograd.profiler as _autograd_profiler

PREFIX = "gsgen:"
_Range = torch._C._profiler._RecordFunctionFast
_OFF = contextlib.nullcontext()
_lock = threading.Lock()
# spans opened from hooks, by name, and the hooks not yet removed;
# counters by name: host numbers, and device scalars that
# :func:`counters` brings over in one transfer
_open: Dict[str, object] = {}
_hooks: List[object] = []
_host: Dict[str, int] = {}
_device: Dict[str, torch.Tensor] = {}


def recording() -> bool:
    """Whether a torch profiler records (torch sets this flag while one
    does)."""
    return _autograd_profiler._is_profiler_enabled


def span(name: str, step: Optional[int] = None):
    """A context: the range ``gsgen:<name>`` while a profiler records
    (``step``, an index, recorded with it), else a shared no-op."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    if step is None:
        return _Range(PREFIX + name)
    return _Range(PREFIX + name, [step], {"step": step})


def open(name: str) -> None:                              # noqa: A001
    """Open the range ``gsgen:<name>`` where no ``with`` block can hold
    it (an autograd hook); a span of that name already open stays as it
    is."""
    with _lock:
        if name not in _open:
            rf = _Range(PREFIX + name)
            rf.__enter__()
            _open[name] = rf


def close(name: str) -> None:
    """Close the span :func:`open` opened under ``name``, if open."""
    with _lock:
        rf = _open.pop(name, None)
    if rf is not None:
        rf.__exit__(None, None, None)


def close_all() -> None:
    """Close every span :func:`open` left open and remove the hooks of
    :func:`backward_span` that have not fired (the end of a backward)."""
    if not (_hooks or _open):
        return
    with _lock:
        hooks = list(_hooks)
        _hooks.clear()
    for h in hooks:
        h.remove()
    for name in list(_open):
        close(name)


def backward_span(name: str, outputs: Iterable[Optional[torch.Tensor]],
                  inputs: Iterable[Optional[torch.Tensor]]) -> None:
    """While a profiler records, span ``name`` over a layer's backward:
    opened once the gradient has reached every one of ``outputs`` that
    the backward reaches, closed once every such one of ``inputs`` has
    its gradient.  Tensors that need no gradient (or None) are left out;
    nothing is registered while none records."""
    if not _autograd_profiler._is_profiler_enabled:
        return
    outs = [t for t in outputs if t is not None and t.requires_grad]
    if not outs:
        return
    from torch.autograd.graph import register_multi_grad_hook
    hooks = [register_multi_grad_hook(outs, lambda _: open(name))]
    # counted by hand: a multi-grad hook cannot wait for leaves under
    # torch.autograd.grad; an input the backward never reaches leaves the
    # span to close_all
    ins = [t for t in inputs if t is not None and t.requires_grad]
    left = [len(ins)]

    def arrived(_):
        with _lock:
            left[0] -= 1
            done = left[0] == 0
        if done:
            close(name)

    hooks += [t.register_hook(arrived) for t in ins]
    with _lock:
        _hooks.extend(hooks)


def count(name: str, n: Union[int, torch.Tensor]) -> None:
    """Add ``n`` to the counter ``name`` while a profiler records: a host
    number as it is, a tensor's sum into a device accumulator (no
    synchronisation)."""
    if not _autograd_profiler._is_profiler_enabled:
        return
    if torch.is_tensor(n):
        n = n.detach().sum().to(torch.float64)
        with _lock:
            acc = _device.get(name)
            _device[name] = n if acc is None else acc + n
    else:
        with _lock:
            _host[name] = _host.get(name, 0) + n


def counters() -> Dict[str, float]:
    """Every counter (the device ones in one transfer), and the hand-
    written kernels' launch counts as ``launches.<kernel>``."""
    from ..ops import (conv, cuda_raster, expansion_rank, flash_attention,
                       gid_repack)
    with _lock:
        out = dict(_host)
        dev = dict(_device)
    if dev:
        vals = torch.stack([v.reshape(()) for v in dev.values()]).tolist()
        out.update(zip(dev, vals))
    for fn in (cuda_raster.raster_fwd, cuda_raster.raster_bwd,
               cuda_raster.raster_fwd_compact,
               cuda_raster.raster_bwd_compact, expansion_rank.expansion_gid,
               gid_repack.repack_gid, flash_attention.flash_self_attention,
               flash_attention.flash_bwd_dkv, flash_attention.flash_bwd_dq,
               conv.conv2d_3xtf32):
        out[f"launches.{fn.__name__}"] = fn.launches
    return out


def reset_counters() -> None:
    """Clear the counters (the kernels' launch counts stay)."""
    with _lock:
        _host.clear()
        _device.clear()


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
