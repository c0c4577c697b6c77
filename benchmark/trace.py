"""Spans around the program's layers, and the reading of a profiled
stretch of steps.

The spans are ``record_function`` ranges that a kind's ``instrument``
puts around the program's layers from the benchmark's side (the program
has no spans of its own).  A span names a part (``render``, ``vae``,
``unet_fwd``, ...) or, under the prefix :data:`TAG`, a tag (``attn``)
that cuts across the parts.

:func:`read_events` attributes each device op to the innermost part span
open on the thread that launched it; launches from the backward threads
outside any part span are the render's backward, the rest is ``other``.
An op carries a tag when a span of that tag on its launch thread holds
its launch.  A part's or a tag's device time is the union of its ops'
spans, because cuDNN runs some convolutions on side streams.  This
arithmetic is a copy of ``chip_smoke.py::profile_step`` at commit
0ee71fa, over a window of steps and with the events read in memory.
"""

from __future__ import annotations

import bisect
import math
from typing import Dict, List, Tuple

from .peaks import kernel_key

PREFIX = "bench:"
# the runtime and driver calls that launch device work
LAUNCH_PREFIXES = ("cuda", "cuLaunch", "cuMemcpy", "cuMemset")
# the span around the whole profiled stretch
WINDOW = "window"
# spans named TAG + <tag> mark a tag, not a part
TAG = "tag."


def busy_s(intervals: List[Tuple[float, float]]) -> float:
    """Length of the union of [start, end) intervals."""
    busy, end = 0.0, -math.inf
    for a, b in sorted(intervals):
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
    return busy


class Spans:
    """Spans opened and closed by name from autograd hooks, where no
    ``with`` block can hold them; a span already open stays as it is."""

    def __init__(self):
        self._open = {}

    def open(self, name: str) -> None:
        from torch.profiler import record_function
        if name not in self._open:
            self._open[name] = record_function(PREFIX + name)
            self._open[name].__enter__()

    def close(self, name: str) -> None:
        if name in self._open:
            self._open.pop(name).__exit__(None, None, None)

    def close_all(self) -> None:
        for name in list(self._open):
            self.close(name)


def _annotation(e) -> bool:
    """A user annotation (a ``record_function`` range) on either side;
    torch 2.11's events have no ``activity_type``, newer ones do."""
    if e.name().startswith(PREFIX):
        return True
    kind = getattr(e, "activity_type", None)
    return kind is not None and "annotation" in str(kind()).lower()


def _events_in_memory(prof):
    """(device ops, launches by correlation, spans) from the profiler's
    own event list, times in seconds (no trace file is written); None if
    it holds no device op with a recorded launch."""
    import torch
    evs = prof.profiler.kineto_results.events()
    dev, launch, spans = [], {}, []
    for e in evs:
        t0, dur = e.start_ns() / 1e9, e.duration_ns() / 1e9
        if _annotation(e):
            # a span's copy on the device's timeline is no device work
            if e.device_type() != torch.autograd.DeviceType.CUDA and \
                    e.name().startswith(PREFIX):
                spans.append((e.name()[len(PREFIX):], t0, t0 + dur,
                              e.start_thread_id()))
        elif e.device_type() == torch.autograd.DeviceType.CUDA:
            dev.append((e.name(), t0, t0 + dur,
                        (e.correlation_id(), e.linked_correlation_id())))
        elif e.name().startswith(LAUNCH_PREFIXES):
            launch[e.correlation_id()] = (t0, e.start_thread_id())
    dev = [(n, a, b, c[0] if c[0] in launch else c[1])
           for n, a, b, c in dev]
    if not dev or not any(d[3] in launch for d in dev):
        return None
    return dev, launch, spans


def read_events(prof) -> Dict:
    """:func:`attribute` over a profiler's events."""
    got = _events_in_memory(prof)
    if got is None:
        raise RuntimeError("the profiler saw no device op, or none whose "
                           "launch it recorded")
    return attribute(*got)


def _innermost(spans):
    """A lookup (time, thread) -> the name of the innermost span (the
    latest started) on that thread that holds the time, or None."""
    by_tid: Dict = {}
    for name, a, b, tid in sorted(spans, key=lambda s: s[1]):
        by_tid.setdefault(tid, []).append((a, b, name))
    starts = {tid: [a for a, _, _ in v] for tid, v in by_tid.items()}

    def find(ts, tid):
        v = by_tid.get(tid, ())
        for i in range(bisect.bisect_right(starts.get(tid, ()), ts) - 1,
                       -1, -1):
            if v[i][1] >= ts:
                return v[i][2]
        return None
    return find


def attribute(dev, launch, spans) -> Dict:
    """A profiled stretch, read: device ops by part, by tag and by
    kernel, the busy time, and the idle gaps by the host span they fell
    in.  ``dev`` holds (name, start, end, correlation) of each device op,
    ``launch`` (start, thread) of each launch by correlation, ``spans``
    (name, start, end, thread) of the benchmark's spans; seconds.  The
    stretch is the :data:`WINDOW` span, or else the device ops' extent."""
    if not dev:
        raise RuntimeError("the profiler saw no device work")
    window = [(a, b) for name, a, b, _ in spans if name == WINDOW]
    parts = [s for s in spans if s[0] != WINDOW and not s[0].startswith(TAG)]
    tag_spans = {}
    for s in spans:
        if s[0].startswith(TAG):
            tag_spans.setdefault(s[0][len(TAG):], []).append(s)
    bwd_tids = {tid for name, _, _, tid in parts if name == "vae_bwd"}
    part_of = _innermost(parts)
    in_tag = {t: _innermost(v) for t, v in tag_spans.items()}

    def part(hit):
        if hit is None:
            return "unattributed"
        inner = part_of(*hit)
        if inner is not None:
            return "vae" if inner.startswith("vae") else inner
        return "render" if hit[1] in bwd_tids else "other"

    by_part: Dict[str, list] = {}
    by_tag: Dict[str, list] = {t: [] for t in tag_spans}
    by_kernel: Dict[str, float] = {}
    for name, a, b, corr in dev:
        hit = launch.get(corr)
        by_part.setdefault(part(hit), []).append((a, b))
        for t, find in in_tag.items():
            if hit is not None and find(*hit) is not None:
                by_tag[t].append((a, b))
        key = kernel_key(name)
        by_kernel[key] = by_kernel.get(key, 0.0) + (b - a)
    intervals = sorted((a, b) for _, a, b, _ in dev)
    t_start, t_end = (window[0] if window else
                      (intervals[0][0], max(b for _, b in intervals)))
    intervals = [(max(a, t_start), min(b, t_end)) for a, b in intervals
                 if b > t_start and a < t_end]
    gaps, end = {}, t_start
    for a, b in intervals + [(t_end, t_end)]:
        if a > end:
            inner = None
            for name, sa, sb, _ in parts:
                if sa <= end <= sb and (inner is None or sa > inner[1]):
                    inner = (name, sa)
            host = "host:" + (inner[0] if inner else "loop")
            gaps[host] = gaps.get(host, 0.0) + (a - end)
        end = max(end, b)
    return dict(
        busy_s=busy_s(intervals), window_s=t_end - t_start,
        part_s={k: busy_s(v) for k, v in by_part.items()},
        tag_s={k: busy_s(v) for k, v in by_tag.items()},
        kernel_s=by_kernel, idle_gaps=gaps, n_device_ops=len(dev),
        n_unattributed=len(by_part.get("unattributed", [])))
