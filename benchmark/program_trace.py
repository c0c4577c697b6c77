"""The program's own spans in a profiled stretch: each device-idle gap put
down to the layer whose host code was running, the host's synchronising
runtime calls, and the device time under each span.

The program (``gsgen_torch/utils/profiling.py``) opens ``record_function``
ranges named ``gsgen:<name>`` while a profiler records: one ``step`` span
a train step, the layers inside it on the main thread, and the layers'
backward spans on autograd's threads.  :func:`read` reads them from a
profiler over the stretch that :data:`.trace.WINDOW` marks:

* an idle gap of the device goes to the latest-started program span, on
  any thread, that is open at the gap's start (the rule
  :func:`.trace.attribute` uses for the benchmark's spans), and that
  span's layer (:func:`layer`): the render, the guidance (the UNet, the
  VAE and their glue) or the host loop, which also takes the gaps no
  program span holds.  The three sum to the stretch's idle time;
* a synchronising runtime call (:data:`SYNCS`) goes to the innermost
  program span open on its thread, else to the latest-started one on any
  thread; calls outside every span (the harness's own) are not the
  program's;
* a device op goes to the innermost program span open on its launch
  thread, else, as a gap does, to the latest-started one on any thread.

    python3 -m benchmark.program_trace --workload <cell> --seed <n>

profiles a cell's traced steps as ``benchmark.run --trace 1`` does (the
benchmark's spans on too) and prints both readings of the same stretch.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional, Tuple

from .trace import LAUNCH_PREFIXES, PREFIX as BENCH_PREFIX, WINDOW
from .trace import _annotation, _innermost, busy_s

PREFIX = "gsgen:"
RENDER = frozenset({"render", "normals", "render_bwd"})
GUIDANCE = frozenset({"guidance", "vae", "unet", "attn", "vae_bwd",
                      "unet_bwd", "attn_bwd", "aux_guidance", "fps",
                      "estimator", "estimator_bwd"})
# runtime calls that block the host until the device catches up: the
# synchronisations, and the copy that returns only when done (a device-to-
# host read is an async copy and a stream synchronisation)
SYNCS = frozenset({"cudaStreamSynchronize", "cudaDeviceSynchronize",
                   "cudaEventSynchronize", "cudaMemcpy"})


def layer(span: Optional[str]) -> str:
    """``render``, ``guidance`` or ``loop`` (everything else, and time
    under no program span)."""
    if span in RENDER:
        return "render"
    return "guidance" if span in GUIDANCE else "loop"


def _latest_open(spans):
    """A lookup, for times that do not decrease, of the latest-started
    span on any thread that holds the time (name, or None)."""
    order = sorted(spans, key=lambda s: s[1])
    active: List = []
    nxt = [0]

    def find(t):
        while nxt[0] < len(order) and order[nxt[0]][1] <= t:
            active.append(order[nxt[0]])
            nxt[0] += 1
        while active and active[-1][2] < t:
            active.pop()
        for s in reversed(active):
            if s[2] >= t:
                return s[0]
        return None
    return find


def attribute(dev, launch, spans, syncs, window=None) -> Dict:
    """The reading of a stretch.  ``dev`` holds (name, start, end,
    correlation) of each device op, ``launch`` (start, thread) of each
    launch by correlation, ``spans`` (name, start, end, thread) of the
    program's spans, ``syncs`` (call, start, thread) of each synchronising
    call; seconds.  ``window`` (start, end) is the stretch, else the device
    ops' extent.  Times are totals over the stretch."""
    if not dev:
        raise RuntimeError("the profiler saw no device work")
    intervals = sorted((a, b) for _, a, b, _ in dev)
    t0, t1 = window or (intervals[0][0], max(b for _, b in intervals))
    clipped = [(max(a, t0), min(b, t1)) for a, b in intervals
               if b > t0 and a < t1]
    busy = busy_s(clipped)

    # the idle gaps, in time order, by the span open at each one's start
    latest = _latest_open(spans)
    idle_by_span: Dict[str, float] = {}
    end = t0
    for a, b in clipped + [(t1, t1)]:
        if a > end:
            name = latest(end) or "none"
            idle_by_span[name] = idle_by_span.get(name, 0.0) + (a - end)
        end = max(end, b)
    idle = {"render": 0.0, "guidance": 0.0, "loop": 0.0}
    for name, s in idle_by_span.items():
        idle[layer(name)] += s

    own = _innermost(spans)

    def holder(ts, tid, any_thread):
        return own(ts, tid) or any_thread(ts)

    # device ops by the span that launched them, in launch order
    ops = sorted(((launch[c], a, b) for _, a, b, c in dev
                  if c in launch and t0 <= launch[c][0] <= t1),
                 key=lambda o: o[0][0])
    latest = _latest_open(spans)
    by_span: Dict[str, list] = {}
    for (ts, tid), a, b in ops:
        by_span.setdefault(holder(ts, tid, latest) or "none",
                           []).append((a, b))
    latest = _latest_open(spans)
    found = []
    for call, ts, tid in sorted((s for s in syncs if t0 <= s[1] <= t1),
                                key=lambda s: s[1]):
        found.append((call, holder(ts, tid, latest)))
    return dict(
        window_s=t1 - t0, busy_s=busy, idle_s=idle, idle_by_span=idle_by_span,
        device_s={k: busy_s(v) for k, v in by_span.items()},
        steps=sum(1 for s in spans if s[0] == "step" and t0 <= s[1] <= t1),
        syncs=[s for s in found if s[1] is not None],
        syncs_outside=sum(1 for s in found if s[1] is None))


def read(prof) -> Dict:
    """:func:`attribute` over a ``torch.profiler`` run's events, the
    stretch being the benchmark's window span where it has one."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    dev, launch, spans, syncs, window = [], {}, [], [], None
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        t0, t1 = e.start_ns() / 1e9, (e.start_ns() + e.duration_ns()) / 1e9
        if e.device_type() == cuda:
            # a span's copy on the device's timeline is no device work
            if not _annotation(e):
                dev.append((name, t0, t1, (e.correlation_id(),
                                           e.linked_correlation_id())))
            continue
        if name.startswith(PREFIX):
            spans.append((name[len(PREFIX):], t0, t1, e.start_thread_id()))
        elif name == BENCH_PREFIX + WINDOW:
            window = (t0, t1)
        elif name.startswith(LAUNCH_PREFIXES):
            launch[e.correlation_id()] = (t0, e.start_thread_id())
            if name in SYNCS:
                syncs.append((name, t0, e.start_thread_id()))
    dev = [(n, a, b, c[0] if c[0] in launch else c[1]) for n, a, b, c in dev]
    return attribute(dev, launch, spans, syncs, window)


def dups_per_view() -> Optional[float]:
    """K1-K4's duplicates per rendered view, from the program's counters
    over what a profiler recorded; None where the program counts none."""
    try:
        from gsgen_torch.utils.profiling import counters
    except ImportError:
        return None
    c = counters()
    views = c.get("render.views")
    return c["render.dups"] / views if views else None


# the benchmark's parts and the program's spans that cover the same work
PAIRS = (("render", ("render", "render_bwd")),
         ("vae", ("vae", "vae_bwd")),
         ("unet_fwd", ("unet", "attn")),
         ("unet_bwd", ("unet_bwd", "attn_bwd")),
         ("attn", ("attn", "attn_bwd")))


def compare(bench: Dict, prog: Dict, steps: int) -> Dict[str, Tuple]:
    """Device ms a step of each part by the benchmark's spans and by the
    program's (ops under several program spans of a part counted once per
    span: they do not overlap on one stream)."""
    out = {}
    for part, names in PAIRS:
        b = (bench["tag_s"] if part == "attn" else bench["part_s"]).get(part)
        p = sum(prog["device_s"].get(n, 0.0) for n in names)
        if b or p:
            out[part] = (1e3 * (b or 0.0) / steps, 1e3 * p / steps)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--timed-steps", type=int, default=5)
    a = ap.parse_args(argv)
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from gsgen_torch.utils import profiling

    from . import kinds
    from .run import load_cell
    from .trace import read_events

    root = Path.cwd()
    cell = load_cell(root, a.workload)
    tr = cell["traffic"]
    prog = kinds.load(tr["kind"]).Program(root, cell, a.seed, "cuda")
    for _ in range(tr["check_steps"] + tr["warm_steps"]):
        prog.step()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(a.timed_steps):
        prog.step()
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t) / a.timed_steps
    profiling.reset_counters()
    n = tr["trace_steps"]
    with prog.instrument(), profile(activities=[
            ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        with record_function(BENCH_PREFIX + WINDOW):
            for _ in range(n):
                prog.step()
            torch.cuda.synchronize()
        traced_s = time.perf_counter() - t
    bench, mine = read_events(prof), read(prof)
    del prof
    ms = lambda s: 1e3 * s / n                               # noqa: E731
    launched = sum(mine["device_s"].values())
    syncs: Dict[str, int] = {}
    for call, span in mine["syncs"]:
        syncs[f"{call}@{span}"] = syncs.get(f"{call}@{span}", 0) + 1
    line = dict(
        workload=a.workload, seed=a.seed, steps=n, spans_steps=mine["steps"],
        untraced_ms=1e3 * step_s, traced_ms=1e3 * traced_s / n,
        busy_ms=ms(mine["busy_s"]),
        idle_ms={k: ms(v) for k, v in mine["idle_s"].items()},
        stretch_idle_ms=ms(mine["window_s"] - mine["busy_s"]),
        bench_idle_ms={k: ms(v) for k, v in bench["idle_gaps"].items()},
        idle_by_span_ms={k: ms(v) for k, v in sorted(
            mine["idle_by_span"].items(), key=lambda kv: -kv[1])},
        outside_share=(mine["device_s"].get("none", 0.0) / launched
                       if launched else None),
        host_syncs=len(mine["syncs"]) / n, syncs=syncs,
        syncs_outside=mine["syncs_outside"],
        render_dups=dups_per_view(),
        device_ms={k: ms(v) for k, v in sorted(
            mine["device_s"].items(), key=lambda kv: -kv[1])},
        bench_vs_program_ms=compare(bench, mine, n))
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
