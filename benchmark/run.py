"""Run one cell of the port's benchmark once.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``.  A run builds
the trainer through the port's entry (``gsgen_torch.config``) from the
cell's traffic file, puts weights drawn from the seed into the UNet and
the VAE, drives the first steps (the ones the check compares) and a few
more, then trains back to back through ``Trainer.fit`` for ``--seconds``
with one synchronisation at the end.  With ``--trace 1`` a few more steps
then run under ``torch.profiler`` with the benchmark's spans, and the
per-layer metrics are read from them.  After the window the
program is freed, the reference follows the same first steps from the
same seed, and the last line of standard output is the result.

Exit codes: 0 with a result; 2 when no card or too few cards are found;
3 when JAX or the JAX package was loaded.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Dict  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "gsgen_tpu")
GIB = float(1 << 30)


def forbidden_modules():
    """Top-level names of loaded modules that the benchmark may not load,
    compared whole (``gsgen_torch`` is not ``gsgen_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def _json(path: Path) -> Dict:
    return json.loads(path.read_text())


def load_cell(root: Path, workload: str) -> Dict:
    """The cell's manifest entries and files, found by name under
    ``<root>/benchmark/``: ``traffic/<traffic>.json`` and
    ``workloads/<cell>.json`` (the check's limits); the configuration's
    file is the manifest's ``file``."""
    man = _json(root / "BENCHMARK.json")
    by = {w["name"]: w for w in man["workloads"]}
    if workload not in by:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    w = by[workload]
    conf = next(c for c in man["configs"] if c["name"] == w["config"])
    e2e = [m for m in man["end_to_end"]
           if workload in m.get("workloads", [workload])]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in man["per_layer"]
                 if (workload in m["workloads"] if "workloads" in m
                     else m["moves"] in names)]
    return dict(workload=w, e2e=e2e, per_layer=per_layer,
                model=_json(root / conf["file"]),
                traffic=_json(root / "benchmark" / "traffic"
                              / f"{w['traffic']}.json"),
                limits=_json(root / "benchmark" / "workloads"
                             / f"{workload}.json")["limits"])


def reader(root: Path, name: str):
    """The ``read`` of ``benchmark/metrics/<name>.py``: ``read(ctx)``
    returns the metric's number, or None where the run holds nothing to
    read (:mod:`.readers` says what ``ctx`` holds)."""
    path = root / "benchmark" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"benchmark_metric_{len(sys.modules)}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,"
             "clocks.max.sm,temperature.gpu", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi: {e}"


def run_cell(root: Path, workload: str, seed: int, seconds: float,
             trace: bool, device: str = "cuda", log=print) -> Dict:
    """One run; returns the result's dict (the ``compared`` key last)."""
    import torch

    from . import check, kinds

    cell = load_cell(root, workload)
    tr = cell["traffic"]
    kind = kinds.load(tr["kind"])
    cuda = device == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    prog = kind.Program(root, cell, seed, device)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    checked = check.program_steps(prog, tr["check_steps"])
    for _ in range(tr["warm_steps"]):
        prog.step()
    sync()
    setup_s = time.perf_counter() - T0

    tw = time.perf_counter()
    n = 0
    while n < 2 or time.perf_counter() - tw < seconds:
        prog.step()
        n += 1
    sync()
    window_s = time.perf_counter() - tw
    step_s = window_s / n
    if trace:
        # profiled after the timed steps: a process that has run the
        # profiler steps 2-7% slower afterwards
        from torch.profiler import ProfilerActivity, profile, record_function

        from .trace import PREFIX, WINDOW, read_events
        acts = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if cuda else [])
        with prog.instrument(), profile(activities=acts) as prof:
            t_tr = time.perf_counter()
            with record_function(PREFIX + WINDOW):
                for _ in range(tr["trace_steps"]):
                    prog.step()
                sync()
            traced_s = time.perf_counter() - t_tr
    peak = torch.cuda.max_memory_allocated() if cuda else 0

    metrics = {}
    dev_info = dict(platform="gpu" if cuda else "cpu",
                    kind=torch.cuda.get_device_name(0) if cuda else "cpu",
                    count=1, memory_peak_bytes=int(peak))
    ctx = dict(setup_s=setup_s, peak_bytes=peak, step_s=step_s, steps=n,
               window_s=window_s, model=cell["model"], traffic=tr)
    breakdown = None
    if trace:
        ev = read_events(prof)
        del prof
        ctx.update(trace=ev, traced_steps=tr["trace_steps"],
                   flops=prog.flops())
        dev_info.update(busy_s=ev["busy_s"], window_s=ev["window_s"])
        breakdown = dict(
            device_ops=sorted(([k, v] for k, v in ev["kernel_s"].items()),
                              key=lambda kv: -kv[1])[:10],
            idle_gaps=sorted(([k, v] for k, v in ev["idle_gaps"].items()),
                             key=lambda kv: -kv[1])[:10])
        log(f"trace: {tr['trace_steps']} steps in {traced_s:.4f} s, "
            f"device busy {ev['busy_s']:.4f} s of {ev['window_s']:.4f} s, "
            f"{ev['n_device_ops']} device ops, "
            f"{ev['n_unattributed']} unattributed; parts (s): "
            f"{json.dumps(ev['part_s'])}; tags (s): "
            f"{json.dumps(ev['tag_s'])}", file=sys.stderr)
    for m in cell["per_layer"] if trace else cell["e2e"]:
        v = reader(root, m["name"])(ctx)
        if v is None and not trace:
            raise RuntimeError(f"no reading for {m['name']}")
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    log(f"window: {n} steps in {window_s:.4f} s ({1e3 * step_s:.3f} ms a "
        f"step), setup {setup_s:.3f} s, peak {peak / GIB:.4f} GiB",
        file=sys.stderr)

    # the reference, after the window, with the program freed
    spec = prog.spec
    del prog
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    ref = kind.Reference(cell, spec, seed, device, {})
    ref_out = ref.run(tr["check_steps"])
    numbers = check.compare(checked, ref_out, ref.judges())
    del ref
    log(f"reference: {tr['check_steps']} steps in "
        f"{time.perf_counter() - t_ref:.2f} s, process peak "
        f"{(torch.cuda.max_memory_allocated() if cuda else 0) / GIB:.3f} GiB",
        file=sys.stderr)

    compared = {k: {"value": numbers[k]["value"], "limit": lim}
                for k, lim in cell["limits"].items()}
    correct = all(c["value"] <= c["limit"] for c in compared.values())
    # steps the window attempted; a step that fails raises
    result = dict(correct=correct,
                  attempted=n + (tr["trace_steps"] if trace else 0),
                  failed=0, metrics=metrics, device=dev_info)
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["compared"] = compared
    # the numbers without a limit of this cell, then those compared, last
    for k in sorted(numbers, key=lambda k: (k in compared, k)):
        lim = cell["limits"].get(k)
        log(f"{'compared' if lim is not None else 'read'} {k}: "
            f"{numbers[k]['value']!r} limit {lim!r} "
            f"(at {numbers[k]['at']})", file=sys.stderr)
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    root = Path.cwd()
    cell = load_cell(root, a.workload)
    import torch
    chips = int(cell["workload"]["chips"])
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < chips:
        print(f"needs {chips} CUDA device(s); found {found}",
              file=sys.stderr)
        return 2
    print(f"card: {card_line()}", file=sys.stderr)
    result = run_cell(root, a.workload, a.seed, a.seconds, bool(a.trace))
    bad = forbidden_modules()
    if bad:
        print(f"loaded modules the benchmark may not load: {bad}",
              file=sys.stderr)
        return 3
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
