"""The reading of the program's own spans on a canned event list: the
idle time split by layer, the synchronising calls by span, the device
time by span, and the duplicates reader on the program's counters."""

from __future__ import annotations

import importlib.util
from pathlib import Path

import pytest
from torch.profiler import ProfilerActivity, profile

from benchmark import program_trace as pt

ROOT = Path(__file__).resolve().parents[2]
MAIN, BWD = 1, 2
# one step: the render, the guidance with a UNet call, the backward with
# the render's backward on autograd's thread, then the bucket read
SPANS = [("step", 0.0, 9.0, MAIN), ("render", 1.0, 2.0, MAIN),
         ("guidance", 2.0, 5.0, MAIN), ("unet", 3.0, 5.0, MAIN),
         ("backward", 5.5, 8.0, MAIN), ("render_bwd", 6.0, 7.5, BWD),
         ("sync", 8.2, 8.6, MAIN)]
LAUNCH = {1: (1.5, MAIN), 2: (3.5, MAIN), 3: (6.5, BWD), 4: (7.8, BWD),
          5: (8.3, MAIN), 6: (9.2, MAIN)}
# device ops (name, start, end, correlation); op 4 is backward glue
# launched outside every span of its thread, op 6 after the step
DEV = [("k_render", 1.6, 2.1, 1), ("k_unet", 3.6, 4.6, 2),
       ("k_render_bwd", 6.6, 7.0, 3), ("k_glue", 7.9, 8.0, 4),
       ("memcpy_dtoh", 8.3, 8.4, 5), ("k_after", 9.3, 9.4, 6)]
SYNCS = [("cudaStreamSynchronize", 8.35, MAIN),
         ("cudaDeviceSynchronize", 9.6, MAIN)]


def test_idle_split_by_layer_sums_to_the_stretch_idle():
    r = pt.attribute(DEV, LAUNCH, SPANS, SYNCS, (0.0, 10.0))
    assert r["busy_s"] == pytest.approx(2.2)
    assert sum(r["idle_s"].values()) == pytest.approx(
        r["window_s"] - r["busy_s"])
    # gaps from 4.6 (the UNet), 2.1 (guidance), 7.0 (the render's
    # backward on the other thread, the latest started), the rest loop
    assert r["idle_s"]["guidance"] == pytest.approx(2.0 + 1.5)
    assert r["idle_s"]["render"] == pytest.approx(0.9)
    by = r["idle_by_span"]
    assert by["step"] == pytest.approx(1.6)
    assert by["backward"] == pytest.approx(0.3)
    assert by["sync"] == pytest.approx(0.9)
    assert by["none"] == pytest.approx(0.6)       # after the step
    assert r["steps"] == 1
    # without a window: the device ops' extent
    r = pt.attribute(DEV, LAUNCH, SPANS, SYNCS)
    assert r["window_s"] == pytest.approx(9.4 - 1.6)
    assert sum(r["idle_s"].values()) == pytest.approx(
        r["window_s"] - r["busy_s"])


def test_a_sync_is_counted_under_its_span():
    r = pt.attribute(DEV, LAUNCH, SPANS, SYNCS, (0.0, 10.0))
    assert r["syncs"] == [("cudaStreamSynchronize", "sync")]
    assert r["syncs_outside"] == 1                 # the harness's own
    # outside the stretch it is not counted
    r = pt.attribute(DEV, LAUNCH, SPANS, SYNCS, (0.0, 8.0))
    assert r["syncs"] == [] and r["syncs_outside"] == 0


def test_device_time_by_the_span_that_launched_it():
    d = pt.attribute(DEV, LAUNCH, SPANS, SYNCS, (0.0, 10.0))["device_s"]
    assert d["render"] == pytest.approx(0.5)
    assert d["unet"] == pytest.approx(1.0)
    assert d["render_bwd"] == pytest.approx(0.4)
    # no span of its thread holds the glue: the main thread's backward
    assert d["backward"] == pytest.approx(0.1)
    assert d["none"] == pytest.approx(0.1)
    assert [pt.layer(n) for n in ("vae_bwd", "attn", "render_bwd",
                                  "adam", None)] == [
        "guidance", "guidance", "render", "loop", "loop"]


def _reader(name):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "benchmark" / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def test_dups_readers_read_the_program_counters():
    import torch

    from gsgen_torch.utils import profiling
    profiling.reset_counters()
    for k in ("vsd", "sds"):
        assert _reader(f"render_dups.{k}")({}) is None
    profiling.count("render.dups", torch.tensor([5, 7]))  # not recording
    assert "render.dups" not in profiling.counters()
    with profile(activities=[ProfilerActivity.CPU]):
        for n in ([10, 20], [30, 40]):
            profiling.count("render.views", 2)
            profiling.count("render.dups", torch.tensor(n))
    for k in ("vsd", "sds"):
        assert _reader(f"render_dups.{k}")({}) == pytest.approx(25.0)
    profiling.reset_counters()
