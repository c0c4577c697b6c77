"""The train step's spans and counters (``gsgen_torch/utils/profiling.py``)
under a CPU ``torch.profiler``, and their absence without one.

One tiny VSD trainer (the TINY UNet and VAE, 64 Gaussians, two 16² views)
with a Point-E auxiliary guidance, a TINY DPT depth estimator and a
densify event at step 0 reaches every span of the step: its first step
is profiled, its second runs with no profiler.
"""

from __future__ import annotations

from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import gsgen_torch.training.trainer as trainer_mod
from gsgen_torch.config import build_trainer, load_config
from gsgen_torch.guidance.point_e_aux import (PointEAuxConfig,
                                              PointEAuxGuidance)
from gsgen_torch.priors.dpt import TINY_DPT, DPTEstimator, DPTHybrid
from gsgen_torch.utils import profiling

ROOT = Path(__file__).resolve().parents[1]
OVERRIDES = ["init.num_points=64", "init.capacity=128", "data.reso=[16]",
             "renderer.tile_size=8", "renderer.chunk=128",
             "renderer.dup_cap=4096", "trainer.batch_size=2",
             "guidance.backbone_preset=tiny", "prompt.use_cache=false",
             "renderer.densify.warm_up=0", "renderer.densify.period=1"]
# every span of the step; `step` holds the ones on the main thread
SPANS = {"step", "cameras", "background", "render", "guidance", "vae",
         "unet", "attn", "aux_guidance", "fps", "estimator", "losses",
         "backward", "unet_bwd", "vae_bwd", "attn_bwd", "render_bwd",
         "estimator_bwd", "adam", "stats", "sync", "density"}


@pytest.fixture(scope="module")
def traced():
    """The trainer, its first step's spans as {name: [(start, end)]} in
    µs (the step's span records its index), the n_dup of its renders and
    the counters after it."""
    cfg = load_config([ROOT / "configs/base.yaml",
                       ROOT / "configs/guidance/vsd.yaml",
                       ROOT / "configs/prompt/vsd.yaml"], OVERRIDES)
    tr = build_trainer(cfg, device="cpu")
    tr.aux_guidance = PointEAuxGuidance(
        PointEAuxConfig(num_points=32, batch_size=1), device="cpu")
    tr.estimators = {"depth": DPTEstimator(DPTHybrid(TINY_DPT).eval())}
    n_dup = []
    render = trainer_mod.render_batch

    def recorded(*a, **kw):
        out = render(*a, **kw)
        n_dup.append(out["n_dup"].detach().clone())
        return out

    profiling.reset_counters()
    trainer_mod.render_batch = recorded
    try:
        with profile(activities=[ProfilerActivity.CPU],
                     record_shapes=True) as prof:
            tr.fit(1)
    finally:
        trainer_mod.render_batch = render
    spans, steps = {}, []
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith(profiling.PREFIX):
            name = e.name()[len(profiling.PREFIX):]
            spans.setdefault(name, []).append(
                (e.start_ns() / 1e3, (e.start_ns() + e.duration_ns()) / 1e3))
            if name == "step":
                steps.append(e.kwinputs())
    assert steps == [{"step": 0}]
    return tr, {k: sorted(v) for k, v in spans.items()}, n_dup, \
        profiling.counters()


def test_every_span_appears_and_nests_in_its_step(traced):
    _, spans, _, _ = traced
    assert set(spans) == SPANS
    (s0, s1), = spans["step"]
    for name in ("cameras", "render", "guidance", "vae", "unet", "backward",
                 "unet_bwd", "vae_bwd", "render_bwd", "adam", "stats"):
        assert all(s0 <= a <= b <= s1 for a, b in spans[name]), name
    # the bucket feedback's read in the step, the event's after it
    (d0, d1), = spans["density"]
    assert s1 <= d0
    assert [s0 <= a <= b <= s1 for a, b in spans["sync"]] == [True, False]
    assert d0 <= spans["sync"][1][0] <= spans["sync"][1][1] <= d1
    # three UNet passes; the LoRA pass's backward, then the VAE's, then
    # the render's, all inside the backward
    assert len(spans["unet"]) == 3
    (b0, b1), = spans["backward"]
    (u0, u1), = spans["unet_bwd"]
    (v0, v1), = spans["vae_bwd"]
    (r0, r1), = spans["render_bwd"]
    assert b0 <= u0 < u1 <= v0 < v1 <= r0 < r1 <= b1
    g0, g1 = spans["guidance"][0]
    assert all(g0 <= a <= b <= g1 for a, b in spans["vae"] + spans["unet"])


def test_render_dups_count_the_step_duplicates(traced):
    tr, _, n_dup, c = traced
    assert c["render.views"] == tr.cfg.batch_size == sum(len(n)
                                                         for n in n_dup)
    assert c["render.dups"] == sum(int(n.sum()) for n in n_dup) > 0
    assert c["launches.raster_fwd"] == 0       # the CPU renders plainly


def test_no_profiler_no_span_no_hook_no_count(traced, monkeypatch):
    tr = traced[0]
    profiling.reset_counters()
    calls = []

    def forbidden(what):
        def call(*a, **kw):
            calls.append(what)
            raise AssertionError(what)
        return call

    monkeypatch.setattr(profiling, "_Range", forbidden("range"))
    monkeypatch.setattr(torch.autograd.graph, "register_multi_grad_hook",
                        forbidden("register_multi_grad_hook"))
    hook = torch.Tensor.register_hook

    def counted(t, fn):
        calls.append("register_hook")
        return hook(t, fn)

    monkeypatch.setattr(torch.Tensor, "register_hook", counted)
    assert not profiling.recording()
    tr.fit(1)
    assert calls == []
    assert profiling._hooks == [] and profiling._open == {}
    c = profiling.counters()
    assert not any(k.startswith("render.") for k in c)
