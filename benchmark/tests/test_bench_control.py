"""The check fails what it has to fail, at the TINY widths on the CPU: a
run driven through the harness with the timed path broken underneath
(each fault a training cell can have) and the control (the reference one
precision below the stated one, in the program's place).  The spans wrap
the layers they name."""

from __future__ import annotations

import pytest
from torch.profiler import ProfilerActivity, profile

from benchmark import control, readers, run
from benchmark.kinds import sd
from benchmark.tests.tiny import CONTROLS, LIMITS, write_root
from benchmark.trace import PREFIX, TAG

SEEDS = (2 ** 31 + 5, 17)


@pytest.mark.parametrize("kind", ["sds", "vsd"])
@pytest.mark.parametrize("fault", sd.FAULTS)
def test_a_broken_step_is_not_correct(kind, fault, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    name = write_root(tmp_path, kind)

    class Broken(sd.Program):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            # held, or the fault's context would close when collected
            self.planted = self.fault(fault)
            self.planted.__enter__()

    monkeypatch.setattr(sd, "Program", Broken)
    res = run.run_cell(tmp_path, name, SEEDS[0], 0.2, False, device="cpu",
                       log=lambda *a, **k: None)
    assert res["correct"] is False, res["compared"]


@pytest.mark.parametrize("kind", ["sds", "vsd"])
def test_the_controls_fail_the_limits(kind, tmp_path, monkeypatch):
    """The cell's control (the reference one precision lower in the
    program's place) and each network alone a precision lower fail the
    tiny cell's limits, where the program passes them."""
    monkeypatch.chdir(tmp_path)
    name = write_root(tmp_path, kind)
    lim = LIMITS[kind]
    for seed in SEEDS:
        got = control.readings(tmp_path, name, seed, "cpu", faults=(),
                               controls=CONTROLS[kind])
        assert all(got["program"][k] <= lim[k] for k in lim), got
        for c in CONTROLS[kind]:
            assert any(got[c][k] > lim[k] for k in lim), (c, got)


@pytest.mark.parametrize("kind", ["sds", "vsd"])
def test_spans_wrap_the_layers(kind, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    name = write_root(tmp_path, kind)
    cell = run.load_cell(tmp_path, name)
    prog = sd.Program(tmp_path, cell, 3, "cpu")
    with prog.instrument(), \
            profile(activities=[ProfilerActivity.CPU]) as prof:
        prog.step()
    events = [e for e in prof.profiler.kineto_results.events()
              if e.name().startswith(PREFIX)]
    want = {"render", "vae", "vae_bwd", "unet_fwd", TAG + "attn"} | (
        {"unet_bwd"} if kind == "vsd" else set())
    assert {e.name() for e in events} == {PREFIX + n for n in want}
    # a span a self-attention core, none around a cross-attention; under
    # VSD 3 passes, the last one differentiated
    n = sum(c for *_, c in readers.attn_sites(cell["model"]))
    assert n == 7
    n_attn = sum(e.name() == PREFIX + TAG + "attn" for e in events)
    assert n_attn == (3 * n + n if kind == "vsd" else n)
    bb = prog.trainer.guidance.backbone
    assert not {"encode_images", "predict_noise"} & set(vars(bb))
    assert "forward" not in vars(bb.unet)
    import gsgen_torch.guidance.unet2d as unet2d
    from gsgen_torch.ops import flash_attention
    assert unet2d.flash_self_attention is \
        flash_attention.flash_self_attention
