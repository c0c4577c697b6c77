"""The ``sdxl`` kind at SDXL's block layout and tiny widths on the CPU: a
throwaway cell through the harness unedited, the check failing the
control and a fault, the spans and the attention sites counted with
transformer depth."""

from __future__ import annotations

import json

import pytest
from torch.profiler import ProfilerActivity, profile

from benchmark import control, run, stacks
from benchmark.kinds import sdxl
from benchmark.tests.tiny import OVERRIDES, REPO, write_root
from benchmark.trace import PREFIX, TAG

# the port's TINY_SDXL preset in diffusers' keys
UNET = {
    "block_out_channels": [32, 64, 64], "attention_head_dim": [2, 2, 4],
    "transformer_layers_per_block": [0, 2, 3], "cross_attention_dim": 64,
    "down_block_types": ["DownBlock2D", "CrossAttnDownBlock2D",
                         "CrossAttnDownBlock2D"],
    "up_block_types": ["CrossAttnUpBlock2D", "CrossAttnUpBlock2D",
                       "UpBlock2D"],
    "addition_embed_type": "text_time", "addition_time_embed_dim": 8,
    "projection_class_embeddings_input_dim": 64, "sample_size": 8,
    "in_channels": 4, "out_channels": 4, "layers_per_block": 2,
    "norm_num_groups": 32, "use_linear_projection": True,
    "flip_sin_to_cos": True, "freq_shift": 0}
# between the program's readings and the control's on the CPU
LIMITS = {"loss_gap": 0.03, "grad_gap": 0.1, "change_gap": 0.05,
          "eps_gap": 0.045, "latent_gap": 0.03}
SEED = 2 ** 31 + 11


def write_xl(root) -> str:
    """The tiny SDS cell of :func:`.tiny.write_root`, turned into an
    ``sdxl`` cell: SDXL's layout on the TINY VAE."""
    name = write_root(root, "sds", LIMITS)
    b = root / "benchmark"
    conf = b / "configs" / "tiny.json"
    model = json.loads(conf.read_text())
    model.update(port_preset="tiny_sdxl", unet=UNET)
    conf.write_text(json.dumps(model))
    tr = json.loads((REPO / "benchmark/traffic/sdxl-sds-1024.json")
                    .read_text())
    tr.update(overrides=OVERRIDES, unet_passes=[{"batch": 4}],
              warm_steps=1, trace_steps=2)
    (b / "traffic" / "sds-16.json").write_text(json.dumps(tr))
    return name


def test_a_tiny_sdxl_cell_runs_through_the_harness(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    name = write_xl(tmp_path)
    res = run.run_cell(tmp_path, name, SEED, 0.2, False, device="cpu",
                       log=lambda *a, **k: None)
    assert res["correct"] is True, res["compared"]
    assert set(res["compared"]) == set(LIMITS)


def test_the_control_and_a_fault_fail_the_limits(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    name = write_xl(tmp_path)
    got = control.readings(tmp_path, name, SEED, "cpu",
                           faults=("half_batch",),
                           controls={"control": {"unet": "int8",
                                                 "vae": "int8"}})
    assert all(got["program"][k] <= v for k, v in LIMITS.items()), got
    for bad in ("control", "half_batch"):
        assert any(got[bad][k] > v for k, v in LIMITS.items()), (bad, got)


def test_spans_and_sites_count_every_block(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    name = write_xl(tmp_path)
    cell = run.load_cell(tmp_path, name)
    prog = sdxl.Program(tmp_path, cell, 3, "cpu")
    with prog.instrument(), \
            profile(activities=[ProfilerActivity.CPU]) as prof:
        prog.step()
    names = [e.name()[len(PREFIX):]
             for e in prof.profiler.kineto_results.events()
             if e.name().startswith(PREFIX)]
    assert set(names) == {"render", "vae", "vae_bwd", "unet_fwd",
                          TAG + "attn", TAG + "xformer"}
    # (2 + 3) stacks at each stacked level and the mid block's; a core a
    # block: 10 at the 16-token level, 15 + 3 at the 4-token one
    assert names.count(TAG + "xformer") == 11
    sites = stacks.attn_sites(cell["model"])
    assert sites == [(2, 32, 16, 10), (4, 16, 4, 15), (4, 16, 4, 3)]
    assert names.count(TAG + "attn") == sum(c for *_, c in sites) == 28
    unet = prog.trainer.guidance.backbone.unet
    assert not any("forward" in vars(m) for m in unet.modules())


@pytest.mark.parametrize("key", ["transformer_layers_per_block",
                                 "addition_time_embed_dim"])
def test_the_width_check_covers_depth_and_text_time(key, tmp_path,
                                                    monkeypatch):
    monkeypatch.chdir(tmp_path)
    name = write_xl(tmp_path)
    cell = run.load_cell(tmp_path, name)
    u = cell["model"]["unet"]
    u[key] = [0, 2, 2] if key.startswith("transformer") else 16
    with pytest.raises(RuntimeError, match=key):
        sdxl.Program(tmp_path, cell, 3, "cpu")
