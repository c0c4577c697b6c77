"""Every shipped config builds a Trainer in the port: the 35 overlays
composed onto configs/base.yaml and the 5 top-level configs, one case
each, under the SHRINK overrides of the JAX package's
tests/test_presets.py (tiny scene, TINY backbone preset, 32^2) on the CPU.
A preset names only knobs the port honours; none raises, the DeepFloyd
overlays (guidance/if.yaml, guidance/if_upsample.yaml) included.
"""

import pathlib

import pytest

from gsgen_torch.config import (build_trainer, deep_merge, load_config,
                                parse_override, set_dotted)

CONFIGS = pathlib.Path(__file__).resolve().parents[1] / "configs"

OVERLAYS = sorted(
    str(p.relative_to(CONFIGS))[:-5]
    for group in ("renderer", "guidance", "data", "prompt", "auxiliary",
                  "upsample_tune")
    for p in (CONFIGS / group).glob("*.yaml"))

TOPLEVEL = ["base", "smoke", "corgi", "shrink_then_densify",
            "flagship_rehearsal"]

SHRINK = [
    "trainer.batch_size=1",
    "trainer.max_steps=50",
    "init.num_points=64",
    "init.capacity=128",
    "renderer.dup_cap=16384",
    "renderer.chunk=128",
    "data.reso=[32]",
    "data.reso_milestones=[]",
    "guidance.backbone_preset=tiny",
    "prompt.use_cache=false",
]


def test_preset_lists_are_complete():
    assert len(OVERLAYS) == 35
    assert sorted(p.stem for p in CONFIGS.glob("*.yaml")) == sorted(TOPLEVEL)


def _build(cfg):
    tr = build_trainer(cfg, device="cpu")
    assert tr.state.scene.params["mean"].shape[0] == 128
    return tr


@pytest.mark.parametrize("preset", OVERLAYS)
def test_overlay_preset_builds_in_port(preset, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    cfg = deep_merge(load_config(CONFIGS / "base.yaml"),
                     load_config(CONFIGS / (preset + ".yaml")))
    for ov in SHRINK:
        set_dotted(cfg, *parse_override(ov))
    _build(cfg)


@pytest.mark.parametrize("name", TOPLEVEL)
def test_toplevel_preset_builds_in_port(name, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    cfg = load_config(CONFIGS / (name + ".yaml"), SHRINK)
    _build(cfg)
