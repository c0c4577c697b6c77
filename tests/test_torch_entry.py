"""The port's entry points: the precision policy and main.py's refusals.

``build_trainer`` sets the one precision policy (``utils/precision.py``):
cuBLAS matmuls and cuDNN convolutions in IEEE fp32, read here through
both of torch's interfaces.  ``gsgen_torch.main`` refuses a config that
enables the upsample fine-tune before any step, and otherwise names the
outputs it does not write.  CPU only, tiny sizes.
"""

from pathlib import Path

import pytest
import torch

from gsgen_torch import config as config_mod
from gsgen_torch import main as main_mod
from gsgen_torch.training.trainer import Trainer, TrainerConfig

CONFIGS = Path(__file__).resolve().parent.parent / "configs"
TINY = ["guidance.type=mock", "data.reso=[32]", "renderer.dup_cap=16384",
        "init.num_points=256", "init.capacity=512", "trainer.batch_size=1",
        "prompt.use_cache=false"]


@pytest.fixture
def tf32_on():
    """Start from torch's defaults with TF32 allowed; restore after."""
    saved = (torch.backends.cuda.matmul.fp32_precision,
             torch.backends.cudnn.conv.fp32_precision)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.fp32_precision = "tf32"
    torch.backends.cudnn.conv.fp32_precision = "tf32"
    yield
    torch.backends.cuda.matmul.fp32_precision, \
        torch.backends.cudnn.conv.fp32_precision = saved


def assert_exact_fp32():
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.backends.cuda.matmul.fp32_precision == "ieee"
    assert torch.backends.cudnn.conv.fp32_precision == "ieee"
    assert torch.get_float32_matmul_precision() == "highest"


def test_build_trainer_sets_exact_fp32(tf32_on):
    assert torch.backends.cudnn.conv.fp32_precision == "tf32"
    cfg = config_mod.load_config(CONFIGS / "base.yaml", TINY)
    config_mod.build_trainer(cfg, device="cpu")
    assert_exact_fp32()


def test_main_sets_exact_fp32_and_names_skipped_outputs(tf32_on, capsys):
    assert main_mod.main(["--config", str(CONFIGS / "base.yaml"),
                          "--steps", "1", "--device", "cpu", *TINY]) == 0
    assert_exact_fp32()
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("not written")]
    assert len(lines) == 1
    for what in ("Queue 1 item 1", "checkpoints", "exports ply, splat",
                 "eval images", "eval video"):
        assert what in lines[0], (what, lines[0])


def test_skipped_outputs_leaves_out_periods_set_to_zero():
    """A period of 0 turns that output off in the JAX trainer, so the line
    does not name it; the periods come from the trainer's own config."""
    line = main_mod.skipped_outputs(
        TrainerConfig(save_period=0, eval_video_period=0,
                      eval_image_period=250, guidance_eval_period=0), [])
    assert "eval images every 250 steps" in line
    assert "the final checkpoint" in line
    for what in ("checkpoints every", "exports", "eval video",
                 "guidance samples"):
        assert what not in line, (what, line)


def test_main_refuses_upsample_tune_before_training(monkeypatch):
    def no_step(*args, **kwargs):
        raise AssertionError("main.py built or trained before refusing")

    monkeypatch.setattr(config_mod, "build_trainer", no_step)
    monkeypatch.setattr(Trainer, "fit", no_step)
    with pytest.raises(NotImplementedError, match="Queue 1 item 2"):
        main_mod.main(["--config", str(CONFIGS / "flagship_rehearsal.yaml"),
                       "--device", "cpu"])
    with pytest.raises(NotImplementedError, match="upsample_tune"):
        main_mod.main(["--config", str(CONFIGS / "base.yaml"),
                       "--device", "cpu", "upsample_tune.enabled=true"])
