"""The port's entry points: the precision policy and main.py's outputs.

``build_trainer`` sets the one precision policy (``utils/precision.py``):
cuBLAS matmuls and cuDNN convolutions in IEEE fp32, read here through
both of torch's interfaces.  ``gsgen_torch.main`` writes the run
directory, checkpoints, eval images and the exports, runs the upsample
fine-tune of ``configs/flagship_rehearsal.yaml``, resumes with ``ckpt=``
(``--tune-only`` runs the fine-tune alone), writes guidance samples and
the profiler trace of ``profile_steps``, and writes nothing with
``--no-log``.  CPU only, tiny sizes; TensorBoard off.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from gsgen_tpu.io.checkpoint import load_checkpoint as load_checkpoint_j
from gsgen_torch import config as config_mod
from gsgen_torch import main as main_mod
from gsgen_torch.io import logging as logging_mod
from gsgen_torch.io.checkpoint import state_arrays

CONFIGS = Path(__file__).resolve().parent.parent / "configs"
TINY = ["guidance.type=mock", "data.reso=[32]", "renderer.dup_cap=16384",
        "init.num_points=256", "init.capacity=512", "trainer.batch_size=1",
        "prompt.use_cache=false"]


# the flagship rehearsal at the TINY SD preset, 32^2, a 3-frame orbit, and
# a fine-tune of 2 poses at 96^2
FLAGSHIP = ["guidance.backbone_preset=tiny", "data.reso=[32]",
            "data.reso_milestones=[]", "renderer.dup_cap=16384",
            "init.num_points=256", "init.capacity=512",
            "trainer.batch_size=1", "prompt.use_cache=false",
            "trainer.eval_image_period=1", "trainer.eval_video_period=2",
            "trainer.save_period=2", "trainer.eval_n_frames=3",
            "upsample_tune.num_poses=2", "upsample_tune.batch_size=2",
            "upsample_tune.epoch=1", "upsample_tune.reso=96"]


@pytest.fixture
def quiet_logger(monkeypatch):
    """RunLogger without TensorBoard (its import costs seconds here) and
    without the code snapshot (a tarball of the repository)."""
    init = logging_mod.RunLogger.__init__

    def no_tb(self, root="checkpoints", name="run", use_tensorboard=True):
        init(self, root=root, name=name, use_tensorboard=False)

    monkeypatch.setattr(logging_mod.RunLogger, "__init__", no_tb)
    monkeypatch.setattr(logging_mod.RunLogger, "snapshot_code",
                        lambda self, repo_root=".": None)


def _run_dir(root: Path) -> Path:
    dirs = [p for p in root.glob("*/*/*") if p.is_dir()]
    assert len(dirs) == 1, dirs
    return dirs[0]


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


def test_main_flagship_writes_run_outputs(tmp_path, quiet_logger, capsys):
    """configs/flagship_rehearsal.yaml end to end: 3 steps, eval images,
    the orbit and a checkpoint at step 2, the upsample fine-tune, the
    final checkpoint (read by the JAX package too) and ply/splat/mesh."""
    assert main_mod.main(["--config", str(CONFIGS / "flagship_rehearsal.yaml"),
                          "--steps", "3", "--device", "cpu",
                          "--log-root", str(tmp_path), *FLAGSHIP]) == 0
    out = capsys.readouterr().out
    assert "upsample fine-tune: 2 poses, 1 epochs at 96^2" in out
    assert "not written" not in out
    run = _run_dir(tmp_path)
    assert run.parts[-3] == "A_high_quality_photo_of_a_furry_corgi"
    names = {p.relative_to(run).as_posix() for p in run.rglob("*")}
    for want in ("config.json", "scalars.jsonl", "ckpts/step_2/arrays.npz",
                 "ckpts/step_3/arrays.npz", "ckpts/step_3/meta.json",
                 "eval/eval_image_000000.png", "eval/eval_image_000002.png",
                 "exports/scene.ply", "exports/scene.splat",
                 "exports/scene.obj"):
        assert want in names, (want, sorted(names))
    assert any(n.startswith("eval/eval_orbit_000002") or
               n.startswith("eval/orbit_000002") for n in names)
    assert json.loads((run / "config.json").read_text())[
        "upsample_tune"]["enabled"] is True
    # the JAX package resumes from the port's final checkpoint
    cfg = config_mod.load_config(CONFIGS / "flagship_rehearsal.yaml",
                                 FLAGSHIP)
    tr = config_mod.build_trainer(cfg, device="cpu")
    assert tr.load(run / "ckpts") == 3 and tr.state.step == 3
    from gsgen_tpu.config import build_trainer as build_j
    from gsgen_tpu.config import load_config as load_j
    # the same train-state tree (SDS has no trainable guidance leaves)
    # without building the SD backbone in JAX
    tj = build_j(load_j(str(CONFIGS / "flagship_rehearsal.yaml"),
                        [*FLAGSHIP, "guidance.type=mock"]))
    state_j, step = load_checkpoint_j(run / "ckpts" / "step_3", tj.state)
    assert step == 3 and int(state_j.step) == 3
    mine = state_arrays(tr.state)
    for k in (".scene/.params/.mean", ".scene/.active", ".opt/.count"):
        np.testing.assert_array_equal(
            np.asarray(state_j.scene.params.mean) if k.endswith("mean")
            else np.asarray(state_j.scene.active) if k.endswith("active")
            else np.asarray(state_j.opt.count), mine[k], err_msg=k)


def test_build_trainer_sets_exact_fp32(tf32_on):
    assert torch.backends.cudnn.conv.fp32_precision == "tf32"
    cfg = config_mod.load_config(CONFIGS / "base.yaml", TINY)
    config_mod.build_trainer(cfg, device="cpu")
    assert_exact_fp32()


def test_main_sets_exact_fp32_and_names_skipped_outputs(tf32_on, capsys,
                                                        tmp_path,
                                                        quiet_logger):
    """SDS on MockUNet with guidance samples every 2 steps and the profiler
    trace of step 1: main writes both (no output is left unwritten, so no
    line names one), and leaves exact fp32 after."""
    assert main_mod.main(["--config", str(CONFIGS / "base.yaml"),
                          "--steps", "3", "--device", "cpu",
                          "--log-root", str(tmp_path), *TINY[1:],
                          "guidance.backbone_latent_size=8",
                          "trainer.guidance_eval_period=2",
                          "trainer.profile_steps=[1, 2]"]) == 0
    assert_exact_fp32()
    assert "not written" not in capsys.readouterr().out
    run = _run_dir(tmp_path)
    assert (run / "ckpts" / "step_3").is_dir()
    sample = run / "eval" / "eval_guidance_sample_000002.png"
    assert sample.is_file() and sample.stat().st_size > 0
    assert not (run / "eval" / "eval_guidance_sample_000001.png").exists()
    trace = json.loads((run / "profile" / "steps_1_2.json").read_text())
    assert any(e.get("name") == "aten::conv2d"
               for e in trace["traceEvents"])


def test_main_tune_only_resumes_from_ckpt(tmp_path, quiet_logger, capsys):
    """--tune-only with ckpt=: no training step, the fine-tune on the
    resumed scene, a final checkpoint at the resumed step."""
    first = tmp_path / "first"
    assert main_mod.main(["--config", str(CONFIGS / "flagship_rehearsal.yaml"),
                          "--steps", "2", "--device", "cpu",
                          "--log-root", str(first), *FLAGSHIP,
                          "upsample_tune.enabled=false",
                          "export.types=[]"]) == 0
    ckpts = _run_dir(first) / "ckpts"
    capsys.readouterr()
    second = tmp_path / "second"
    assert main_mod.main(["--config", str(CONFIGS / "flagship_rehearsal.yaml"),
                          "--tune-only", "--device", "cpu",
                          "--log-root", str(second), *FLAGSHIP,
                          "export.types=[ply]", f"ckpt={ckpts}"]) == 0
    out = capsys.readouterr().out
    assert f"resumed from {ckpts} at step 2" in out
    assert "upsample fine-tune: loss" in out
    assert not [ln for ln in out.splitlines() if ln.startswith("step ")]
    run = _run_dir(second)
    assert sorted(p.name for p in (run / "ckpts").iterdir()) == ["step_2"]
    assert sorted(p.name for p in (run / "exports").iterdir()) == [
        "scene.ply"]
    a = np.load(ckpts / "step_2" / "arrays.npz")
    b = np.load(run / "ckpts" / "step_2" / "arrays.npz")
    assert not np.array_equal(a[".scene/.params/.color"],
                              b[".scene/.params/.color"])
    np.testing.assert_array_equal(a[".scene/.active"], b[".scene/.active"])


def test_main_no_log_writes_nothing(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    configs = CONFIGS.resolve()
    assert main_mod.main(["--config", str(configs / "flagship_rehearsal.yaml"),
                          "--steps", "1", "--device", "cpu", "--no-log",
                          *FLAGSHIP]) == 0
    assert list(tmp_path.iterdir()) == []
    out = capsys.readouterr().out
    assert "run dir" not in out and "upsample fine-tune: loss" in out
