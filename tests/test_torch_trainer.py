"""gsgen_torch training vs the JAX package's Trainer, config loading, and
the port's import hygiene.

The trajectory test starts both trainers from the same state (the JAX
trainer's, carried across with ``train_state_from_jax_arrays`` from the
flattened key paths its checkpoints write), with the same numpy cameras
(same seed) and a fixed background, and runs 3 steps.  The JAX side
renders with its Pallas kernels in interpret mode and exact scans.
Tolerances: losses rtol 1e-4 (fp32 renders, summation order); Adam first
moments (0.1 x the averaged gradients, then decayed) rtol 2e-3 / atol
2e-4 of each field's largest moment, as for render gradients.  Params:
Adam's early steps move an element by about lr x sign(gradient), so an
element whose gradient sits at rounding level may move the other way; at
least 99.9% of the elements must agree within 1e-4 of their lr, and all
within 2 lr per step.
"""

import dataclasses
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsgen_tpu.data.cameras import CameraSamplerConfig as CamJ
from gsgen_tpu.io.checkpoint import _flatten_with_paths
from gsgen_tpu.models.background import BackgroundConfig as BgJ
from gsgen_tpu.models.density import DensifyConfig as DensJ
from gsgen_tpu.models.density import PruneConfig as PruneJ
from gsgen_tpu.models.init import InitConfig as InitJ
from gsgen_tpu.models.scene import GaussianParams
from gsgen_tpu.models.scene import RenderConfig as RenderJ
from gsgen_tpu.training.trainer import Trainer as TrainerJ
from gsgen_tpu.training.trainer import TrainerConfig as TcfgJ
from gsgen_torch.config import build_trainer, load_config
from gsgen_torch.data.cameras import CameraSamplerConfig
from gsgen_torch.models.background import BackgroundConfig
from gsgen_torch.models.density import DensifyConfig, PruneConfig
from gsgen_torch.models.init import InitConfig
from gsgen_torch.models.scene import FIELDS, RenderConfig
from gsgen_torch.training.trainer import (Trainer, TrainerConfig,
                                          train_state_from_jax_arrays)
from torch_fixtures import scene3d

ROOT = Path(__file__).resolve().parents[1]
RES = 32
STEPS = 3
LR = dict(mean=[0.005, 3.0e-5, 100, "exp"], svec=[0.003, 0.001, 100, "exp"],
          qvec=0.003, color=0.01, alpha=0.003, bg=0.003)


def _pair(backend="pallas", data=None, **tkw):
    """Both trainers from the same state.  ``backend`` is the JAX render
    backend (Pallas in interpret mode, or its pure-XLA scan); ``data``
    updates the sampler's keys (reso, reso_milestones); ``tkw`` the
    trainer's, with ``dup_cap`` going to both render configs."""
    rkw = dict(tile_size=8, chunk=128, dup_cap=tkw.pop("dup_cap", 4096))
    kw = dict(max_steps=100, batch_size=2, lr=LR, **tkw)
    tcfg_j, tcfg_t = TcfgJ(**kw), TrainerConfig(**kw)
    # non-zero weights so every loss term reaches the gradients
    loss = dict(sds=1.0, sparsity=0.01, opague=0.01, z_var=0.001)
    tcfg_j = dataclasses.replace(tcfg_j, loss=dataclasses.replace(
        tcfg_j.loss, **loss), penalty={"alpha": {"type": "center_weighted",
                                                 "value": 0.01}})
    tcfg_t = dataclasses.replace(tcfg_t, loss=dataclasses.replace(
        tcfg_t.loss, **loss), penalty={"alpha": {"type": "center_weighted",
                                                 "value": 0.01}})
    init = dict(num_points=96, capacity=128, svec_val=0.05, mean_std=0.4)
    data = dict(dict(batch_size=2, max_steps=100, reso=(RES,),
                     camera_distance=(2.0, 2.5)), **(data or {}))
    dens = dict(enabled=False)
    rcfg_j = (RenderJ(backend="xla", **rkw) if backend == "xla" else
              RenderJ(backend="pallas", pallas_interpret=True,
                      mxu_scans=False, fast_fwd_cumprod=False, **rkw))
    tj = TrainerJ(cfg=tcfg_j, rcfg=rcfg_j, init_cfg=InitJ(**init),
                  bg_cfg=BgJ(type="fixed", color=(0.1, 0.6, 0.3)),
                  data_cfg=CamJ(**data), dcfg=DensJ(**dens),
                  pcfg=PruneJ(enabled=False))
    tt = Trainer(cfg=tcfg_t, rcfg=RenderConfig(**rkw),
                 init_cfg=InitConfig(**init),
                 bg_cfg=BackgroundConfig(type="fixed", color=(0.1, 0.6, 0.3)),
                 data_cfg=CameraSamplerConfig(**data),
                 dcfg=DensifyConfig(**dens), pcfg=PruneConfig(enabled=False),
                 device="cpu")
    # anisotropic, rotated Gaussians (the base init is isotropic, whose
    # rotation gradient is zero up to rounding)
    raw = scene3d(96, seed=11, capacity=128, mean_std=0.4)
    params = GaussianParams(**{f: jnp.asarray(raw[f]) for f in FIELDS})
    tj.state = tj.state._replace(scene=tj.state.scene._replace(
        params=params))
    tt.state = train_state_from_jax_arrays(_flatten_with_paths(tj.state),
                                           "cpu")
    return tj, tt


def check_step_metrics(m_t, m_j, s):
    """One step's losses within rtol 1e-4 and its n_dup_max equal."""
    for k in ("loss_sds", "loss_sparsity", "loss_opague", "loss_z_var",
              "pen_alpha", "loss_total"):
        np.testing.assert_allclose(float(m_t[k]), float(m_j[k]),
                                   rtol=1e-4, err_msg=f"step {s} {k}")
    assert int(m_t["n_dup_max"]) == int(m_j["n_dup_max"]), f"step {s}"


def check_states_match(tj, tt, steps):
    """The port's state after ``steps`` steps against the JAX trainer's,
    at the tolerances of the module docstring."""
    arrays = _flatten_with_paths(tj.state)
    st = tt.state
    assert st.step == int(arrays[".step"]) == steps
    assert st.opt.count == int(arrays[".opt/.count"])
    for f in FIELDS:
        mu_j = arrays[f".opt/.mu/[0]/.{f}"]
        np.testing.assert_allclose(
            st.opt.mu[f].numpy(), mu_j, rtol=2e-3,
            atol=2e-4 * np.abs(mu_j).max(), err_msg=f"mu {f}")
        p_t, p_j = st.scene.params[f].numpy(), arrays[f".scene/.params/.{f}"]
        lr = LR[f] if np.isscalar(LR[f]) else LR[f][0]
        diff = np.abs(p_t - p_j)
        assert diff.max() <= 2 * lr * steps, f
        assert np.mean(diff <= 1e-4 * lr + 1e-6) >= 0.999, f
    for s in ("grad_accum", "max_radii2d"):
        want = arrays[f".scene/.{s}"]
        np.testing.assert_allclose(getattr(st.scene, s).numpy(), want,
                                   rtol=2e-3, atol=2e-4 * np.abs(want).max(),
                                   err_msg=s)
    np.testing.assert_array_equal(st.scene.grad_cnt.numpy(),
                                  arrays[".scene/.grad_cnt"])


def test_trajectory_matches_jax_trainer():
    tj, tt = _pair()
    for s in range(STEPS):
        check_step_metrics(tt.train_step(s), tj.train_step(s), s)
    check_states_match(tj, tt, STEPS)


def test_load_config_base_yaml_with_overrides(tmp_path):
    cfg = load_config(ROOT / "configs" / "base.yaml",
                      ["guidance.type=mock", "renderer.chunk=128",
                       "data.reso=[64]", "trainer.lr.qvec=0.01"])
    assert cfg["guidance"]["type"] == "mock"
    assert cfg["renderer"]["chunk"] == 128 and cfg["data"]["reso"] == [64]
    assert cfg["trainer"]["lr"]["qvec"] == 0.01
    assert cfg["renderer"]["fast_fwd_cumprod"] is True
    # include: deep-merges, the including file wins
    (tmp_path / "child.yaml").write_text(
        f"include: [{ROOT / 'configs' / 'base.yaml'}]\n"
        "renderer:\n  tile_size: 8\ntrainer:\n  max_steps: 7\n")
    child = load_config(tmp_path / "child.yaml")
    assert child["renderer"]["tile_size"] == 8
    assert child["renderer"]["dup_cap"] == 1048576
    assert child["trainer"]["max_steps"] == 7
    assert child["trainer"]["batch_size"] == 4
    tr = build_trainer(load_config(
        ROOT / "configs" / "base.yaml",
        ["guidance.type=mock", "init.num_points=64", "init.capacity=128",
         "data.reso=[32]", "renderer.tile_size=8", "renderer.chunk=128",
         "renderer.dup_cap=4096", "trainer.batch_size=1"]), device="cpu")
    assert tr.rcfg.fast_fwd_cumprod and tr.cfg.max_steps == 15000
    assert tr.state.scene.params["mean"].shape == (128, 3)
    tr.fit(2)
    assert tr.state.step == 2
    # DeepFloyd's type builds pixel-space SDS; a type the JAX package
    # does not have raises
    g = build_trainer(load_config(ROOT / "configs" / "base.yaml",
                                  ["guidance.type=deep_floyd"]),
                      device="cpu").guidance
    assert g.cfg.rgb_as_latents
    with pytest.raises(NotImplementedError):
        build_trainer(load_config(ROOT / "configs" / "base.yaml",
                                  ["guidance.type=make_it_3d"]),
                      device="cpu")


def test_fit_runs_to_max_steps_and_densify_raises():
    """fit runs to max_steps through a densify event (step 2); an unknown
    densify type raises, as in the JAX package."""
    over = ["guidance.type=mock", "init.num_points=16", "init.capacity=32",
            "data.reso=[16]", "renderer.tile_size=8", "renderer.chunk=128",
            "renderer.dup_cap=2048", "trainer.batch_size=1",
            "trainer.max_steps=3", "renderer.densify.warm_up=2",
            "renderer.densify.period=1",
            "renderer.densify.mean2d_thresh=0.0"]
    tr = build_trainer(load_config(ROOT / "configs" / "base.yaml", over),
                       device="cpu")
    infos = []
    tr.fit(callback=lambda s, m: infos.append(m))
    assert tr.state.step == 3
    assert int(tr.state.scene.active.sum()) > 16
    assert infos[2]["num_clone"] + infos[2]["num_split"] > 0
    bad = build_trainer(load_config(
        ROOT / "configs" / "base.yaml",
        over + ["renderer.densify.use_legacy=false",
                "renderer.densify.type=bogus"]), device="cpu")
    bad.fit(2)
    with pytest.raises(NotImplementedError, match="densify"):
        bad.fit()


def test_port_imports_no_jax():
    code = ("import sys, gsgen_torch.config, gsgen_torch.main, "
            "gsgen_torch.ops.cuda_raster, gsgen_torch.guidance.sd_unet; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'gsgen_tpu')]; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                   timeout=120)
    hits = subprocess.run(
        ["grep", "-rnE", "import jax|from jax|gsgen_tpu", "gsgen_torch/",
         "chip_smoke.py"], cwd=ROOT, capture_output=True, text=True)
    assert hits.stdout == "", hits.stdout


def test_state_from_jax_arrays_roundtrip():
    rng = np.random.default_rng(0)
    arrays = {f".scene/.params/.{f}": rng.standard_normal(s).astype(
        np.float32) for f, s in (("mean", (4, 3)), ("qvec", (4, 4)),
                                 ("svec", (4, 3)), ("color", (4, 3)),
                                 ("alpha", (4,)))}
    arrays.update({".scene/.active": np.array([1, 1, 0, 1], bool),
                   ".scene/.max_radii2d": np.ones(4, np.float32),
                   ".scene/.grad_accum": np.zeros(4, np.float32),
                   ".scene/.grad_cnt": np.full(4, 2.0, np.float32),
                   ".opt/.count": np.int32(5), ".step": np.int32(5),
                   ".bg/['bg_color']": np.ones(3, np.float32),
                   ".opt/.mu/[1]/['bg_color']": np.ones(3, np.float32),
                   ".opt/.nu/[1]/['bg_color']": np.ones(3, np.float32)})
    for m in ("mu", "nu"):
        for f in FIELDS:
            arrays[f".opt/.{m}/[0]/.{f}"] = arrays[f".scene/.params/.{f}"]
    st = train_state_from_jax_arrays(arrays, "cpu")
    assert st.step == 5 and st.opt.count == 5
    assert st.scene.active.tolist() == [True, True, False, True]
    assert set(st.bg) == {"bg_color"} and "bg/bg_color" in st.opt.mu
    np.testing.assert_array_equal(st.scene.params["qvec"].numpy(),
                                  arrays[".scene/.params/.qvec"])
    assert torch.equal(st.opt.nu["mean"], st.scene.params["mean"])


def test_state_from_jax_arrays_with_gp():
    """The ``gp`` subtree and its Adam moments (``[2]``): a flax LoRA path
    (with its ``params`` root) becomes the torch key, its kernel
    transposed like the weights; a plain name stays as it is."""
    rng = np.random.default_rng(1)
    arrays = {f".scene/.params/.{f}": rng.standard_normal(s).astype(
        np.float32) for f, s in (("mean", (2, 3)), ("qvec", (2, 4)),
                                 ("svec", (2, 3)), ("color", (2, 3)),
                                 ("alpha", (2,)))}
    arrays.update({".scene/.active": np.ones(2, bool),
                   ".scene/.max_radii2d": np.ones(2, np.float32),
                   ".scene/.grad_accum": np.zeros(2, np.float32),
                   ".scene/.grad_cnt": np.zeros(2, np.float32),
                   ".opt/.count": np.int32(1), ".step": np.int32(1)})
    lora = "params/down_blocks_0/attentions_0/transformer_blocks_0/attn1/" \
           "to_q_lora/down/kernel"
    kern = rng.standard_normal((320, 4)).astype(np.float32)       # [in, r]
    bias = rng.standard_normal(1280).astype(np.float32)
    for m, scale in (("", 1.0), (".opt/.mu/[2]", 0.1), (".opt/.nu/[2]", 0.01)):
        pre = m or ".gp"
        arrays[f"{pre}/['{lora}']"] = kern * scale
        arrays[f"{pre}/['params/class_embedding/linear_1/bias']"] = \
            bias * scale
        arrays[f"{pre}/['cam_b']"] = np.full(4, scale, np.float32)
    for m in ("mu", "nu"):
        for f in FIELDS:
            arrays[f".opt/.{m}/[0]/.{f}"] = arrays[f".scene/.params/.{f}"]
    st = train_state_from_jax_arrays(arrays, "cpu")
    key = ("down_blocks.0.attentions.0.transformer_blocks.0.attn1."
           "to_q_lora.down.weight")
    assert set(st.gp) == {key, "class_embedding.linear_1.bias", "cam_b"}
    np.testing.assert_array_equal(st.gp[key].numpy(), kern.T)
    assert st.gp[key].is_contiguous()
    np.testing.assert_allclose(st.opt.mu[f"gp/{key}"].numpy(), 0.1 * kern.T)
    np.testing.assert_allclose(st.opt.nu["gp/class_embedding.linear_1.bias"]
                               .numpy(), 0.01 * bias)
    assert float(st.opt.mu["gp/cam_b"][0]) == np.float32(0.1)
    assert st.bg == {}
