"""The port's run outputs and upsample fine-tune against the JAX package.

Checkpoints go both ways: a port checkpoint read by the JAX
``load_checkpoint`` into a same-config template, a JAX checkpoint read by
``Trainer.load``, every array equal (the TINY_VSD guidance leaves
included).  ``to_ply`` and ``to_splat`` write the JAX exporter's bytes;
the rest holds these tolerances (fp32 on the CPU, summation order):
``density_grid`` 1e-5 abs at reso 16, the mesh's vertices 1e-5 with the
same faces, ``ssim`` / ``image_loss`` 1e-6, ``bicubic_upsample`` 1e-5 of
``jax.image.resize(..., "cubic")`` border rows included, the eval strip's
rgb within the render gates of test_torch_raster.py (rtol 1e-4 / atol
1e-5) and its colormapped columns within one step of their lookup table
(a render difference at rounding level may move a value across a table
bin), the fine-tune's losses rtol 1e-4.  The JAX side renders with its
Pallas kernels in interpret mode and exact scans.  CPU, tiny sizes.
"""

import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsgen_tpu.data.cameras import CameraSamplerConfig as CamJ
from gsgen_tpu.guidance import unet2d as unet_j
from gsgen_tpu.guidance.sd_unet import SDUNetBackbone as BackboneJ
from gsgen_tpu.guidance.vsd import VSDConfig as VSDConfigJ
from gsgen_tpu.guidance.vsd import VSDGuidance as VSDGuidanceJ
from gsgen_tpu.io import checkpoint as ckpt_j
from gsgen_tpu.io import export as export_j
from gsgen_tpu.models.background import BackgroundConfig as BgJ
from gsgen_tpu.models.density import DensifyConfig as DensJ
from gsgen_tpu.models.density import PruneConfig as PruneJ
from gsgen_tpu.models.init import InitConfig as InitJ
from gsgen_tpu.models.scene import GaussianParams, SceneState
from gsgen_tpu.models.scene import RenderConfig as RenderJ
from gsgen_tpu.ops.camera import CameraIntrinsics as IntrJ
from gsgen_tpu.training import evaluation as eval_j
from gsgen_tpu.training import losses as losses_j
from gsgen_tpu.training import upsample as upsample_j
from gsgen_tpu.training.trainer import Trainer as TrainerJ
from gsgen_tpu.training.trainer import TrainerConfig as TcfgJ
from gsgen_tpu.utils import colormaps as cmap_j
from gsgen_torch.data.cameras import CameraSamplerConfig
from gsgen_torch.guidance import convert
from gsgen_torch.guidance.sd_unet import TINY_VSD, SDUNetBackbone
from gsgen_torch.guidance.vsd import VSDConfig, VSDGuidance
from gsgen_torch.io import checkpoint as ckpt_t
from gsgen_torch.io import export as export_t
from gsgen_torch.io import logging as logging_t
from gsgen_torch.models.background import BackgroundConfig
from gsgen_torch.models.density import DensifyConfig, PruneConfig
from gsgen_torch.models.init import InitConfig
from gsgen_torch.models.scene import FIELDS, RenderConfig, scene_from_numpy
from gsgen_torch.ops.camera import CameraIntrinsics
from gsgen_torch.training import evaluation as eval_t
from gsgen_torch.training import losses as losses_t
from gsgen_torch.training import upsample as upsample_t
from gsgen_torch.training.trainer import (Trainer, TrainerConfig, _gp_leaf,
                                          train_state_from_jax_arrays)
from gsgen_torch.utils import colormaps as cmap_t
from torch_fixtures import CHUNK, RES, TILE, scene3d, t

RKW = dict(tile_size=TILE, chunk=CHUNK, dup_cap=4096)
RENDER_J = RenderJ(backend="pallas", pallas_interpret=True, mxu_scans=False,
                   fast_fwd_cumprod=False, **RKW)
INIT = dict(num_points=96, capacity=128, svec_val=0.05, mean_std=0.4)
DATA = dict(batch_size=2, max_steps=100, reso=(RES,),
            camera_distance=(2.0, 2.5))


@pytest.fixture(scope="module")
def vsd_pair():
    """VSD on the TINY_VSD UNet (LoRA and camera-embedding leaves) in each
    package, built once for the module."""
    return (VSDGuidanceJ(VSDConfigJ(), BackboneJ(unet_j.TINY_VSD,
                                                 latent_size=8)),
            VSDGuidance(VSDConfig(), SDUNetBackbone(
                TINY_VSD, latent_size=8, device="cpu", fp32_unet=True),
                device="cpu"))


def _trainers(guidance=(None, None)):
    """One trainer in each package with the same config and guidance
    (default: MockGuidance)."""
    kw = dict(max_steps=100, batch_size=2)
    g_j, g_t = guidance
    tj = TrainerJ(cfg=TcfgJ(**kw), rcfg=RENDER_J, init_cfg=InitJ(**INIT),
                  bg_cfg=BgJ(type="fixed", color=(0.1, 0.6, 0.3)),
                  data_cfg=CamJ(**DATA), guidance=g_j,
                  dcfg=DensJ(enabled=False), pcfg=PruneJ(enabled=False))
    tt = Trainer(cfg=TrainerConfig(**kw), rcfg=RenderConfig(**RKW),
                 init_cfg=InitConfig(**INIT),
                 bg_cfg=BackgroundConfig(type="fixed", color=(0.1, 0.6, 0.3)),
                 data_cfg=CameraSamplerConfig(**DATA), guidance=g_t,
                 dcfg=DensifyConfig(enabled=False),
                 pcfg=PruneConfig(enabled=False), device="cpu")
    return tj, tt


def _random_like(arr, rng):
    arr = np.asarray(arr)
    if arr.dtype == bool:
        return rng.random(arr.shape) < 0.5
    if arr.dtype.kind in "iu":
        return rng.integers(1, 1000, arr.shape).astype(arr.dtype)
    return rng.standard_normal(arr.shape).astype(arr.dtype)


def _assert_same_arrays(got, want):
    assert list(got) == list(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
        np.testing.assert_array_equal(got[k], v, err_msg=k)


@pytest.mark.parametrize("kind", ["mock", "vsd"])
def test_port_checkpoint_loads_in_jax(tmp_path, kind, request):
    tj, tt = _trainers(request.getfixturevalue("vsd_pair")
                       if kind == "vsd" else (None, None))
    rng = np.random.default_rng(0)
    arrays = {k: _random_like(v, rng) for k, v in
              ckpt_t.state_arrays(tt.state, seed=3).items()}
    tt.state = train_state_from_jax_arrays(arrays, "cpu")
    if kind == "vsd":
        assert any(k.startswith(".gp/['params/") and k.endswith("kernel']")
                   for k in arrays)
    path = ckpt_t.save_checkpoint(tmp_path / "ckpts", 7, tt.state, seed=3)
    state_j, step = ckpt_j.load_checkpoint(tmp_path / "ckpts", tj.state)
    assert step == 7
    got = ckpt_j._flatten_with_paths(state_j)
    want = ckpt_t.state_arrays(tt.state, seed=3)
    _assert_same_arrays(got, want)
    assert got[".key"].tolist() == [0, 3]
    assert json.loads((tmp_path / "ckpts" / "step_7" / "meta.json")
                      .read_text())["step"] == 7
    assert path.endswith("step_7")


@pytest.mark.parametrize("kind", ["mock", "vsd"])
def test_jax_checkpoint_loads_in_port(tmp_path, kind, request):
    tj, tt = _trainers(request.getfixturevalue("vsd_pair")
                       if kind == "vsd" else (None, None))
    rng = np.random.default_rng(1)
    leaves, treedef = jax.tree_util.tree_flatten(tj.state)
    tj.state = jax.tree_util.tree_unflatten(
        treedef, [jnp.asarray(_random_like(x, rng)) for x in leaves])
    ckpt_j.save_checkpoint(tmp_path / "ckpts", 5, tj.state)
    assert tt.load(tmp_path / "ckpts" / "step_5") == 5
    want = ckpt_j._flatten_with_paths(tj.state)
    got = ckpt_t.state_arrays(tt.state, seed=0)
    got[".key"] = want[".key"]          # the port carries no JAX key
    _assert_same_arrays(got, want)
    # the latest step of a ckpts dir; the active rows of the scene
    ckpt_j.save_checkpoint(tmp_path / "ckpts", 9, tj.state)
    assert ckpt_t.latest_checkpoint(tmp_path / "ckpts").endswith("step_9")
    a_t = ckpt_t.scene_arrays_from_checkpoint(tmp_path / "ckpts")
    a_j = ckpt_j.scene_arrays_from_checkpoint(tmp_path / "ckpts")
    assert set(a_t) == set(a_j) == set(FIELDS)
    for k in a_j:
        np.testing.assert_array_equal(a_t[k], a_j[k], err_msg=k)


def test_guidance_leaf_names_round_trip(vsd_pair):
    """Every TINY_VSD trainable leaf: flax path -> torch key (the
    loader's ``_gp_leaf``) -> flax path again, kernels transposed back."""
    g_j = vsd_pair[0]
    leaves = {k: np.asarray(v) for k, v in g_j.trainable_params.items()}
    assert len(leaves) > 10
    for name, arr in leaves.items():
        key, torch_arr = _gp_leaf(name, arr)
        assert "/" not in key
        back, back_arr = ckpt_t._jax_gp_leaf(key, torch_arr)
        assert back == name
        np.testing.assert_array_equal(back_arr, arr, err_msg=name)
    path, kind = convert.torch_key_to_flax_path(
        "down_blocks.0.resnets.1.conv1.weight", 4)
    assert path == ("down_blocks_0", "resnets_1", "conv1", "kernel")
    w = np.arange(2 * 3 * 5 * 7, dtype=np.float32).reshape(2, 3, 5, 7)
    np.testing.assert_array_equal(
        convert.to_torch_leaf(kind, convert.to_flax_leaf(kind, w)), w)


def _scene(seed=3, n=300, capacity=400, svec=0.2):
    s = scene3d(n, seed=seed, capacity=capacity, svec=svec)
    p_j = GaussianParams(**{f: jnp.asarray(s[f]) for f in FIELDS})
    p_t = {f: t(s[f]) for f in FIELDS}
    return s, p_j, jnp.asarray(s["active"]), p_t, t(s["active"])


def test_ply_and_splat_bytes_equal_jax(tmp_path):
    s, p_j, a_j, p_t, a_t = _scene()
    # a spread of logits and log-scales, some near the bytes' rounding
    s["alpha"][:300] = np.linspace(-9.0, 9.0, 300, dtype=np.float32)
    p_j = p_j._replace(alpha=jnp.asarray(s["alpha"]))
    p_t["alpha"] = t(s["alpha"])
    for ext, fn_j, fn_t in (
            ("ply", lambda p: export_j.to_ply(p_j, a_j, p),
             lambda p: export_t.to_ply(p_t, a_t, p)),
            ("splat", lambda p: export_j.to_splat(p_j, a_j, p, RenderJ()),
             lambda p: export_t.to_splat(p_t, a_t, p, RenderConfig()))):
        fn_j(tmp_path / f"j.{ext}")
        fn_t(tmp_path / f"t.{ext}")
        want = (tmp_path / f"j.{ext}").read_bytes()
        assert (tmp_path / f"t.{ext}").read_bytes() == want, ext
    assert len(want) == 300 * 32


def test_host_activations_equal_xla():
    """The splat's float32 exp and sigmoid bit for bit as XLA computes
    them on the CPU, over the whole finite range and its clamps."""
    x = np.concatenate([
        np.linspace(-100.0, 100.0, 400_001, dtype=np.float32),
        np.random.default_rng(2).standard_normal(200_000).astype(
            np.float32) * 5.0, np.array([88.72, 88.8, -87.8, 0.0],
                                        np.float32)])
    np.testing.assert_array_equal(export_t.exp_f32(x), np.asarray(jnp.exp(x)))
    np.testing.assert_array_equal(export_t.sigmoid_f32(x),
                                  np.asarray(jax.nn.sigmoid(x)))


def test_density_grid_and_mesh_match_jax(tmp_path):
    _, p_j, a_j, p_t, a_t = _scene()
    g_j, L_j = export_j.density_grid(p_j, a_j, RenderJ(), reso=16)
    g_t, L_t = export_t.density_grid(p_t, a_t, RenderConfig(), reso=16)
    assert L_t == L_j
    assert g_j.max() > 0.5
    np.testing.assert_allclose(g_t, np.asarray(g_j), rtol=0, atol=1e-5)
    export_j.to_mesh(p_j, a_j, RenderJ(), tmp_path / "j.obj", reso=16)
    export_t.to_mesh(p_t, a_t, RenderConfig(), tmp_path / "t.obj", reso=16)

    def read(path):
        lines = path.read_text().splitlines()
        v = np.array([[float(x) for x in ln.split()[1:]] for ln in lines
                      if ln.startswith("v ")])
        f = np.array([[int(x) for x in ln.split()[1:]] for ln in lines
                      if ln.startswith("f ")])
        return v, f

    (v_j, f_j), (v_t, f_t) = read(tmp_path / "j.obj"), read(tmp_path / "t.obj")
    assert len(f_j) > 100 and f_t.shape == f_j.shape
    np.testing.assert_array_equal(f_t, f_j)
    np.testing.assert_allclose(v_t, v_j, rtol=0, atol=1e-5)


@pytest.mark.parametrize("kind", ["l1", "l2"])
def test_ssim_and_image_loss_match_jax(kind):
    rng = np.random.default_rng(4)
    a = rng.random((RES, 24, 3)).astype(np.float32)
    b = np.clip(a + 0.1 * rng.standard_normal(a.shape), 0, 1).astype(
        np.float32)
    np.testing.assert_allclose(
        float(losses_t.ssim(t(a), t(b))),
        float(losses_j.ssim(jnp.asarray(a), jnp.asarray(b))), rtol=0,
        atol=1e-6)
    np.testing.assert_allclose(
        float(losses_t.image_loss(t(a), t(b), 0.2, kind)),
        float(losses_j.image_loss(jnp.asarray(a), jnp.asarray(b), 0.2, kind)),
        rtol=0, atol=1e-6)


def test_bicubic_upsample_matches_jax_resize():
    x = np.random.default_rng(5).random((2, 16, 16, 3)).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (2, 64, 64, 3),
                                       "cubic"))
    got = upsample_t.bicubic_upsample(t(x), 64).numpy()
    for rows in (slice(0, 3), slice(61, 64), slice(None)):
        np.testing.assert_allclose(got[:, rows], want[:, rows], rtol=0,
                                   atol=1e-5)
        np.testing.assert_allclose(got[:, :, rows], want[:, :, rows],
                                   rtol=0, atol=1e-5)
    # torch's bicubic (a = -0.75, edge clamp) is another resize
    other = torch.nn.functional.interpolate(
        t(x).permute(0, 3, 1, 2), size=(64, 64), mode="bicubic",
        align_corners=False).permute(0, 2, 3, 1).numpy()
    assert np.abs(other - want).max() > 1e-3
    with pytest.raises(NotImplementedError, match="Queue 1 item 6"):
        upsample_t.make_diffusion_upsampler(None, 256)


def test_colormaps_equal_jax():
    rng = np.random.default_rng(6)
    x = rng.random((20, 20, 1)).astype(np.float32)
    x[0, :3, 0] = [0.0, 1.0, np.nan]
    for name in ("viridis", "turbo", "gray"):
        np.testing.assert_array_equal(cmap_t.apply_float_colormap(x, name),
                                      cmap_j.apply_float_colormap(x, name))
    out = {k: rng.random((8, 8, 3) if k == "rgb" else (8, 8)).astype(
        np.float32) for k in ("rgb", "depth", "opacity", "z_var")}
    np.testing.assert_array_equal(cmap_t.eval_image_strip(out),
                                  cmap_j.eval_image_strip(out))


def _lut_step(name):
    lut = cmap_t._lut(name)
    return float(np.abs(np.diff(lut, axis=0)).max())


def test_eval_image_and_video_match_jax():
    s = scene3d(150, seed=7, capacity=200, mean_std=0.4, svec=0.06)
    state_j = SceneState(
        params=GaussianParams(**{f: jnp.asarray(s[f]) for f in FIELDS}),
        active=jnp.asarray(s["active"]), max_radii2d=jnp.zeros(200),
        grad_accum=jnp.zeros(200), grad_cnt=jnp.zeros(200))
    state_t = scene_from_numpy(s, "cpu")
    intr_j, intr_t = IntrJ.from_reso(RES), CameraIntrinsics.from_reso(RES)
    img_j = eval_j.eval_image(state_j, intr_j, RENDER_J,
                              np.random.default_rng(3))
    img_t = eval_t.eval_image(state_t, intr_t, RenderConfig(**RKW),
                              np.random.default_rng(3))
    assert img_t.shape == img_j.shape == (RES, 4 * RES, 3)
    rgb = slice(0, RES)
    np.testing.assert_allclose(img_t[:, rgb], img_j[:, rgb], rtol=1e-4,
                               atol=1e-5)
    assert img_j[:, rgb].max() > 0.2
    for c, name in ((1, "turbo"), (2, "gray"), (3, "viridis")):
        cols = slice(c * RES, (c + 1) * RES)
        np.testing.assert_allclose(img_t[:, cols], img_j[:, cols], rtol=0,
                                   atol=_lut_step(name) + 1e-5,
                                   err_msg=name)
    v_j = eval_j.eval_video(state_j, intr_j, RENDER_J, n_frames=3)
    v_t = eval_t.eval_video(state_t, intr_t, RenderConfig(**RKW), n_frames=3)
    assert v_t.shape == v_j.shape == (3, RES, RES, 3)
    np.testing.assert_allclose(v_t, v_j, rtol=1e-4, atol=1e-5)


def test_tune_with_upsample_matches_jax():
    """Two epochs of the fine-tune on the same scene, poses (both pose
    providers draw from default_rng(seed)) and targets: 64² renders
    through the same upsample function."""
    tj, tt = _trainers()
    raw = scene3d(96, seed=11, capacity=128, mean_std=0.4)
    tj.state = tj.state._replace(scene=tj.state.scene._replace(
        params=GaussianParams(**{f: jnp.asarray(raw[f]) for f in FIELDS})))
    tt.state = train_state_from_jax_arrays(
        ckpt_j._flatten_with_paths(tj.state), "cpu")
    kw = dict(num_poses=4, batch_size=2, reso=64, epoch=2, use_cache=False)
    losses_j_ = upsample_j.tune_with_upsample(
        tj, upsample_j.UpsampleTuneConfig(**kw),
        upsample_fn=lambda rgb, key, batch: 1.0 - rgb)
    losses_t_ = upsample_t.tune_with_upsample(
        tt, upsample_t.UpsampleTuneConfig(**kw),
        upsample_fn=lambda rgb, batch: 1.0 - rgb)
    assert len(losses_t_) == len(losses_j_) == 4
    assert losses_j_[0] > 0.01
    np.testing.assert_allclose(losses_t_, losses_j_, rtol=1e-4)
    for f in FIELDS:
        moved = tt.state.scene.params[f] - t(raw[f])
        assert float(moved.abs().max()) > 0, f


def test_periodic_logging_writes_expected_files(tmp_path, monkeypatch):
    """log_period 2, field stats 2, eval images 2, video and checkpoint 3
    over 5 steps: scalars at 0, 2, 4; images at 0, 2, 4; video and
    checkpoint at 3 only (never at step 0); without imageio the video is
    PNG frames."""
    cfg = dict(max_steps=100, batch_size=1, log_period=2,
               field_stats_period=2, eval_image_period=2,
               eval_video_period=3, save_period=3, eval_n_frames=2)
    log = logging_t.RunLogger(root=tmp_path, name="a corgi",
                              use_tensorboard=False)
    tr = Trainer(cfg=TrainerConfig(**cfg), rcfg=RenderConfig(**RKW),
                 init_cfg=InitConfig(**INIT), bg_cfg=BackgroundConfig(),
                 data_cfg=CameraSamplerConfig(**DATA),
                 dcfg=DensifyConfig(enabled=False),
                 pcfg=PruneConfig(enabled=False), device="cpu", logger=log)
    monkeypatch.setitem(sys.modules, "imageio", None)
    monkeypatch.setitem(sys.modules, "imageio.v2", None)
    tr.fit(5)
    log.close()
    assert log.dir.parts[-3] == "a_corgi"
    recs = [json.loads(ln) for ln in
            (log.dir / "scalars.jsonl").read_text().splitlines()]
    assert [r["step"] for r in recs] == [0, 0, 2, 2, 4, 4]
    assert recs[0]["num_gaussians"] == 96 and "loss_total" in recs[0]
    assert "lr_mean" in recs[0] and "fields/alpha/rms" in recs[1]
    assert sorted(p.name for p in log.eval_dir.glob("*.png")) == [
        f"eval_image_{s:06d}.png" for s in (0, 2, 4)]
    frames = sorted((log.eval_dir / "orbit_000003").glob("*.png"))
    assert [p.name for p in frames] == ["frame_0000.png", "frame_0001.png"]
    assert [p.name for p in log.ckpt_dir.iterdir()] == ["step_3"]
    tr2 = Trainer(cfg=TrainerConfig(**cfg), rcfg=RenderConfig(**RKW),
                  init_cfg=InitConfig(**INIT), bg_cfg=BackgroundConfig(),
                  data_cfg=CameraSamplerConfig(**DATA), device="cpu")
    assert tr2.load(log.ckpt_dir) == 3 and tr2.state.step == 4


def test_png_writer_and_video_forms(tmp_path, capsys):
    from PIL import Image
    img = np.random.default_rng(8).random((5, 7, 3)).astype(np.float32)
    logging_t.write_png(tmp_path / "a.png", img)
    back = np.asarray(Image.open(tmp_path / "a.png"))
    np.testing.assert_array_equal(back, (img * 255).astype(np.uint8))
    log = logging_t.RunLogger(root=tmp_path, use_tensorboard=False)
    path = log.log_video(1, "eval/orbit", np.stack([img, 1 - img]), fmt="gif")
    assert path.endswith("eval_orbit_000001.gif")
    assert "eval video step 1" in capsys.readouterr().out
    log.save_config({"a": 1})
    assert json.loads((log.dir / "config.json").read_text()) == {"a": 1}
    log.close()
