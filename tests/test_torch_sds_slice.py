"""The SDS slice as a whole: render + SDS guidance vs the JAX package, and
``configs/`` runs through the port's ``build_trainer``.

The gradient test renders a batch of two views (RES 32) of the same raw
scene in both packages, takes the SDS loss on the TINY SD backbone (the
JAX parameters carried across, the JAX loss's own ``t`` and noise handed
to the port) and compares every scene-parameter gradient.  The JAX side
renders with its Pallas kernels in interpret mode and exact scans, its
UNet on the einsum attention.  Tolerances: the loss rtol 1e-4; gradients
rtol 2e-3 / atol 2e-4 of each field's largest gradient, as for the
render gradients of test_torch_scene.py.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsgen_tpu.guidance import unet2d as unet_j
from gsgen_tpu.guidance.sd_unet import SDUNetBackbone as BackboneJ
from gsgen_tpu.guidance.sds import SDSConfig as SDSConfigJ
from gsgen_tpu.guidance.sds import SDSGuidance as SDSGuidanceJ
from gsgen_tpu.models.scene import GaussianParams
from gsgen_tpu.models.scene import RenderConfig as RenderConfigJ
from gsgen_tpu.models.scene import render_batch as batch_j
from gsgen_tpu.ops.camera import CameraIntrinsics as IntrJ
from gsgen_tpu.prompt import processors as proc_j
from gsgen_torch.config import build_trainer, load_config
from gsgen_torch.data.cameras import CameraPoseProvider, CameraSamplerConfig
from gsgen_torch.guidance.diffusion import MockUNet
from gsgen_torch.guidance.sd_unet import (TINY, SDUNetBackbone,
                                          backbone_from_jax_params)
from gsgen_torch.guidance.sds import SDSConfig, SDSGuidance
from gsgen_torch.models.scene import (FIELDS, RenderConfig, render_batch,
                                      scene_from_numpy)
from gsgen_torch.ops.camera import CameraIntrinsics
from gsgen_torch.prompt import processors
from torch_fixtures import RES, scene3d, t

ROOT = Path(__file__).resolve().parents[1]
KW = dict(tile_size=8, chunk=128, dup_cap=4096)
SMALL = ["init.num_points=96", "init.capacity=128", "data.reso=[32]",
         "renderer.tile_size=8", "renderer.chunk=128",
         "renderer.dup_cap=4096", "trainer.batch_size=2",
         "prompt.use_cache=false"]
TINY_SD = ["guidance.backbone=sd_unet", "guidance.backbone_preset=tiny"]


@pytest.fixture
def jax_einsum_attention():
    unet_j.set_fused_attention("off")
    yield
    unet_j.set_fused_attention("auto")


def test_render_plus_sds_scene_gradients_match_jax(jax_einsum_attention):
    raw = scene3d(120, seed=8, capacity=128, mean_std=0.4)
    B = 2
    b = CameraPoseProvider(CameraSamplerConfig(
        batch_size=B, reso=(RES,), camera_distance=(2.0, 2.5)),
        seed=9).get_batch()
    bgs = np.array([[1.0, 1.0, 1.0], [0.2, 0.4, 0.6]], np.float32)
    bb_j = BackboneJ(unet_j.TINY, latent_size=8)
    g_j = SDSGuidanceJ(SDSConfigJ(), bb_j)
    emb_j = proc_j.PromptProcessor(
        proc_j.PromptProcessorConfig(use_cache=False))()
    sched = g_j.sched_scalars(0, 15000)
    key = jax.random.PRNGKey(3)
    rcfg_j = RenderConfigJ(backend="pallas", pallas_interpret=True,
                           mxu_scans=False, fast_fwd_cumprod=False, **KW)

    def loss_j(p):
        o = batch_j(p, jnp.asarray(raw["active"]), jnp.asarray(b["c2w"]),
                    IntrJ.from_reso(RES), rcfg_j, jnp.asarray(bgs),
                    *(jnp.asarray(b[k]) for k in ("fx", "fy", "cx", "cy")))
        return g_j.loss(g_j.params, o["rgb"], emb_j,
                        jnp.asarray(b["elevation"]), jnp.asarray(b["azimuth"]),
                        jnp.asarray(b["camera_distance"]), key,
                        sched)["loss_sds"]

    val_j, g_p = jax.value_and_grad(loss_j)(
        GaussianParams(**{f: jnp.asarray(raw[f]) for f in FIELDS}))
    k_t, k_noise = jax.random.split(key)
    tt = jax.random.randint(k_t, (B,), sched["min_t"], sched["max_t"] + 1)
    noise = jax.random.normal(k_noise, (B, 8, 8, 4))

    bb_t = backbone_from_jax_params(
        jax.tree_util.tree_map(np.asarray, bb_j.params), TINY,
        latent_size=8, device="cpu")
    g_t = SDSGuidance(SDSConfig(), bb_t, device="cpu")
    emb_t = processors.PromptProcessor(
        processors.PromptProcessorConfig(use_cache=False), device="cpu")()
    scene = scene_from_numpy(raw, "cpu")
    params = {k: v.requires_grad_(True) for k, v in scene.params.items()}
    o = render_batch(params, scene.active, t(b["c2w"]),
                     CameraIntrinsics.from_reso(RES), RenderConfig(**KW),
                     t(bgs), t(b["fx"]), t(b["fy"]), t(b["cx"]), t(b["cy"]))
    out = g_t.loss(o["rgb"], emb_t, t(b["elevation"]), t(b["azimuth"]),
                   t(b["camera_distance"]), sched=sched, t=t(tt).long(),
                   noise=t(noise))
    out["loss_sds"].backward()
    np.testing.assert_allclose(float(out["loss_sds"].detach()), float(val_j),
                               rtol=1e-4)
    for f in FIELDS:
        a, want = params[f].grad.numpy(), np.asarray(getattr(g_p, f))
        scale = float(np.abs(want).max())
        assert scale > 0, f
        np.testing.assert_allclose(a, want, rtol=2e-3, atol=2e-4 * scale,
                                   err_msg=f)


def test_base_yaml_tiny_sd_backbone_trains_two_steps():
    tr = build_trainer(load_config(ROOT / "configs" / "base.yaml",
                                   SMALL + TINY_SD + [
                                       "guidance.backbone_dtype=bfloat16"]),
                       device="cpu")
    bb = tr.guidance.backbone
    assert isinstance(bb, SDUNetBackbone) and bb.latent_size == 8
    assert not bb.training
    assert all(p.dtype == torch.bfloat16 and not p.requires_grad
               for p in bb.parameters())
    assert not any(k.startswith(("unet", "vae")) for k in tr.state.opt.mu)
    p0 = {k: v.clone() for k, v in tr.state.scene.params.items()}
    losses = []
    tr.fit(2, callback=lambda s, m: losses.append(float(m["loss_sds"])))
    assert tr.state.step == 2 and all(np.isfinite(losses))
    assert losses[0] != losses[1]
    for k, v in tr.state.scene.params.items():
        assert float((v - p0[k]).abs().max()) > 0, k
    s = tr.sched_scalars(0)
    assert (s["min_t"], s["max_t"]) == (20, 980)


def test_config_guidance_selection(tmp_path, monkeypatch):
    """base.yaml as it is builds SDS on MockUNet; the flagship rehearsal
    builds (TINY preset here) and steps at its c2f stage 0; DeepFloyd's
    guidance types build pixel-space SDS; what is not ported (weights,
    encoders) raises."""
    monkeypatch.chdir(tmp_path)          # the prompt cache is cwd-relative
    tr = build_trainer(load_config(ROOT / "configs" / "base.yaml"),
                       device="cpu")
    assert isinstance(tr.guidance, SDSGuidance)
    assert isinstance(tr.guidance.backbone, MockUNet)
    assert tr.guidance.backbone.latent_size == 64
    assert tr.prompt_processor().text_vd.shape == (4, 77, 1024)
    assert tr.sched_scalars(2001)["max_t"] == 500  # C([0, .98, .5, 2001])
    assert (tmp_path / ".cache" / "text_prompt_embeddings").is_dir()

    tr = build_trainer(load_config(
        ROOT / "configs" / "flagship_rehearsal.yaml",
        ["guidance.backbone_preset=tiny", "init.num_points=64",
         "init.capacity=128", "renderer.tile_size=8",
         "trainer.batch_size=1"]), device="cpu")
    assert tr.data.intrinsics().w == 64
    assert tr.guidance.schedule.num_train_timesteps == 1000
    assert isinstance(tr.guidance.backbone, SDUNetBackbone)
    tr.fit(1)
    assert tr.state.step == 1

    base = ROOT / "configs" / "base.yaml"
    # DeepFloyd's types are pixel-space SDS (MockUNet here); CFG 20 is
    # their default only where the config sets no scale (base.yaml: 100)
    for typ in ("if", "deep_floyd"):
        cfg = load_config(base, SMALL)
        del cfg["guidance"]["guidance_scale"]
        cfg["guidance"]["type"] = typ
        g = build_trainer(cfg, device="cpu").guidance
        assert isinstance(g, SDSGuidance) and isinstance(g.backbone,
                                                         MockUNet)
        assert g.cfg.rgb_as_latents and g.cfg.guidance_scale == 20.0
    for bad in (TINY_SD + ["guidance.weights_path=/nonexistent/sd21"],
                ["prompt.model_id=/nonexistent/clip"]):
        with pytest.raises(FileNotFoundError):
            build_trainer(load_config(base, SMALL + bad), device="cpu")
    with pytest.raises(ValueError):
        build_trainer(load_config(base, SMALL + [
            "guidance.fused_attention=fast"]), device="cpu")
