"""gsgen_torch's DeepFloyd IF path against the JAX package: the UNet's
``encoder_hid_proj`` and "timestep" class embedding, the pixel-space
backbone (no VAE), the ``if`` SDS loss (pixel space, CFG 20, the
variance half split off) with its gradient to the render, the IF
guidance-eval sample, and the IF-II-style upsampler on TINY_SR; then the
configs: ``guidance/if.yaml`` builds the IF_PIXEL backbone at full width
and trains on the TINY preset, and ``make_diffusion_upsampler`` drives the
upsample fine-tune.

Both sides get the same numpy inputs, the flax parameters carried across
through the port's ``convert.py``, and the JAX functions' own draws
(repeated from their keys) as ``t``, ``noise``, ``x`` and ``aug_noise``.
The JAX upsampler is built around a jitted init (its own ``__init__``
initialises flax eagerly, ~400 compiles on the CPU); its
``upsample_images`` runs as it is.  The JAX UNet runs its einsum attention
(``set_fused_attention("off")``).  Tolerances (fp32 on the CPU): UNet eps,
samples and upsampled images within 1e-4 of the output's largest value;
encode / decode atol 1e-5 (a resize); the SDS loss rtol 1e-4 and its rgb
gradient within 1e-4 of its largest value.
"""

import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsgen_tpu.guidance import unet2d as unet_j
from gsgen_tpu.guidance import upsampler as ups_j
from gsgen_tpu.guidance.diffusion import scaled_linear_schedule as sched_j
from gsgen_tpu.guidance.sd_unet import SDUNetBackbone as BackboneJ
from gsgen_tpu.guidance.sds import SDSConfig as SDSConfigJ
from gsgen_tpu.guidance.sds import SDSGuidance as SDSGuidanceJ
from gsgen_tpu.prompt import processors as proc_j
from gsgen_torch.config import build_trainer, load_config
from gsgen_torch.guidance import upsampler
from gsgen_torch.guidance.convert import flax_to_torch_state
from gsgen_torch.guidance.sd_unet import (IF_PIXEL, TINY, SDUNetBackbone,
                                          backbone_from_jax_params)
from gsgen_torch.guidance.sds import SDSConfig, SDSGuidance
from gsgen_torch.guidance.unet2d import UNet2DConditionModel
from gsgen_torch.ops import flash_attention as fa
from gsgen_torch.prompt import processors
from torch_fixtures import t

ROOT = Path(__file__).resolve().parents[1]
# an IF-shaped TINY: 3 channels in, (eps, variance) out, a 64-wide text
# encoder projected to the cross-attention width
TINY_IF_J = dataclasses.replace(unet_j.TINY, in_channels=3, out_channels=6,
                                encoder_hid_dim=64)
TINY_IF = dataclasses.replace(TINY, in_channels=3, out_channels=6,
                              encoder_hid_dim=64)
LATENT = 16
POSE = (np.array([10.0, 70.0], np.float32),
        np.array([20.0, -160.0], np.float32),
        np.array([2.5, 2.5], np.float32))
SMALL = ["init.num_points=64", "init.capacity=128", "data.reso=[32]",
         "data.reso_milestones=[]", "renderer.dup_cap=4096",
         "trainer.batch_size=2", "prompt.use_cache=false"]


@pytest.fixture(scope="module", autouse=True)
def _einsum_attention():
    unet_j.set_fused_attention("off")
    yield
    unet_j.set_fused_attention("auto")


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(got, want, frac=1e-4, msg=""):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=frac * np.abs(want).max(), err_msg=msg)


def _encode64(texts):
    return proc_j.mock_encode(texts, D=64)


@pytest.fixture(scope="module")
def pixel():
    """The pixel-space TINY_IF backbone in both packages, and the prompt
    embeddings of a 64-wide mock encoder."""
    bb_j = BackboneJ(TINY_IF_J, latent_size=LATENT, use_vae=False)
    assert set(bb_j.params) == {"unet"}
    bb_t = backbone_from_jax_params(_np(bb_j.params), TINY_IF,
                                    latent_size=LATENT, device="cpu")
    cfg = dict(prompt="a corgi", use_cache=False)
    emb_j = proc_j.PromptProcessor(proc_j.PromptProcessorConfig(**cfg),
                                   encode_fn=_encode64)()
    emb_t = processors.PromptProcessor(
        processors.PromptProcessorConfig(**cfg),
        encode_fn=lambda texts: processors.mock_encode(texts, D=64),
        device="cpu")()
    return bb_j, bb_t, emb_j, emb_t


@pytest.fixture(scope="module")
def tiny_sr():
    """The JAX TINY_SR UNet's parameters from a jitted init, the JAX
    DiffusionUpsampler around them, and the port's upsampler holding
    them."""
    cfg_j = ups_j.UpsamplerConfig(reso=16, num_steps=3)
    up_j = object.__new__(ups_j.DiffusionUpsampler)
    up_j.cfg, up_j.unet_cfg = cfg_j, ups_j.TINY_SR
    up_j.unet = unet_j.UNet2DConditionModel(ups_j.TINY_SR)
    up_j.schedule = sched_j()
    up_j.params = jax.jit(up_j.unet.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 6)), jnp.zeros((1,)),
        jnp.zeros((1, 4, 1024)), class_labels=jnp.zeros((1,), jnp.int32))
    up_t = upsampler.DiffusionUpsampler(
        upsampler.UpsamplerConfig(reso=16, num_steps=3), upsampler.TINY_SR,
        device="cpu")
    up_t.unet.load_state_dict({k: torch.tensor(v) for k, v in
                               flax_to_torch_state(_np(up_j.params)).items()},
                              strict=True)
    return up_j, up_t


def test_if_yaml_builds_if_pixel_and_trains_on_tiny(monkeypatch, tmp_path):
    """guidance/if.yaml over base.yaml: deep_floyd is SDS in pixel space
    with CFG 20 on IF_PIXEL (no VAE, 64^2, bf16 weights, T5's 4096-wide
    context projected to 256); on the TINY preset two steps train, and K5
    never runs on the CPU."""
    monkeypatch.chdir(tmp_path)
    cfgs = [ROOT / "configs" / n for n in ("base.yaml", "guidance/if.yaml",
                                           "prompt/if.yaml")]
    tr = build_trainer(load_config(cfgs, SMALL), device="cpu")
    g = tr.guidance
    assert isinstance(g, SDSGuidance)
    assert g.cfg.rgb_as_latents and g.cfg.guidance_scale == 20.0
    bb = g.backbone
    assert bb.cfg == IF_PIXEL and bb.vae is None
    assert (bb.latent_size, bb.image_size, bb.latent_channels) == (64, 64, 3)
    assert all(p.dtype == torch.bfloat16 for p in bb.parameters())
    assert tuple(bb.unet.encoder_hid_proj.weight.shape) == (256, 4096)
    assert not hasattr(bb.unet, "class_embedding")
    del tr, g, bb

    tr = build_trainer(load_config(cfgs, SMALL + [
        "guidance.backbone_preset=tiny"]), device="cpu")
    n5 = fa.flash_self_attention.launches
    losses = []
    tr.fit(2, callback=lambda i, m: losses.append(float(m["loss_sds"])))
    assert tr.state.step == 2 and all(np.isfinite(losses))
    assert fa.flash_self_attention.launches == n5
    img = tr._guidance_sample(2)
    size = tr.guidance.backbone.image_size
    assert img.shape == (size, size, 3) and np.isfinite(img).all()


def test_unet_encoder_hid_proj_matches_jax(pixel):
    bb_j, bb_t, _, _ = pixel
    w = bb_t.unet.state_dict()["encoder_hid_proj.weight"]
    assert tuple(w.shape) == (1024, 64)
    assert bb_t.vae is None and bb_t.image_size == LATENT
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, LATENT, LATENT, 3)).astype(np.float32)
    ctx = rng.standard_normal((2, 7, 64)).astype(np.float32)
    tt = np.array([10, 700], np.int32)
    want = jax.jit(bb_j.predict_noise)(bb_j.params, jnp.asarray(x),
                                       jnp.asarray(tt), jnp.asarray(ctx))
    got = bb_t.predict_noise(t(x), t(tt), t(ctx))
    assert got.shape == (2, LATENT, LATENT, 6)
    _close(got.numpy(), want)


def test_unet_timestep_class_embedding_matches_jax(tiny_sr):
    """Integer class labels (IF-II's noise level) through the sinusoid at
    block_out_channels[0], then the class TimestepEmbedding."""
    up_j, up_t = tiny_sr
    w = up_t.unet.state_dict()["class_embedding.linear_1.weight"]
    assert tuple(w.shape) == (128, 32)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 16, 16, 6)).astype(np.float32)
    ctx = rng.standard_normal((2, 5, 1024)).astype(np.float32)
    tt, lv = np.array([999, 3], np.int32), np.array([250, 40], np.int32)
    want = jax.jit(up_j.unet.apply)(up_j.params, jnp.asarray(x),
                                    jnp.asarray(tt), jnp.asarray(ctx),
                                    class_labels=jnp.asarray(lv))
    got = up_t.unet(t(x), t(tt), t(ctx), class_labels=t(lv))
    _close(got.numpy(), want)
    other = up_t.unet(t(x), t(tt), t(ctx), class_labels=t(lv + 100))
    assert float((other - got).abs().max()) > 1e-4


def test_pixel_backbone_encode_decode_matches_jax(pixel):
    bb_j, bb_t, _, _ = pixel
    rng = np.random.default_rng(2)
    for size in (24, 8):          # shrink (antialiased) and enlarge
        img = rng.random((2, size, size, 3)).astype(np.float32)
        np.testing.assert_allclose(
            bb_t.encode_images(t(img)).numpy(),
            np.asarray(bb_j.encode_images(bb_j.params, jnp.asarray(img))),
            rtol=0, atol=1e-5)
    lat = rng.standard_normal((2, LATENT, LATENT, 3)).astype(np.float32)
    np.testing.assert_allclose(
        bb_t.decode_latents(t(lat)).numpy(),
        np.asarray(bb_j.decode_latents(bb_j.params, jnp.asarray(lat))),
        rtol=0, atol=1e-6)
    # a 4-channel pixel backbone pads with zeros mapped to -1
    bb4 = SDUNetBackbone(TINY, latent_size=8, device="cpu", use_vae=False)
    enc = bb4.encode_images(torch.full((1, 8, 8, 3), 0.5))
    assert enc.shape == (1, 8, 8, 4)
    assert float(enc[..., :3].abs().max()) == 0.0
    assert bool((enc[..., 3] == -1.0).all())


def test_if_sds_loss_and_render_gradient_match_jax(pixel):
    """SDS in pixel space (rgb_as_latents, CFG 20): the 6-channel eps is
    split to its eps half; the JAX loss's t and noise repeated from its
    key."""
    bb_j, bb_t, emb_j, emb_t = pixel
    cfg = dict(rgb_as_latents=True, guidance_scale=20.0)
    g_j = SDSGuidanceJ(SDSConfigJ(**cfg), bb_j)
    g_t = SDSGuidance(SDSConfig(**cfg), bb_t, device="cpu")
    rgb = np.random.default_rng(3).random((2, 32, 32, 3)).astype(np.float32)
    key = jax.random.PRNGKey(4)
    sched = {"min_t": 20, "max_t": 980}
    pose_j = [jnp.asarray(p) for p in POSE]

    def loss_j(x):
        return g_j.loss({"frozen": g_j.frozen_params}, x, emb_j, *pose_j,
                        key, sched)["loss_sds"]

    want, want_g = jax.jit(jax.value_and_grad(loss_j))(jnp.asarray(rgb))
    k_t, k_noise = jax.random.split(key)
    tt = np.asarray(jax.random.randint(k_t, (2,), 20, 981))
    noise = np.asarray(jax.random.normal(k_noise, (2, LATENT, LATENT, 3)))
    x = t(rgb).requires_grad_(True)
    out = g_t.loss(x, emb_t, *map(t, POSE), t=t(tt).long(), noise=t(noise))
    out["loss_sds"].backward()
    np.testing.assert_allclose(float(out["loss_sds"].detach()), float(want),
                               rtol=1e-4)
    _close(x.grad.numpy(), want_g)


def test_if_guidance_sample_matches_jax(pixel):
    """The IF guidance-eval image: DDIM on the pixel backbone, decoded by
    the [-1, 1] map (no VAE)."""
    bb_j, bb_t, emb_j, emb_t = pixel
    g_j = SDSGuidanceJ(SDSConfigJ(rgb_as_latents=True, guidance_scale=20.0),
                       bb_j)
    g_t = SDSGuidance(SDSConfig(rgb_as_latents=True, guidance_scale=20.0),
                      bb_t, device="cpu")
    key = jax.random.PRNGKey(8)
    x = np.asarray(jax.random.normal(jax.random.split(key)[0],
                                     (2, LATENT, LATENT, 3)))
    want = g_j.sample({"frozen": g_j.frozen_params}, emb_j,
                      *map(jnp.asarray, POSE), key, num_steps=3)
    got = g_t.sample(emb_t, *map(t, POSE), num_steps=3, x=t(x))
    assert got.shape == (2, LATENT, LATENT, 3)
    _close(got.numpy(), want)


def test_upsample_images_matches_jax(tiny_sr):
    """TINY_SR at a 16^2 target, 3 steps: the bilinear conditioning image
    noised to level 250, CFG DDIM on the eps half, x0 clipped to [-1, 1],
    alphas_cumprod 1 after the last step."""
    up_j, up_t = tiny_sr
    rng = np.random.default_rng(5)
    rgb = rng.random((2, 8, 8, 3)).astype(np.float32)
    text2 = rng.standard_normal((4, 5, 1024)).astype(np.float32)
    key = jax.random.PRNGKey(6)
    want = up_j.upsample_images(up_j.params, jnp.asarray(rgb),
                                jnp.asarray(text2), key)
    k_aug, k_x = jax.random.split(key)
    aug = np.asarray(jax.random.normal(k_aug, (2, 16, 16, 3)))
    x = np.asarray(jax.random.normal(k_x, (2, 16, 16, 3)))
    got = up_t.upsample_images(t(rgb), t(text2), aug_noise=t(aug), x=t(x))
    assert got.shape == (2, 16, 16, 3)
    _close(got.numpy(), want)
    # a generator draws both itself, reproducibly
    g1, g2 = (torch.Generator().manual_seed(1) for _ in range(2))
    np.testing.assert_array_equal(
        up_t.upsample_images(t(rgb), t(text2), generator=g1).numpy(),
        up_t.upsample_images(t(rgb), t(text2), generator=g2).numpy())
    # bound to a prompt at fixed poses: the view-dependent text of each
    # row's pose, the draws from the bound generator
    emb = processors.PromptProcessor(
        processors.PromptProcessorConfig(use_cache=False), device="cpu")()
    fn = up_t.make_upsample_fn(emb, *map(t, POSE),
                               generator=torch.Generator().manual_seed(1))
    np.testing.assert_allclose(
        fn(t(rgb)).numpy(),
        up_t.upsample_images(
            t(rgb), emb.get_text_embedding(*map(t, POSE)),
            generator=torch.Generator().manual_seed(1)).numpy(),
        rtol=0, atol=0)
    with pytest.raises(FileNotFoundError, match="no .safetensors"):
        up_t.load_weights("/nonexistent/if2.safetensors")


def test_upsampler_presets_at_full_width():
    """IF2_PIXEL (6 -> 6 channels, T5 context, noise-level embedding) and
    TINY_SR as modules: the parameter names a diffusers IF-II checkpoint
    would fill."""
    with torch.device("meta"):
        m = UNet2DConditionModel(upsampler.IF2_PIXEL)
    sd = m.state_dict()
    assert tuple(sd["conv_in.weight"].shape) == (64, 6, 3, 3)
    assert tuple(sd["conv_out.weight"].shape) == (6, 64, 3, 3)
    assert tuple(sd["encoder_hid_proj.weight"].shape) == (256, 4096)
    assert tuple(sd["class_embedding.linear_1.weight"].shape) == (256, 64)
    up = upsampler.DiffusionUpsampler(device="meta")
    assert up.unet_cfg == upsampler.TINY_SR and up.cfg.num_steps == 50
