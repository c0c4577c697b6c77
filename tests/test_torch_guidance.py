"""gsgen_torch's SDS guidance vs the JAX package: noise schedules, prompt
embeddings, MockUNet, bilinear resizing and the SDS loss with its
gradient with respect to the render.

Inputs are numpy arrays from a seed handed to both packages; where the
JAX loss draws ``t`` and the noise from its key, the test draws them
with the same JAX calls and hands them to the port.  The JAX UNet runs
its einsum attention (``set_fused_attention("off")``, its own parity
oracle).  Tolerances: schedules within 1e-6 (float32 linspace and
cumprod); the prompt bank and mock_encode bit-exact; embedding selection
exact and perp-neg blends within 1e-6; MockUNet eps and resizes rtol
1e-5 / atol 1e-5 (fp32 convolution and filter summation order); SDS
losses rtol 1e-4 and rgb gradients within 1e-4 of their largest value
(the guidance scale of 100 multiplies the eps difference, which stays a
rounding-level fraction of the gradient).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsgen_tpu.guidance import diffusion as diff_j
from gsgen_tpu.guidance import samplers as samp_j
from gsgen_tpu.guidance import unet2d as unet_j
from gsgen_tpu.guidance.sd_unet import SDUNetBackbone as BackboneJ
from gsgen_tpu.guidance.sd_unet import TINY as TINY_J
from gsgen_tpu.guidance.sds import SDSConfig as SDSConfigJ
from gsgen_tpu.guidance.sds import SDSGuidance as SDSGuidanceJ
from gsgen_tpu.guidance.sds import perpendicular_component as perp_j
from gsgen_tpu.prompt import processors as proc_j
from gsgen_torch.guidance import diffusion, samplers
from gsgen_torch.guidance.sd_unet import TINY, backbone_from_jax_params
from gsgen_torch.guidance.sds import (SDSConfig, SDSGuidance,
                                      perpendicular_component)
from gsgen_torch.prompt import encoders, processors
from torch_fixtures import t


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def jax_tiny():
    """The JAX TINY backbone on its einsum attention."""
    unet_j.set_fused_attention("off")
    yield BackboneJ(TINY_J, latent_size=8)
    unet_j.set_fused_attention("auto")


@pytest.fixture(scope="module")
def jax_mock():
    return diff_j.MockUNet(latent_size=8)


@pytest.mark.parametrize("kind", ["scaled_linear", "cosine"])
def test_schedules_and_add_noise(kind):
    s_j = getattr(diff_j, f"{kind}_schedule")()
    s_t = getattr(diffusion, f"{kind}_schedule")()
    assert s_t.num_train_timesteps == s_j.num_train_timesteps
    np.testing.assert_allclose(s_t.betas.numpy(), np.asarray(s_j.betas),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(s_t.alphas_cumprod.numpy(),
                               np.asarray(s_j.alphas_cumprod), rtol=0,
                               atol=1e-6)
    rng = np.random.default_rng(0)
    x0 = rng.standard_normal((3, 4, 4, 4)).astype(np.float32)
    noise = rng.standard_normal((3, 4, 4, 4)).astype(np.float32)
    tt = np.array([0, 500, 999], np.int32)
    np.testing.assert_allclose(
        s_t.add_noise(t(x0), t(noise), t(tt).long()).numpy(),
        np.asarray(s_j.add_noise(jnp.asarray(x0), jnp.asarray(noise),
                                 jnp.asarray(tt))), rtol=1e-5, atol=1e-5)


def test_resolve_scheduler_and_unported_sampling():
    d = {"type": "pndm", "beta_end": 0.02, "num_steps": 50}
    s_j, c_j = samp_j.resolve_scheduler(d)
    s_t, c_t = samplers.resolve_scheduler(d)
    assert c_t == samplers.SamplerConfig(type="pndm", num_steps=50)
    assert (c_t.type, c_t.num_steps, c_t.eta, c_t.steps_offset) == (
        c_j.type, c_j.num_steps, c_j.eta, c_j.steps_offset)
    np.testing.assert_allclose(s_t.alphas_cumprod.numpy(),
                               np.asarray(s_j.alphas_cumprod), atol=1e-6)
    with pytest.raises(ValueError):
        samplers.resolve_scheduler({"beta_schedule": "linear"})
    # the resolved pair drives cfg_sample: PNDM, 3 steps, one extra eps
    # call for the warm-up, every call a [2B] stack
    calls = []

    def net(lat2, t2):
        calls.append(tuple(lat2.shape))
        return 0.1 * lat2
    x = samplers.cfg_sample(dataclasses.replace(c_t, num_steps=3), s_t,
                            (2, 4, 4, 4), 7.5, net, device="cpu",
                            x=torch.ones(2, 4, 4, 4))
    assert x.shape == (2, 4, 4, 4) and bool(torch.isfinite(x).all())
    assert calls == [(4, 4, 4, 4)] * 4


def test_mock_encode_and_prompt_bank(tmp_path):
    texts = ["a corgi", "", "a corgi, side view"]
    a, b = processors.mock_encode(texts), proc_j.mock_encode(texts)
    assert a.dtype == b.dtype == np.float32
    np.testing.assert_array_equal(a, b)
    cfg = dict(prompt="a cat", negative_prompt="blurry", use_cache=True,
               cache_dir=str(tmp_path), prompt_back="the cat's back")
    e_j = proc_j.PromptProcessor(proc_j.PromptProcessorConfig(**cfg))()
    # the port reads the JAX package's cache files, then its own
    e_t = processors.PromptProcessor(
        processors.PromptProcessorConfig(**cfg), device="cpu")()
    for f in e_j._fields:
        np.testing.assert_array_equal(getattr(e_t, f).numpy(),
                                      np.asarray(getattr(e_j, f)), f)
    assert encoders.build_encode_fn("mock") is None
    assert encoders.build_encode_fn("") is None
    # a directory without a text encoder's safetensors, a path that is no
    # directory, and debiasing beside a per-view prompt raise as in the
    # JAX package
    with pytest.raises(FileNotFoundError, match="no .safetensors"):
        encoders.build_encode_fn(str(tmp_path), device="cpu")
    with pytest.raises(FileNotFoundError, match="not a local model"):
        encoders.build_encode_fn(str(tmp_path / "nowhere"), device="cpu")
    with pytest.raises(AssertionError, match="debiasing"):
        processors.PromptProcessor(processors.PromptProcessorConfig(
            use_prompt_debiasing=True, prompt_side="a cat's side",
            use_cache=False), device="cpu")


def test_view_dependent_and_perp_neg_selection():
    """Selection and blend weights over a grid of views, on a small
    random bank (L=3, D=5)."""
    rng = np.random.default_rng(0)
    bank = [rng.standard_normal(s).astype(np.float32)
            for s in ((3, 5), (3, 5), (4, 3, 5), (4, 3, 5))]
    e_j = proc_j.PromptEmbedding(*(jnp.asarray(b) for b in bank))
    e_t = processors.PromptEmbedding(*(t(b) for b in bank))
    ele, azi = np.meshgrid([-20.0, 0.0, 45.0, 59.9, 60.1, 90.0],
                           np.linspace(-360, 360, 49))
    ele = ele.ravel().astype(np.float32)
    azi = azi.ravel().astype(np.float32)
    dist = np.full_like(ele, 2.5)
    np.testing.assert_array_equal(
        processors.direction_idx(t(ele), t(azi)).numpy(),
        np.asarray(proc_j.direction_idx(jnp.asarray(ele), jnp.asarray(azi))))
    for vd in (True, False):
        np.testing.assert_array_equal(
            e_t.get_text_embedding(t(ele), t(azi), t(dist), vd).numpy(),
            np.asarray(e_j.get_text_embedding(
                jnp.asarray(ele), jnp.asarray(azi), jnp.asarray(dist), vd)))
    emb_t, w_t = e_t.get_text_embeddings_perp_neg(t(ele), t(azi), t(dist))
    emb_j, w_j = e_j.get_text_embeddings_perp_neg(
        jnp.asarray(ele), jnp.asarray(azi), jnp.asarray(dist))
    np.testing.assert_allclose(w_t.numpy(), np.asarray(w_j), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(emb_t.numpy(), np.asarray(emb_j), rtol=0,
                               atol=1e-6)
    x = np.random.default_rng(1).standard_normal((3, 2, 2, 4))
    y = np.random.default_rng(2).standard_normal((3, 2, 2, 4))
    x, y = x.astype(np.float32), y.astype(np.float32)
    np.testing.assert_allclose(
        perpendicular_component(t(x), t(y)).numpy(),
        np.asarray(perp_j(jnp.asarray(x), jnp.asarray(y))), atol=1e-6)


@pytest.mark.parametrize("src,dst", [(512, 64), (64, 512), (512, 512)])
def test_resize_bilinear_matches_jax(src, dst):
    """Shrinking antialiases (MockUNet's encode), growing does not (the
    c2f stage's 64 -> 512), the same size is the identity."""
    x = np.random.default_rng(src + dst).uniform(
        0, 1, (2, src, src, 3)).astype(np.float32)
    got = diffusion.resize_bilinear(t(x), dst).numpy()
    want = np.asarray(jax.image.resize(jnp.asarray(x), (2, dst, dst, 3),
                                       "bilinear"))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    if src == dst:
        np.testing.assert_array_equal(got, x)


def test_mock_unet_matches_jax(jax_mock):
    bb = diffusion.mock_unet_from_jax_params(_np_tree(jax_mock.params),
                                             latent_size=8, device="cpu")
    assert (bb.latent_size, bb.latent_channels, bb.image_size) == (8, 4, 64)
    rng = np.random.default_rng(3)
    lat = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
    text = rng.standard_normal((2, 77, 1024)).astype(np.float32)
    tt = np.array([20, 900], np.int32)
    np.testing.assert_allclose(
        bb.predict_noise(t(lat), t(tt), t(text)).numpy(),
        np.asarray(jax_mock.predict_noise(jax_mock.params, jnp.asarray(lat),
                                          jnp.asarray(tt),
                                          jnp.asarray(text))),
        rtol=1e-5, atol=1e-5)
    img = rng.uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    np.testing.assert_allclose(
        bb.encode_images(t(img)).numpy(),
        np.asarray(jax_mock.encode_images(jax_mock.params, jnp.asarray(img))),
        rtol=1e-5, atol=1e-5)


SDS_CASES = [
    ("mock", False, False, {}),
    ("mock", True, False, {}),
    ("mock", False, True, {}),
    ("mock", False, False, dict(weighting_strategy="fantasia3d",
                                grad_clip=0.05, guidance_scale=7.5)),
    ("tiny", False, False, {}),
    ("tiny", True, False, {}),
    ("tiny", False, True, dict(weighting_strategy="uniform")),
]


@pytest.mark.parametrize("backbone,perp_neg,rgb_as_latents,extra",
                         SDS_CASES)
def test_sds_loss_and_rgb_grad_match_jax(jax_mock, jax_tiny, backbone,
                                         perp_neg, rgb_as_latents, extra):
    bb_j = jax_mock if backbone == "mock" else jax_tiny
    if backbone == "mock":
        bb_t = diffusion.mock_unet_from_jax_params(
            _np_tree(bb_j.params), latent_size=8, device="cpu")
    else:
        bb_t = backbone_from_jax_params(_np_tree(bb_j.params), TINY,
                                        latent_size=8, device="cpu")
    kw = dict(use_perp_negative=perp_neg, rgb_as_latents=rgb_as_latents,
              **extra)
    g_j = SDSGuidanceJ(SDSConfigJ(**kw), bb_j)
    g_t = SDSGuidance(SDSConfig(**kw), bb_t, device="cpu")
    emb_j = proc_j.PromptProcessor(
        proc_j.PromptProcessorConfig(use_cache=False))()
    emb_t = processors.PromptProcessor(
        processors.PromptProcessorConfig(use_cache=False), device="cpu")()

    B, R = 2, 24
    rng = np.random.default_rng(5)
    rgb = rng.uniform(0, 1, (B, R, R, 3)).astype(np.float32)
    ele = np.array([10.0, 75.0], np.float32)
    azi = np.array([30.0, -150.0], np.float32)
    dist = np.full(B, 2.5, np.float32)
    sched = g_t.sched_scalars(100, 15000)
    assert sched == g_j.sched_scalars(100, 15000)
    key = jax.random.PRNGKey(7)

    def loss_j(x):
        return g_j.loss(g_j.params, x, emb_j, jnp.asarray(ele),
                        jnp.asarray(azi), jnp.asarray(dist), key,
                        sched)["loss_sds"]

    val_j, grad_j = jax.value_and_grad(loss_j)(jnp.asarray(rgb))
    # the JAX loss's own draws, handed to the port
    k_t, k_noise = jax.random.split(key)
    tt = jax.random.randint(k_t, (B,), sched["min_t"], sched["max_t"] + 1)
    lat_shape = (B, bb_t.latent_size, bb_t.latent_size, bb_t.latent_channels)
    noise = jax.random.normal(k_noise, lat_shape)

    x = t(rgb).requires_grad_(True)
    out = g_t.loss(x, emb_t, t(ele), t(azi), t(dist), sched=sched,
                   t=t(tt).long(), noise=t(noise))
    out["loss_sds"].backward()
    np.testing.assert_allclose(float(out["loss_sds"].detach()), float(val_j),
                               rtol=1e-4)
    gj = np.asarray(grad_j)
    assert np.abs(gj).max() > 0
    np.testing.assert_allclose(x.grad.numpy(), gj, rtol=0,
                               atol=1e-4 * np.abs(gj).max())
