"""The port's CLIP towers, Make-It-3D and the image-grid Point-E against
the JAX package on the CPU.

The CLIP text tower (``TINY_TEXT``, gelu and quick_gelu, with and
without the projection) and the vision tower (``TINY_VISION``:
``encode``, ``encode_grid``), both packages filled from one random state
dict built from the port's own modules; ``utils/resize.py`` against
``jax.image.resize``; ``MockImageEncoder`` and ``MakeIt3DGuidance`` with
the JAX parameters brought across (the loss's draws injected); the grid
Point-E transformer on ``TINY_POINT_E_GRID`` and the grid-conditioned
upsampler; both stages of the image sampler at CFG 3; and
``point_e_image_init_arrays`` from a cached asset, then the whole image
init from ``.pt`` checkpoints at a tiny size.

Tolerances: rtol 2e-4 / atol 2e-5 of the largest value (the JAX-vs-
oracle tests'); the samplers 2e-4 of the largest value: the port's
text-pipeline sampler test holds 1e-4 over 8 Karras-Heun steps with an
unguided upsampler, and CFG 3 on both stages here multiplies each
evaluation's rounding by up to 1 + 2·3 (1.04e-4 seen on the upsampler).
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gsgen_tpu.priors as priors_j
from gsgen_tpu.guidance import diffusion as diff_j
from gsgen_tpu.guidance import make_it_3d as m3d_j
from gsgen_tpu.guidance import point_e as pe_j
from gsgen_tpu.priors import point_e_sampler as samp_j
from gsgen_tpu.prompt import clip as clip_j
from gsgen_tpu.prompt import clip_vision as cv_j
from gsgen_tpu.prompt import processors as proc_j
from gsgen_torch import priors
from gsgen_torch.guidance import convert, diffusion
from gsgen_torch.guidance import make_it_3d as m3d
from gsgen_torch.guidance import point_e as pe
from gsgen_torch.io.logging import write_png
from gsgen_torch.priors import point_e_sampler as samp
from gsgen_torch.prompt import clip
from gsgen_torch.prompt import clip_vision as cv
from gsgen_torch.prompt import processors
from gsgen_torch.utils.resize import resize
from torch_fixtures import t


def _close(got, want, share=2e-5, what=""):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=2e-4 if share == 2e-5 else 0,
                               atol=share * max(np.abs(want).max(), 1e-6),
                               err_msg=what)


def random_state(module, seed):
    """A state dict of ``module``'s names (no ``position_ids``): weights ~
    N(0, 1/fan_in), embeddings N(0, 0.5²), norm scales 1 + N(0, 0.1²),
    biases N(0, 0.1²)."""
    g = torch.Generator().manual_seed(seed)
    sd = {}
    for k, v in module.state_dict().items():
        n = torch.randn(v.shape, generator=g)
        if "embedding" in k:
            sd[k] = 0.5 * n
        elif v.dim() >= 2:
            sd[k] = n / math.sqrt(v[0].numel())
        elif "norm" in k and k.endswith("weight"):
            sd[k] = 1.0 + 0.1 * n
        else:
            sd[k] = 0.1 * n
    return sd


def _np(sd):
    return {k: v.numpy() for k, v in sd.items()}


# ---- CLIP ----

@pytest.mark.parametrize("act", ["gelu", "quick_gelu"])
def test_clip_text_matches_jax(tmp_path, act):
    cfg = dataclasses.replace(clip.TINY_TEXT, hidden_act=act)
    cfg_j = dataclasses.replace(clip_j.TINY_TEXT, hidden_act=act)
    sd = random_state(clip.CLIPTextModelWithProjection(cfg, 16), 1)
    ids = np.random.default_rng(0).integers(0, 128, (3, 16))
    # the projected text vector, read from a .pt file
    torch.save(sd, tmp_path / "textvec.pt")
    m_t = clip.load_clip_textvec(tmp_path / "textvec.pt", cfg, 16,
                                 device="cpu")
    m_j, p_j = clip_j.load_clip_textvec(_np(sd), cfg_j, 16)
    _close(m_t(t(ids)).numpy(), m_j.apply(p_j, jnp.asarray(ids)))
    # the hidden states of the plain text model (a position_ids buffer
    # in the state dict is dropped, as transformers writes one)
    sd2 = {k: v for k, v in sd.items() if k != "text_projection.weight"}
    sd2["text_model.embeddings.position_ids"] = torch.arange(16)[None]
    m_t = clip.load_clip_text(sd2, cfg, device="cpu")
    m_j, p_j = clip_j.load_clip_text(_np(sd2), cfg_j)
    _close(m_t(t(ids)).numpy(), m_j.apply(p_j, jnp.asarray(ids)))


@pytest.fixture(scope="module")
def vision_pair():
    sd = random_state(cv.CLIPVisionModelWithProjection(cv.TINY_VISION, 16),
                      2)
    enc_t = cv.CLIPImageEncoder.from_state_dict(sd, cv.TINY_VISION, 16,
                                                device="cpu")
    m_j, p_j = cv_j.load_clip_vision(_np(sd), cv_j.TINY_VISION, 16)
    return enc_t, cv_j.CLIPImageEncoder(m_j, p_j), sd


@pytest.mark.parametrize("size", [32, 50])
def test_clip_vision_matches_jax(vision_pair, size):
    """The tower on normalized pixels, ``encode`` (bilinear to 32²,
    unit embeddings) and ``encode_grid`` (cubic, the patch tokens before
    post_layernorm) at the tower's size and from 50²."""
    enc_t, enc_j, _ = vision_pair
    rng = np.random.default_rng(size)
    img = rng.uniform(0, 1, (2, size, size, 3)).astype(np.float32)
    if size == 32:
        px = rng.standard_normal((2, 32, 32, 3)).astype(np.float32)
        _close(enc_t.module(t(px)).numpy(),
               enc_j.module.apply(enc_j.params, jnp.asarray(px)))
    e_t = enc_t.encode(t(img)).numpy()
    _close(e_t, enc_j.encode(enc_j.params, jnp.asarray(img)), what="encode")
    np.testing.assert_allclose(np.linalg.norm(e_t, axis=-1), 1.0, rtol=1e-5)
    g_t = enc_t.encode_grid(t(img)).numpy()
    assert g_t.shape == (2, 16, 32)
    _close(g_t, enc_j.encode_grid(enc_j.params, jnp.asarray(img)),
           what="encode_grid")


@pytest.mark.parametrize("src,dst,method", [
    ((2, 40, 40, 3), (2, 24, 24, 3), "bilinear"),
    ((2, 24, 30, 3), (2, 50, 17, 3), "bilinear"),
    ((2, 378, 378, 3), (2, 224, 224, 3), "cubic"),
    ((2, 24, 30, 3), (2, 50, 17, 3), "cubic"),
    ((2, 9, 9, 3), (2, 30, 30, 3), "cubic"),
    ((45, 45), (32, 32), "bilinear")])
def test_resize_matches_jax_image_resize(src, dst, method):
    x = np.random.default_rng(0).uniform(0, 1, src).astype(np.float32)
    # a 2-D map resizes as [1, H, W, 1]
    x4 = t(x) if x.ndim == 4 else t(x)[None, ..., None]
    hw = dst[1:3] if x.ndim == 4 else dst
    _close(resize(x4, hw, method).reshape(dst).numpy(),
           jax.image.resize(jnp.asarray(x), dst, method))


# ---- Make-It-3D ----

def _img(seed, n=2, size=32):
    return np.random.default_rng(seed).uniform(0, 1, (n, size, size, 3)
                                               ).astype(np.float32)


def test_mock_image_encoder_matches_jax():
    enc_j = m3d_j.MockImageEncoder()
    enc_t = m3d.MockImageEncoder(device="cpu", params=enc_j.params)
    img = _img(1, 3, 40)
    _close(enc_t.encode(t(img)).numpy(),
           enc_j.encode(enc_j.params, jnp.asarray(img)))


@pytest.mark.parametrize("encoder,text", [("mock", False), ("mock", True),
                                          ("clip", False)])
def test_make_it_3d_loss_matches_jax(vision_pair, encoder, text):
    """SDS on the JAX MockUNet's weights plus the CLIP reference loss on
    the novel views (views 0 and 2 of 3), its value and rgb gradient."""
    bb_j = diff_j.MockUNet(latent_size=8)
    bb_t = diffusion.mock_unet_from_jax_params(
        jax.tree_util.tree_map(np.asarray, bb_j.params), latent_size=8,
        device="cpu")
    if encoder == "mock":
        enc_j = m3d_j.MockImageEncoder()
        enc_t = m3d.MockImageEncoder(device="cpu", params=enc_j.params)
        dim = 128
    else:
        enc_t, enc_j, _ = vision_pair
        dim = 16
    rng = np.random.default_rng(3)
    ref = _img(4, 1)[0]
    txt = rng.standard_normal(dim).astype(np.float32)
    txt /= np.linalg.norm(txt)
    kw = dict(guidance_scale=7.5, backbone_latent_size=8, clip_weight=0.5)
    g_j = m3d_j.MakeIt3DGuidance(m3d_j.MakeIt3DConfig(**kw), bb_j,
                                 image_encoder=enc_j,
                                 ref_image=jnp.asarray(ref),
                                 ref_text_embed=(jnp.asarray(txt) if text
                                                 else None))
    g_t = m3d.MakeIt3DGuidance(m3d.MakeIt3DConfig(**kw), bb_t,
                               image_encoder=enc_t, ref_image=t(ref),
                               ref_text_embed=t(txt) if text else None,
                               device="cpu")
    emb_j = proc_j.PromptProcessor(
        proc_j.PromptProcessorConfig(use_cache=False))()
    emb_t = processors.PromptProcessor(
        processors.PromptProcessorConfig(use_cache=False), device="cpu")()
    rgb = _img(5, 3)
    is_orig = np.array([0.0, 1.0, 0.0], np.float32)
    cams = [np.array(v, np.float32) for v in
            ([10.0, 0.0, 40.0], [30.0, 0.0, -90.0], [2.5, 2.5, 2.5])]
    sched = g_t.sched_scalars(100, 15000)
    key = jax.random.PRNGKey(7)

    def loss_j(x):
        out = g_j.loss(g_j.params, x, emb_j, *map(jnp.asarray, cams), key,
                       sched, batch_is_original=jnp.asarray(is_orig))
        return out["loss_sds"] + out["loss_clip"], out

    (_, out_j), grad_j = jax.jit(jax.value_and_grad(loss_j, has_aux=True))(
        jnp.asarray(rgb))
    k_t, k_noise = jax.random.split(key)
    tt = jax.random.randint(k_t, (3,), sched["min_t"], sched["max_t"] + 1)
    noise = jax.random.normal(k_noise, (3, 8, 8, 4))
    x = t(rgb).requires_grad_(True)
    out = g_t.loss(x, emb_t, *map(t, cams), sched=sched, t=t(tt).long(),
                   noise=t(noise), batch_is_original=t(is_orig))
    (out["loss_sds"] + out["loss_clip"]).backward()
    for k in ("loss_sds", "loss_clip"):
        np.testing.assert_allclose(float(out[k].detach()), float(out_j[k]),
                                   rtol=2e-4, err_msg=k)
    assert float(out["loss_clip"]) > 0
    _close(x.grad.numpy(), grad_j, 1e-4, "rgb grad")
    if not text:
        # the reference itself as a novel view: no CLIP distance
        same = g_t.clip_ref_loss(t(ref)[None], torch.zeros(1))
        assert abs(float(same)) < 1e-5
    # without is_original the loss is SDS alone, as in the JAX package
    assert "loss_clip" not in g_t.loss(
        t(rgb), emb_t, *map(t, cams), sched=sched, t=t(tt).long(),
        noise=t(noise))


# ---- the image-grid Point-E ----

def _fill_output_proj(params, seed, std=0.05):
    params = jax.tree_util.tree_map(np.asarray, params)
    rng = np.random.default_rng(seed)
    proj = params["params"]["output_proj"]
    for k in proj:
        proj[k] = (rng.standard_normal(proj[k].shape) * std).astype(
            np.float32)
    return params


# the TINY grid models at TINY_VISION's grid: 16 tokens, 32 wide
GRID = dataclasses.replace(pe.TINY_POINT_E_GRID, clip_feature_dim=32)
GRID_J = dataclasses.replace(pe_j.TINY_POINT_E_GRID, clip_feature_dim=32)
UP = dataclasses.replace(pe.TINY_UPSAMPLE, grid_feature_dim=32, grid_size=4)
UP_J = dataclasses.replace(pe_j.TINY_UPSAMPLE, grid_feature_dim=32,
                           grid_size=4)


@pytest.fixture(scope="module")
def grid_pair():
    m_j = pe_j.PointEImageGridModel(GRID_J, key=jax.random.PRNGKey(1),
                                    grid_tokens=16)
    m_j.params = _fill_output_proj(m_j.params, 2)
    m_t = pe.PointEImageGridModel(GRID, device="cpu", grid_tokens=16
                                  ).load_weights(
        convert.flax_to_torch_state(m_j.params))
    u_j = pe_j.PointEUpsamplerModel(UP_J, key=jax.random.PRNGKey(3))
    u_j.params = _fill_output_proj(u_j.params, 4)
    u_t = pe.PointEUpsamplerModel(UP, device="cpu").load_weights(
        convert.flax_to_torch_state(u_j.params))
    return (m_j, m_t), (u_j, u_t)


def test_grid_point_e_forward_matches_jax(grid_pair):
    (m_j, m_t), (u_j, u_t) = grid_pair
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 6, 32)).astype(np.float32)
    tt = np.array([3.0, 700.0], np.float32)
    grid = rng.standard_normal((2, 16, 32)).astype(np.float32)
    apply_j = jax.jit(m_j.apply)
    for cond in (grid, None):
        want = apply_j(m_j.params, jnp.asarray(x), jnp.asarray(tt),
                       None if cond is None else jnp.asarray(cond))
        got = m_t.apply(t(x), t(tt), None if cond is None else t(cond))
        assert got.shape == (2, 12, 32)
        _close(got.numpy(), want, what=f"grid {cond is None}")
    xu = rng.standard_normal((2, 6, 64)).astype(np.float32)
    low = rng.uniform(-0.5, 255, (2, 6, 32)).astype(np.float32)
    emb = np.swapaxes(grid, 1, 2)
    want = u_j.apply(u_j.params, jnp.asarray(xu), jnp.asarray(tt),
                     low_res=jnp.asarray(low), embeddings=jnp.asarray(emb))
    _close(u_t.apply(t(xu), t(tt), t(low), t(emb)).numpy(), want,
           what="upsampler with grid")


def _jax_churn_noises(key, steps, shape):
    """The JAX stage sampler's per-step draws: one split a Heun step, one
    for the epilogue."""
    out = []
    for _ in range(steps):
        key, k = jax.random.split(key)
        out.append(torch.from_numpy(np.array(jax.random.normal(k, shape))))
    return out


@pytest.mark.parametrize("stage", ["base", "upsample"])
def test_image_stage_samplers_match_jax(grid_pair, stage):
    """8 Karras-Heun steps of each image stage at CFG 3 on a CLIP grid
    (the unconditional rows zeros): the base with churn 3, the upsampler
    with the grid channels first, as the sampler hands it over."""
    (m_j, m_t), (u_j, u_t) = grid_pair
    steps, key = 8, jax.random.PRNGKey(13)
    rng = np.random.default_rng(10)
    grid = rng.standard_normal((1, 16, 32)).astype(np.float32)
    cond = np.concatenate([grid, np.zeros_like(grid)])
    cfg_j = samp_j.PointESamplerConfig(karras_steps=(steps, steps),
                                       up_guidance_scale=3.0, up_cond=True)
    cfg_t = samp.PointESamplerConfig(karras_steps=(steps, steps),
                                     up_guidance_scale=3.0, up_cond=True)
    s_j, s_t = (samp_j.PointESampler(m_j, u_j, cfg_j),
                samp.PointESampler(m_t, u_t, cfg_t))
    if stage == "base":
        fj, ft, smax, low = s_j._sample_base, s_t._sample_base, \
            s_t._smax0, None
        params, shape = m_j.params, (1, 6, 32)
    else:
        fj, ft, smax = s_j._sample_up, s_t._sample_up, s_t._smax1
        params, shape = u_j.params, (1, 6, 64)
        low = rng.uniform(-0.5, 255, (1, 6, 32)).astype(np.float32)
    x_T = (rng.standard_normal(shape) * smax).astype(np.float32)
    want = fj(params, jnp.asarray(x_T), jnp.asarray(cond),
              None if low is None else jnp.asarray(low), key)
    got = ft(t(x_T), t(cond), None if low is None else t(low),
             noises=_jax_churn_noises(key, steps, shape))
    _close(got.numpy(), want, 2e-4, stage)


@pytest.fixture
def asset_dir(tmp_path, monkeypatch):
    d = tmp_path / "assets"
    monkeypatch.setenv("GSGEN_ASSET_DIR", str(d))
    monkeypatch.setattr(priors_j, "ASSET_DIR", str(d))
    for k in ("GSGEN_POINT_E_IMAGE_BASE", "GSGEN_POINT_E_UPSAMPLE",
              "GSGEN_CLIP_VISION_DIR", "GSGEN_CLIP_DIR"):
        monkeypatch.delenv(k, raising=False)
    return d


@pytest.mark.parametrize("num_points,facex,as_path",
                         [(5000, False, True), (3000, True, True),
                          (4096, True, False)])
def test_point_e_image_init_arrays_from_asset(asset_dir, tmp_path,
                                              num_points, facex, as_path):
    """The cache named as the JAX package names it (a path by its resolved
    name, an array by its content), padded by resampling, scaled (no
    centring), turned by facex: equal arrays in both packages."""
    img = np.random.default_rng(7).uniform(0, 1, (20, 20, 3)).astype(
        np.float32)
    write_png(tmp_path / "in.png", img)
    image = str(tmp_path / "in.png") if as_path else img
    p = priors._asset_path(priors._image_key(image), "point_e_image")
    key_j = (f"file:{(tmp_path / 'in.png').resolve()}" if as_path else
             "arr:" + __import__("hashlib").md5(img.tobytes()).hexdigest())
    assert p == priors_j._asset_path("point_e_image", key_j)
    rng = np.random.default_rng(8)
    p.parent.mkdir(parents=True, exist_ok=True)
    np.savez(p, xyz=(rng.standard_normal((4096, 3)) * 0.4 + 0.2).astype(
        np.float32), rgb=rng.uniform(0, 1, (4096, 3)).astype(np.float32))
    kw = dict(num_points=num_points, mean_std=0.7, facex=facex, seed=3)
    x_t, c_t = priors.point_e_image_init_arrays(image, device="cpu", **kw)
    x_j, c_j = priors_j.point_e_image_init_arrays(image, **kw)
    np.testing.assert_array_equal(x_t, x_j)
    np.testing.assert_array_equal(c_t, c_j)
    assert x_t.shape == (max(num_points, 4096) if num_points > 4096
                         else num_points, 3)


def test_point_e_image_generate_tiny_then_cache(asset_dir, tmp_path):
    """The whole image init from .pt checkpoints on TINY models (3 + 3
    steps) through build_trainer's init.type=point_e_image; the cloud is
    cached and a second call reads it."""
    from gsgen_torch.config import build_trainer, load_config
    sd = random_state(cv.CLIPVisionModelWithProjection(cv.TINY_VISION,
                                                       768), 2)
    paths = {"clip": tmp_path / "clip.pt", "base": tmp_path / "base.pt",
             "up": tmp_path / "up.pt"}
    torch.save(sd, paths["clip"])
    torch.save(pe.PointEImageGridModel(GRID, "cpu", grid_tokens=16
                                       ).module.state_dict(), paths["base"])
    torch.save(pe.PointEUpsamplerModel(UP, "cpu").module.state_dict(),
               paths["up"])
    write_png(tmp_path / "in.png", _img(9, 1, 40)[0])
    kw = dict(base_weights=str(paths["base"]),
              upsample_weights=str(paths["up"]),
              clip_model_dir=str(paths["clip"]), base_cfg=GRID, up_cfg=UP,
              clip_cfg=dataclasses.replace(cv.TINY_VISION),
              karras_steps=(3, 3), device="cpu")
    with pytest.raises(FileNotFoundError):
        priors.point_e_image_generate(str(tmp_path / "in.png"))
    xyz, rgb = priors.point_e_image_generate(str(tmp_path / "in.png"), **kw)
    assert xyz.shape == (32 + 64, 3) and rgb.shape == xyz.shape
    assert np.isfinite(xyz).all() and (rgb >= 0).all() and (rgb <= 1).all()
    again = priors.point_e_image_generate(str(tmp_path / "in.png"),
                                          base_weights="/nowhere")
    np.testing.assert_array_equal(again[0], xyz)
    root = __import__("pathlib").Path(__file__).resolve().parents[1]
    tr = build_trainer(load_config(root / "configs" / "base.yaml", [
        "init.type=point_e_image", f"init.image={tmp_path / 'in.png'}",
        "init.num_points=64", "init.capacity=128", "data.reso=[32]",
        "guidance.type=mock", "prompt.use_cache=false"]), device="cpu")
    assert int(tr.state.scene.active.sum()) == 64
