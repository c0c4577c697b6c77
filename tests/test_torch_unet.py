"""gsgen_torch's SD UNet, VAE and attention vs the JAX package's flax
modules, with the flax parameters carried across through the port's
``convert.py``.

The JAX modules run their einsum attention (``set_fused_attention
("off")``).  Tolerances (fp32 on the CPU, convolution and matmul
summation order): attention rtol 1e-5 / atol 1e-5; UNet eps and VAE
outputs within 1e-4 of the output's largest value.  The port's bf16
path against its fp32 path within a relative L2 error of 0.05, the gate
of the JAX package's tests/test_sd_unet.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsgen_tpu.guidance import unet2d as unet_j
from gsgen_tpu.guidance import vae as vae_j
from gsgen_tpu.guidance.sd_unet import SDUNetBackbone as BackboneJ
from gsgen_torch.guidance import unet2d, vae
from gsgen_torch.guidance.convert import (flat_paths, flax_path_to_torch_key,
                                          flax_to_torch_state, to_torch_leaf)
from gsgen_torch.guidance.sd_unet import (SDUNetBackbone,
                                          backbone_from_jax_params,
                                          load_diffusers_weights)
from gsgen_torch.ops import flash_attention as fa
from torch_fixtures import t

SD15_SMALL = dict(block_out_channels=(32, 64), layers_per_block=1,
                  cross_attention_dim=768, attention_head_dim=(2, 2),
                  cross_attn_levels=(True, True),
                  use_linear_projection=False)


@pytest.fixture(scope="module", autouse=True)
def _einsum_attention():
    unet_j.set_fused_attention("off")
    yield
    unet_j.set_fused_attention("auto")


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _load(module, params):
    module.load_state_dict({k: torch.tensor(v) for k, v in
                            flax_to_torch_state(_np_tree(params)).items()},
                           strict=True)
    return module


def _close(got, want, frac=1e-4):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=frac * np.abs(want).max())


@pytest.fixture(scope="module")
def tiny_j():
    return BackboneJ(unet_j.TINY, latent_size=8)


def test_attention_matches_jax():
    """Self-attention (L=256, the fused-eligible shape) in every mode, and
    cross-attention with S=77 (never fused)."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 256, 128)).astype(np.float32)
    ctx = rng.standard_normal((2, 77, 96)).astype(np.float32)
    self_j = unet_j.Attention(heads=2, head_dim=64, out_dim=128)
    p_self = self_j.init(jax.random.PRNGKey(0), jnp.asarray(x))
    cross_j = unet_j.Attention(heads=2, head_dim=64, out_dim=128)
    p_cross = cross_j.init(jax.random.PRNGKey(1), jnp.asarray(x),
                           jnp.asarray(ctx))
    self_t = _load(unet2d.Attention(128, 2, 64, 128), p_self)
    cross_t = _load(unet2d.Attention(128, 2, 64, 128, cross_dim=96), p_cross)
    want = np.asarray(self_j.apply(p_self, jnp.asarray(x)))
    launches = fa.flash_self_attention.launches
    with torch.no_grad():
        for mode in ("off", "auto", "on"):
            unet2d.set_fused_attention(self_t, mode)
            np.testing.assert_allclose(self_t(t(x)).numpy(), want,
                                       rtol=1e-5, atol=1e-5, err_msg=mode)
        unet2d.set_fused_attention(cross_t, "on")
        np.testing.assert_allclose(
            cross_t(t(x), t(ctx)).numpy(),
            np.asarray(cross_j.apply(p_cross, jnp.asarray(x),
                                     jnp.asarray(ctx))),
            rtol=1e-5, atol=1e-5)
    # CPU tensors take the plain version: no kernel launch
    assert fa.flash_self_attention.launches == launches
    with pytest.raises(ValueError):
        unet2d.set_fused_attention(self_t, "fast")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_plain_matches_softmax_reference(dtype):
    rng = np.random.default_rng(1)
    q, k, v = (rng.standard_normal((2, 128, 3, 40)).astype(np.float32)
               for _ in range(3))
    dt = getattr(torch, dtype)
    tq, tk, tv = (t(a).to(dt) for a in (q, k, v))
    out = fa.flash_self_attention(tq, tk, tv, 0.3)
    assert out.dtype == dt and out.shape == tq.shape
    q64, k64, v64 = (x.double().numpy() for x in (tq, tk, tv))
    s = np.einsum("blhd,bshd->bhls", q64, k64) * 0.3
    p = np.exp(s - s.max(-1, keepdims=True))
    ref = np.einsum("bhls,bshd->blhd", p / p.sum(-1, keepdims=True), v64)
    tol = 1e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(out.double().numpy(), ref, rtol=0,
                               atol=tol * np.abs(ref).max())
    assert fa.supported(tq) and not fa.supported(tq[:, :100])


@pytest.mark.parametrize("preset", ["tiny", "sd15_small"])
def test_unet_eps_matches_jax(preset, tiny_j):
    """TINY (linear projections, SD 2.x style) and an SD 1.5-style small
    config (1x1-conv projections, 768-wide context)."""
    rng = np.random.default_rng(2)
    if preset == "tiny":
        cfg_j, cfg_t = unet_j.TINY, unet2d.TINY
        model_j, params = tiny_j.unet, tiny_j.params["unet"]
    else:
        cfg_j = unet_j.UNetConfig(**SD15_SMALL)
        cfg_t = unet2d.UNetConfig(**SD15_SMALL)
        model_j = unet_j.UNet2DConditionModel(cfg_j)
        params = jax.jit(model_j.init)(
            jax.random.PRNGKey(3), jnp.zeros((1, 8, 8, 4)), jnp.zeros((1,)),
            jnp.zeros((1, 4, 768)))
    x = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
    tt = np.array([10, 700], np.int32)
    ctx = rng.standard_normal((2, 7, cfg_j.cross_attention_dim)).astype(
        np.float32)
    want = model_j.apply(params, jnp.asarray(x), jnp.asarray(tt),
                         jnp.asarray(ctx))
    model_t = _load(unet2d.UNet2DConditionModel(cfg_t), params)
    with torch.no_grad():
        got = model_t(t(x), t(tt), t(ctx))
    assert got.shape == (2, 8, 8, 4)
    _close(got.numpy(), want)


def test_vae_encode_decode_match_jax(tiny_j):
    rng = np.random.default_rng(4)
    img = rng.uniform(-1, 1, (2, 16, 16, 3)).astype(np.float32)
    z = rng.standard_normal((2, 8, 8, 4)).astype(np.float32) * 0.2
    m_j = vae_j.AutoencoderKL(vae_j.TINY_VAE)
    p = tiny_j.params["vae"]
    m_t = _load(vae.AutoencoderKL(vae.TINY_VAE), p)
    with torch.no_grad():
        mean_t, logvar_t = m_t.moments(t(img))
        enc_t = m_t.encode(t(img))
        dec_t = m_t.decode(t(z))
    mean_j, logvar_j = m_j.apply(p, jnp.asarray(img),
                                 method=vae_j.AutoencoderKL.moments)
    _close(mean_t.numpy(), mean_j)
    _close(logvar_t.numpy(), logvar_j)
    _close(enc_t.numpy(), m_j.apply(p, jnp.asarray(img),
                                    method=vae_j.AutoencoderKL.encode))
    _close(dec_t.numpy(), m_j.apply(p, jnp.asarray(z),
                                    method=vae_j.AutoencoderKL.decode))


def test_backbone_from_jax_params_matches_jax(tiny_j):
    bb = backbone_from_jax_params(_np_tree(tiny_j.params), unet2d.TINY,
                                  latent_size=8, device="cpu")
    assert (bb.latent_size, bb.latent_channels, bb.image_size) == (
        tiny_j.latent_size, tiny_j.latent_channels, tiny_j.image_size)
    assert not any(p.requires_grad for p in bb.parameters())
    rng = np.random.default_rng(5)
    img = rng.uniform(0, 1, (1, 16, 16, 3)).astype(np.float32)
    _close(bb.encode_images(t(img)).detach().numpy(),
           tiny_j.encode_images(tiny_j.params, jnp.asarray(img)))
    lat = rng.standard_normal((1, 8, 8, 4)).astype(np.float32) * 0.2
    _close(bb.decode_latents(t(lat)).numpy(),
           tiny_j.decode_latents(tiny_j.params, jnp.asarray(lat)))
    with pytest.raises(NotImplementedError):
        load_diffusers_weights("/nonexistent/sd21")


def test_bf16_compute_dtype_tracks_fp32():
    """Frozen bf16 copies of the same random weights: eps and latents
    in fp32, within 5% relative L2 of the fp32 path; the gradient flows
    through the bf16 VAE encoder."""
    kw = dict(latent_size=8, device="cpu")
    bb32 = SDUNetBackbone(unet2d.TINY, **kw)
    bb16 = SDUNetBackbone(unet2d.TINY, compute_dtype="bfloat16", **kw)
    assert all(p.dtype == torch.bfloat16 for p in bb16.parameters())
    rng = np.random.default_rng(6)
    x = t(rng.standard_normal((2, 8, 8, 4)).astype(np.float32) * 0.5)
    tt = torch.tensor([100, 700])
    ctx = t(rng.standard_normal((2, 7, 1024)).astype(np.float32) * 0.1)

    def rel(a, b):
        return float(torch.linalg.norm(a - b) / torch.linalg.norm(b))

    with torch.no_grad():
        e32, e16 = bb32.predict_noise(x, tt, ctx), bb16.predict_noise(x, tt,
                                                                      ctx)
    assert e16.dtype == torch.float32 and rel(e16, e32) < 0.05
    img = t(rng.uniform(0, 1, (1, 16, 16, 3)).astype(np.float32))
    img.requires_grad_(True)
    z16 = bb16.encode_images(img)
    with torch.no_grad():
        z32 = bb32.encode_images(img)
    assert z16.dtype == torch.float32 and rel(z16.detach(), z32) < 0.05
    (z16 ** 2).sum().backward()
    assert torch.isfinite(img.grad).all() and img.grad.abs().max() > 0


@pytest.mark.parametrize("which", ["unet", "vae"])
def test_full_width_weight_mapping(which):
    """SD 2.1's UNet and the SD VAE at full width, shapes only: every
    flax leaf maps to a port parameter of the same shape, and every port
    parameter is covered."""
    key = jax.random.PRNGKey(0)
    if which == "unet":
        model = unet_j.UNet2DConditionModel(unet_j.SD21)
        shapes = jax.eval_shape(model.init, key, jnp.zeros((1, 8, 8, 4)),
                                jnp.zeros((1,)), jnp.zeros((1, 4, 1024)))
    else:
        model = vae_j.AutoencoderKL(vae_j.SD_VAE)
        shapes = jax.eval_shape(model.init, key, jnp.zeros((1, 32, 32, 3)))
    bb = SDUNetBackbone(unet2d.SD21, device="meta")
    port = {k: tuple(v.shape)
            for k, v in getattr(bb, which).state_dict().items()}
    # zero-stride stand-ins: no memory for 866M parameters
    zeros = jax.tree_util.tree_map(
        lambda s: np.broadcast_to(np.float32(0), s.shape), shapes)
    mapped = {}
    for path, leaf in flat_paths(zeros["params"]).items():
        key_t, kind = flax_path_to_torch_key(path)
        mapped[key_t] = tuple(to_torch_leaf(kind, leaf).shape)
    assert mapped == port
    n = sum(int(np.prod(s)) for s in port.values())
    assert n == (865_910_724 if which == "unet" else 83_653_863)
