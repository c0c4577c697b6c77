"""gsgen_torch's SD UNet, VAE and attention vs the JAX package's flax
modules, with the flax parameters carried across through the port's
``convert.py``.

The JAX modules run their einsum attention (``set_fused_attention
("off")``).  Tolerances (fp32 on the CPU, convolution and matmul
summation order): attention rtol 1e-5 / atol 1e-5; UNet eps and VAE
outputs within 1e-4 of the output's largest value; the plain flash
backward and the LoRA gradients within 1e-5 of each gradient's largest
value (2e-4 through a whole UNet).  The port's bf16
path against its fp32 path within a relative L2 error of 0.05, the gate
of the JAX package's tests/test_sd_unet.py.
"""

import dataclasses

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


@pytest.mark.parametrize("D", [40, 64])
def test_flash_backward_plain_matches_jax_vjp(D):
    """flash_self_attention_bwd_plain (from the lse of
    flash_self_attention_plain_lse) against jax.vjp of the JAX einsum
    core (unet2d.py:199-203) and against torch autograd of the plain
    forward; the autograd Function (K5-K7's plain versions on the CPU)
    gives the same gradients."""
    rng = np.random.default_rng(D)
    q, k, v, dout = (rng.standard_normal((2, 128, 3, D)).astype(np.float32)
                     for _ in range(4))
    scale = 1.0 / np.sqrt(D)

    def core(q_, k_, v_):
        attn = jnp.einsum("blhd,bshd->bhls", q_, k_,
                          preferred_element_type=jnp.float32) * scale
        attn = jax.nn.softmax(attn.astype(jnp.float32), axis=-1)
        return jnp.einsum("bhls,bshd->blhd", attn.astype(v_.dtype), v_)

    out_j, vjp = jax.vjp(core, *(jnp.asarray(x) for x in (q, k, v)))
    want = vjp(jnp.asarray(dout))
    tq, tk, tv, tdo = (t(x) for x in (q, k, v, dout))
    out, lse = fa.flash_self_attention_plain_lse(tq, tk, tv, scale)
    np.testing.assert_allclose(out.numpy(), np.asarray(out_j), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(
        lse.numpy(), np.asarray(jax.nn.logsumexp(jnp.einsum(
            "blhd,bshd->bhls", q, k) * scale, axis=-1)), rtol=1e-5)
    got = fa.flash_self_attention_bwd_plain(tq, tk, tv, out, lse, tdo, scale)
    ps = [x.clone().requires_grad_(True) for x in (tq, tk, tv)]
    auto = torch.autograd.grad(fa.flash_self_attention_plain(*ps, scale), ps,
                               tdo)
    ps = [x.clone().requires_grad_(True) for x in (tq, tk, tv)]
    func_out = fa.flash_self_attention(*ps, scale)
    assert func_out.grad_fn is not None
    func = torch.autograd.grad(func_out, ps, tdo)
    for name, a, b, c, w in zip("qkv", got, auto, func, want):
        for x in (a, b, c):
            _close(x.numpy(), w, 1e-5)


def _lora_params(params, seed):
    """JAX params with the LoRA up-projections made non-zero."""
    rng = np.random.default_rng(seed)

    def bump(path, x):
        name = "/".join(str(getattr(p, "key", p)) for p in path)
        if name.endswith("up/kernel"):
            return x + 0.05 * rng.standard_normal(x.shape).astype(np.float32)
        return np.asarray(x)
    return jax.tree_util.tree_map_with_path(bump, params)


@pytest.mark.parametrize("lora_scale", [0.0, 1.0])
def test_lora_attention_matches_jax(lora_scale):
    """LoRA self-attention (L = 256, through the autograd Function in "on"
    mode) and cross-attention: outputs and the gradients of every LoRA
    leaf."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 256, 128)).astype(np.float32)
    ctx = rng.standard_normal((2, 77, 96)).astype(np.float32)
    dy = rng.standard_normal((2, 256, 128)).astype(np.float32)
    m_j = unet_j.Attention(heads=2, head_dim=64, out_dim=128, lora_rank=4)
    for cross in (False, True):
        args = (jnp.asarray(x),) + ((jnp.asarray(ctx),) if cross else ())
        p = _lora_params(m_j.init(jax.random.PRNGKey(cross), *args), 8)
        m_t = _load(unet2d.Attention(128, 2, 64, 128,
                                     cross_dim=96 if cross else None,
                                     lora_rank=4), p)
        unet2d.set_fused_attention(m_t, "on")

        def f(params):
            ctx_ = args[1] if cross else None
            y = m_j.apply(params, args[0], ctx_, lora_scale)
            return jnp.sum(y * jnp.asarray(dy)), y

        (_, y_j), g_j = jax.value_and_grad(f, has_aux=True)(p)
        y_t = m_t(t(x), t(ctx) if cross else None, lora_scale)
        _close(y_t.detach().numpy(), y_j, 1e-5)
        lora = {k: v for k, v in m_t.named_parameters() if "lora" in k}
        for v in lora.values():
            v.requires_grad_(True)
        grads = torch.autograd.grad((y_t * t(dy)).sum(), list(lora.values()),
                                    allow_unused=True)
        want = flax_to_torch_state(_np_tree(g_j))
        for (k, _), gr in zip(lora.items(), grads):
            gr = torch.zeros_like(lora[k]) if gr is None else gr
            if lora_scale == 0.0:
                assert float(np.abs(want[k]).max()) == 0.0, k
            _close(gr.numpy(), want[k], 1e-5)


@pytest.mark.parametrize("lora_scale", [0.0, 1.0])
def test_unet_vsd_eps_matches_jax(lora_scale):
    """TINY_VSD (LoRA rank 4, camera class embedding) with class labels:
    eps, and the gradients of the class embedding and LoRA leaves."""
    rng = np.random.default_rng(9)
    model_j = unet_j.UNet2DConditionModel(unet_j.TINY_VSD)
    x = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
    tt = np.array([10, 700], np.int32)
    ctx = rng.standard_normal((2, 7, 1024)).astype(np.float32)
    cam = rng.standard_normal((2, 16)).astype(np.float32)
    params = _lora_params(jax.jit(model_j.init)(
        jax.random.PRNGKey(4), jnp.zeros((1, 8, 8, 4)), jnp.zeros((1,)),
        jnp.zeros((1, 4, 1024)), class_labels=jnp.zeros((1, 16))), 10)

    def f(p):
        eps = model_j.apply(p, jnp.asarray(x), jnp.asarray(tt),
                            jnp.asarray(ctx), class_labels=jnp.asarray(cam),
                            lora_scale=lora_scale)
        return jnp.sum(eps ** 2), eps

    (_, eps_j), g_j = jax.value_and_grad(f, has_aux=True)(params)
    model_t = _load(unet2d.UNet2DConditionModel(unet2d.TINY_VSD), params)
    train = {k: v.requires_grad_(True) for k, v in model_t.named_parameters()
             if "lora" in k or k.startswith("class_embedding")}
    eps = model_t(t(x), t(tt), t(ctx), class_labels=t(cam),
                  lora_scale=lora_scale)
    _close(eps.detach().numpy(), eps_j)
    grads = torch.autograd.grad((eps ** 2).sum(), list(train.values()),
                                allow_unused=True)
    want = flax_to_torch_state(_np_tree(g_j))
    for (k, v), gr in zip(train.items(), grads):
        gr = torch.zeros_like(v) if gr is None else gr
        _close(gr.numpy(), want[k], 2e-4)


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
    with pytest.raises(FileNotFoundError, match="no .safetensors"):
        load_diffusers_weights("/nonexistent/sd21", device="cpu")


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


@pytest.mark.parametrize("which", ["unet", "vae", "unet_vsd"])
def test_full_width_weight_mapping(which):
    """SD 2.1's UNet (plain, and with VSD's LoRA rank 4 and 16-wide camera
    embedding) and the SD VAE at full width, shapes only: every flax leaf
    maps to a port parameter of the same shape, and every port parameter
    is covered."""
    key = jax.random.PRNGKey(0)
    vsd = dict(lora_rank=4, class_embed_proj_dim=16)
    if which.startswith("unet"):
        cfg_j = unet_j.SD21
        cls = None
        if which == "unet_vsd":
            cfg_j = dataclasses.replace(cfg_j, **vsd)
            cls = jnp.zeros((1, 16))
        model = unet_j.UNet2DConditionModel(cfg_j)
        shapes = jax.eval_shape(model.init, key, jnp.zeros((1, 8, 8, 4)),
                                jnp.zeros((1,)), jnp.zeros((1, 4, 1024)),
                                class_labels=cls)
    else:
        model = vae_j.AutoencoderKL(vae_j.SD_VAE)
        shapes = jax.eval_shape(model.init, key, jnp.zeros((1, 32, 32, 3)))
    cfg_t = unet2d.SD21
    if which == "unet_vsd":
        cfg_t = dataclasses.replace(cfg_t, **vsd)
    bb = SDUNetBackbone(cfg_t, device="meta")
    # VSD's LoRA and camera embedding keep the SD VAE (512^2 images)
    assert bb.vae_cfg == vae.SD_VAE and bb.image_size == 512
    port = {k: tuple(v.shape)
            for k, v in getattr(bb, which[:4] if which != "vae" else
                                "vae").state_dict().items()}
    # zero-stride stand-ins: no memory for 866M parameters
    zeros = jax.tree_util.tree_map(
        lambda s: np.broadcast_to(np.float32(0), s.shape), shapes)
    mapped = {}
    for path, leaf in flat_paths(zeros["params"]).items():
        key_t, kind = flax_path_to_torch_key(path)
        mapped[key_t] = tuple(to_torch_leaf(kind, leaf).shape)
    assert mapped == port
    n = sum(int(np.prod(s)) for s in port.values())
    # VSD adds 2,491,392 trainable LoRA and camera-embedding parameters
    assert n == dict(unet=865_910_724, vae=83_653_863,
                     unet_vsd=868_402_116)[which]
