"""gsgen_torch's weight loaders against the JAX package's, on the CPU.

The port reads ``.safetensors`` with a reader of its own; the JAX package
through the ``safetensors`` package.  Files here are written with the
``safetensors`` package (or the JAX package's ``save_safetensors``) from
random weights the test makes: the reader per dtype and for a sharded
directory, a TINY diffusers directory (``unet/`` + ``vae/``, and a flat
one) through ``load_diffusers_weights`` and through ``build_trainer``'s
``guidance.weights_path``, the template rule (LoRA and the class
embedding keep their initialisation; any other missing, misshapen or
extra key raises), IF-II's ``load_weights`` on ``TINY_SR`` and Point-E
from ``.safetensors``.

Tolerances: the reader bitwise; loaded parameters bitwise (fp32 files);
eps, the encoded latents and the decoded image within 1e-5 of their
largest value (the acceptance limit of a loaded backbone; both run the
same fp32 weights); the upsampler's UNet and Point-E within 2e-5 of their
largest value, as tests/test_torch_if.py and tests/test_torch_point_e.py
hold those modules.
"""

import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors.torch import save_file

from gsgen_tpu.guidance import convert as conv_j
from gsgen_tpu.guidance import point_e as pe_j
from gsgen_tpu.guidance import sd_unet as sd_j
from gsgen_tpu.guidance import unet2d as unet_j
from gsgen_tpu.guidance import upsampler as ups_j
from gsgen_torch.config import build_trainer, load_config
from gsgen_torch.guidance import convert
from gsgen_torch.guidance import point_e as pe
from gsgen_torch.guidance import sd_unet, unet2d, upsampler
from torch_fixtures import t

ROOT = Path(__file__).resolve().parents[1]
SMALL = ["init.num_points=96", "init.capacity=128", "data.reso=[32]",
         "renderer.tile_size=8", "renderer.chunk=128",
         "renderer.dup_cap=4096", "trainer.batch_size=2",
         "prompt.use_cache=false", "guidance.backbone=sd_unet",
         "guidance.backbone_preset=tiny"]


@pytest.fixture(scope="module", autouse=True)
def _einsum_attention():
    unet_j.set_fused_attention("off")
    yield
    unet_j.set_fused_attention("auto")


def _close(got, want, share, what=""):
    want = np.asarray(want)
    scale = float(np.abs(want).max())
    assert scale > 0, what
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=share * scale, err_msg=what)


def _bits(x):
    """A tensor's or array's raw bits as a numpy array."""
    if torch.is_tensor(x):
        x = x.view(torch.int16) if x.dtype == torch.bfloat16 else x
        return x.numpy()
    x = np.asarray(x)
    return x.view(np.int16) if x.dtype.name == "bfloat16" else x


def _tensors(seed, dtype, shapes=((3, 5), (7,), (), (0, 4), (2, 3, 4))):
    g = torch.Generator().manual_seed(seed)
    out = {}
    for i, shp in enumerate(shapes):
        if dtype.is_floating_point:
            out[f"w.{i}"] = (torch.randn(shp, generator=g) * 3).to(dtype)
        else:
            out[f"w.{i}"] = torch.randint(-2 ** 31, 2 ** 31 - 1, shp,
                                          generator=g).to(dtype)
    return out


@pytest.mark.parametrize("dtype", ["F32", "F16", "BF16", "I64", "I32"])
def test_reader_matches_jax_bitwise(tmp_path, dtype):
    dt = {"F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16,
          "I64": torch.int64, "I32": torch.int32}[dtype]
    want = _tensors(1, dt)
    path = tmp_path / "w.safetensors"
    save_file(want, str(path), metadata={"format": "pt"})
    got = convert.load_safetensors(path)
    got_j = conv_j.load_safetensors(str(path))
    assert list(got) == sorted(want) and set(got_j) == set(want)
    for k, v in want.items():
        assert got[k].dtype == dt and tuple(got[k].shape) == tuple(v.shape)
        np.testing.assert_array_equal(_bits(got[k]), _bits(got_j[k]), k)
        np.testing.assert_array_equal(_bits(got[k]), _bits(v), k)
    # read_state_dict takes the file (and the Point-E / CLIP loaders with it)
    assert set(convert.read_state_dict(str(path))) == set(want)


def test_reader_merges_sharded_directory(tmp_path):
    """Every *.safetensors of a directory in sorted order (a later shard's
    key wins, as in the JAX reader), each file's keys by name; other files
    are ignored; an empty directory raises the JAX message."""
    a = _tensors(2, torch.float32)
    b = {"w.0": torch.ones(3, 5), "v.9": torch.arange(4, dtype=torch.int64)}
    save_file(a, str(tmp_path / "model-00001-of-00002.safetensors"))
    save_file(b, str(tmp_path / "model-00002-of-00002.safetensors"))
    (tmp_path / "config.json").write_text("{}")
    got = convert.load_safetensors(tmp_path)
    got_j = conv_j.load_safetensors(str(tmp_path))
    assert set(got) == set(a) | set(b)
    assert list(got) == list(got_j)       # the key order too
    for k in got:
        np.testing.assert_array_equal(_bits(got[k]), _bits(got_j[k]), k)
    np.testing.assert_array_equal(got["w.0"].numpy(), np.ones((3, 5)))
    empty = tmp_path / "empty"
    empty.mkdir()
    with pytest.raises(FileNotFoundError) as e_t:
        convert.load_safetensors(empty)
    with pytest.raises(FileNotFoundError) as e_j:
        conv_j.load_safetensors(str(empty))
    assert str(e_t.value) == str(e_j.value)


def _bumped(params, seed):
    """A flax tree with every leaf moved by N(0, 0.02²) (nonzero biases)."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda x: np.asarray(x) + (0.02 * rng.standard_normal(x.shape)
                                   ).astype(np.float32), params)


@pytest.fixture(scope="module")
def sd_dir(tmp_path_factory):
    """A TINY diffusers directory (unet/ and vae/ safetensors) written from
    the JAX backbone's parameters, and the JAX loader's backbone on it."""
    root = tmp_path_factory.mktemp("tiny_sd")
    bb_j = sd_j.SDUNetBackbone(unet_j.TINY, latent_size=8)
    for name, sub in (("unet", "unet"), ("vae", "vae")):
        conv_j.save_safetensors(
            conv_j.flax_to_torch_state(_bumped(bb_j.params[name], 3)),
            str(root / sub / "diffusion_pytorch_model.safetensors"))
    return root, sd_j.load_diffusers_weights(str(root), unet_j.TINY,
                                             latent_size=8)


def test_diffusers_directory_matches_jax(sd_dir):
    """eps, the encoded latents and the decoded image of the port's loaded
    backbone against the JAX loader's, on the same inputs; every loaded
    parameter bitwise the file's."""
    root, bb_j = sd_dir
    bb = sd_unet.load_diffusers_weights(str(root), unet2d.TINY,
                                        latent_size=8, device="cpu")
    for name in ("unet", "vae"):
        file = convert.load_safetensors(root / name)
        mine = getattr(bb, name).state_dict()
        assert set(mine) == set(file)
        for k, v in file.items():
            np.testing.assert_array_equal(mine[k].numpy(), v.numpy(), k)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
    tt = np.array([10, 700], np.int32)
    ctx = rng.standard_normal((2, 7, 1024)).astype(np.float32)
    with torch.no_grad():
        eps = bb.predict_noise(t(x), t(tt), t(ctx))
    _close(eps.numpy(), jax.jit(bb_j.predict_noise)(
        bb_j.params, jnp.asarray(x), jnp.asarray(tt), jnp.asarray(ctx)),
        1e-5, "eps")
    img = rng.uniform(0, 1, (1, 16, 16, 3)).astype(np.float32)
    with torch.no_grad():
        z = bb.encode_images(t(img))
    _close(z.numpy(), jax.jit(bb_j.encode_images)(bb_j.params,
                                                  jnp.asarray(img)),
           1e-5, "encode")
    lat = rng.standard_normal((1, 8, 8, 4)).astype(np.float32) * 0.2
    _close(bb.decode_latents(t(lat)).numpy(),
           jax.jit(bb_j.decode_latents)(bb_j.params, jnp.asarray(lat)), 1e-5,
           "decode")


def test_flat_directory_and_bf16_cast(sd_dir, tmp_path):
    """A directory that holds the UNet itself (pixel space: no VAE), as
    the JAX loader reads it: the same eps as the JAX loader's UNet from
    ``unet/``; compute_dtype casts after the load."""
    root, bb_j = sd_dir
    flat = tmp_path / "flat"
    flat.mkdir()
    (flat / "diffusion_pytorch_model.safetensors").write_bytes(
        (root / "unet" / "diffusion_pytorch_model.safetensors").read_bytes())
    bb = sd_unet.load_diffusers_weights(str(flat), unet2d.TINY,
                                        latent_size=8, use_vae=False,
                                        device="cpu")
    assert bb.vae is None
    rng = np.random.default_rng(5)
    x = rng.standard_normal((1, 8, 8, 4)).astype(np.float32)
    ctx = rng.standard_normal((1, 5, 1024)).astype(np.float32)
    tt = np.array([400], np.int32)
    with torch.no_grad():
        eps = bb.predict_noise(t(x), t(tt), t(ctx))
    _close(eps.numpy(), jax.jit(bb_j.predict_noise)(
        bb_j.params, jnp.asarray(x), jnp.asarray(tt), jnp.asarray(ctx)),
        1e-5)
    bf = sd_unet.load_diffusers_weights(str(flat), unet2d.TINY,
                                        latent_size=8, use_vae=False,
                                        compute_dtype="bfloat16",
                                        device="cpu")
    ref = {k: v.to(torch.bfloat16) for k, v in bb.unet.state_dict().items()}
    for k, v in bf.unet.state_dict().items():
        assert v.dtype == torch.bfloat16
        assert torch.equal(v, ref[k]), k


def test_weights_path_through_build_trainer(sd_dir):
    """guidance.weights_path builds the backbone through the loader: the
    preset and the dtype as without weights, the file's parameters."""
    root, _ = sd_dir
    tr = build_trainer(load_config(ROOT / "configs" / "base.yaml", SMALL + [
        f"guidance.weights_path={root}", "guidance.backbone_dtype=bfloat16"]),
        device="cpu")
    bb = tr.guidance.backbone
    assert bb.cfg == unet2d.TINY and bb.latent_size == 8
    file = convert.load_safetensors(root / "vae")
    for k, v in bb.vae.state_dict().items():
        assert v.dtype == torch.bfloat16
        assert torch.equal(v, file[k].to(torch.bfloat16)), k
    m = tr.train_step(0)
    assert np.isfinite(float(m["loss_total"]))


def test_template_rule_lora_and_errors(tmp_path):
    """A pretrained checkpoint has no LoRA or class-embedding leaves: they
    keep the fresh initialisation (the generator's), everything else is
    the file's.  A missing, misshapen or extra key raises in both
    packages."""
    cfg_j = dataclasses.replace(unet_j.TINY, lora_rank=4,
                                class_embed_proj_dim=16)
    model_j = unet_j.UNet2DConditionModel(cfg_j)
    params = jax.jit(model_j.init)(
        jax.random.PRNGKey(6), jnp.zeros((1, 8, 8, 4)), jnp.zeros((1,)),
        jnp.zeros((1, 4, 1024)), class_labels=jnp.zeros((1, 16)))
    full = conv_j.flax_to_torch_state(_bumped(params, 7))
    pre = {k: v for k, v in full.items()
           if "lora" not in k and "class_embedding" not in k}
    assert len(pre) < len(full)
    path = tmp_path / "unet" / "diffusion_pytorch_model.safetensors"
    conv_j.save_safetensors(pre, str(path))
    kw = dict(latent_size=8, use_vae=False, device="cpu")
    bb = sd_unet.load_diffusers_weights(
        str(tmp_path), unet2d.TINY_VSD,
        generator=torch.Generator().manual_seed(8), **kw)
    fresh = sd_unet.SDUNetBackbone(
        unet2d.TINY_VSD, generator=torch.Generator().manual_seed(8), **kw)
    ref = fresh.unet.state_dict()
    n_kept = 0
    for k, v in bb.unet.state_dict().items():
        if k in pre:
            np.testing.assert_array_equal(v.numpy(), pre[k], k)
        else:
            assert "lora" in k or "class_embedding" in k, k
            assert torch.equal(v, ref[k]), k
            n_kept += 1
    assert n_kept == len(full) - len(pre)
    # the JAX loader's rule takes the same file
    conv_j.torch_state_to_flax(conv_j.load_safetensors(str(path)), params)

    name = "conv_in.weight"
    for bad, err in (({k: v for k, v in pre.items() if k != name},
                      KeyError),
                     ({**pre, name: pre[name][:, :2]}, ValueError),
                     ({**pre, "extra.weight": np.zeros(3, np.float32)},
                      KeyError)):
        conv_j.save_safetensors(bad, str(path))
        with pytest.raises(err):
            convert.load_template(fresh.unet, str(path))
        with pytest.raises(err):
            conv_j.torch_state_to_flax(conv_j.load_safetensors(str(path)),
                                       params)


def test_if2_load_weights_tiny_sr(tmp_path):
    """IF-II from safetensors on TINY_SR: the file's parameters bitwise,
    the noise-level class embedding kept (the JAX template skips it), and
    the UNet's output with the JAX class embedding copied in equal to the
    JAX loader's."""
    up_j = object.__new__(ups_j.DiffusionUpsampler)
    up_j.cfg = ups_j.UpsamplerConfig(reso=16, num_steps=3)
    up_j.unet_cfg = ups_j.TINY_SR
    up_j.unet = unet_j.UNet2DConditionModel(ups_j.TINY_SR)
    up_j.params = jax.jit(up_j.unet.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 6)), jnp.zeros((1,)),
        jnp.zeros((1, 4, 1024)), class_labels=jnp.zeros((1,), jnp.int32))
    full = conv_j.flax_to_torch_state(_bumped(up_j.params, 9))
    state = {k: v for k, v in full.items() if "class_embedding" not in k}
    path = tmp_path / "if2.safetensors"
    conv_j.save_safetensors(state, str(path))
    ups_j.DiffusionUpsampler.load_weights(up_j, str(path))
    up = upsampler.DiffusionUpsampler(
        upsampler.UpsamplerConfig(reso=16, num_steps=3), upsampler.TINY_SR,
        device="cpu", generator=torch.Generator().manual_seed(2))
    fresh = upsampler.DiffusionUpsampler(
        upsampler.UpsamplerConfig(reso=16, num_steps=3), upsampler.TINY_SR,
        device="cpu", generator=torch.Generator().manual_seed(2))
    assert up.load_weights(str(path)) is up
    ref = fresh.unet.state_dict()
    for k, v in up.unet.state_dict().items():
        want = state[k] if k in state else ref[k].numpy()
        np.testing.assert_array_equal(v.numpy(), want, k)
    jax_state = conv_j.flax_to_torch_state(up_j.params)
    up.unet.load_state_dict({k: torch.tensor(v) for k, v in
                             jax_state.items() if "class_embedding" in k},
                            strict=False)
    rng = np.random.default_rng(10)
    x = rng.standard_normal((2, 16, 16, 6)).astype(np.float32)
    tt = np.array([30, 900], np.int32)
    ctx = rng.standard_normal((2, 5, 1024)).astype(np.float32)
    lvl = np.array([250, 100], np.int32)
    with torch.no_grad():
        got = up.unet(t(x), t(tt), t(ctx), class_labels=t(lvl))
    want = jax.jit(up_j.unet.apply)(up_j.params, jnp.asarray(x),
                                    jnp.asarray(tt), jnp.asarray(ctx),
                                    class_labels=jnp.asarray(lvl))
    _close(got.numpy(), want, 2e-5)


@pytest.mark.parametrize("stage", ["base", "upsample"])
def test_point_e_from_safetensors(tmp_path, stage):
    """A random upstream-layout Point-E state dict (the port's names, an
    upstream ``clip.*`` key and, for the upsampler, the channel scales,
    which both loaders drop) written as safetensors: the same outputs."""
    if stage == "base":
        m_t = pe.PointEModel(pe.TINY_POINT_E, device="cpu", seed=3)
        m_j = pe_j.PointEModel(pe_j.TINY_POINT_E, key=jax.random.PRNGKey(1))
    else:
        m_t = pe.PointEUpsamplerModel(pe.TINY_UPSAMPLE, device="cpu", seed=3)
        m_j = pe_j.PointEUpsamplerModel(pe_j.TINY_UPSAMPLE,
                                        key=jax.random.PRNGKey(1))
    g = torch.Generator().manual_seed(11)
    state = {k: v + 0.05 * torch.randn(v.shape, generator=g)
             for k, v in m_t.module.state_dict().items()}
    state["clip.model.token_embedding.weight"] = torch.zeros(4, 2)
    if stage == "upsample":
        state["channel_scales"] = torch.ones(6)
    path = tmp_path / f"{stage}.safetensors"
    save_file(state, str(path))
    m_t.load_weights(str(path))
    m_j.load_weights(str(path))
    rng = np.random.default_rng(12)
    n = m_t.cfg.n_ctx
    x = rng.standard_normal((2, 6, n)).astype(np.float32)
    tt = np.array([3.0, 700.0], np.float32)
    if stage == "base":
        cond = rng.standard_normal((2, 16)).astype(np.float32)
        got = m_t.apply(t(x), t(tt), t(cond))
        want = m_j.apply(m_j.params, jnp.asarray(x), jnp.asarray(tt),
                         jnp.asarray(cond))
    else:
        low = rng.uniform(0, 1, (2, 6, 32)).astype(np.float32)
        got = m_t.apply(t(x), t(tt), t(low))
        want = m_j.apply(m_j.params, jnp.asarray(x), jnp.asarray(tt),
                         low_res=jnp.asarray(low))
    _close(got.numpy(), want, 2e-5, stage)
