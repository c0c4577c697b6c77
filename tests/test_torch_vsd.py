"""gsgen_torch's VSD guidance and its trainer step against the JAX package.

The same numpy inputs go to both packages; the port takes the JAX
parameters (UNet with LoRA and camera embedding, MockUNet, the trainable
leaves) through its ``convert.py`` naming, and the JAX loss's own random
draws, repeated from its key, as ``t``, ``noise``, ``t_lora``,
``noise_lora`` and ``drop``.  The JAX UNet runs its einsum attention
(``set_fused_attention("off")``); the port's runs K5-K7's plain versions
on the CPU ("on" mode goes through the autograd Function).  Tolerances
(fp32 on the CPU, summation order): losses and ``grad_norm`` rtol 1e-4;
gradients within 2e-4 of each tensor's largest gradient (1e-4 relative
for the eps-predictions, as in test_torch_unet.py).  The trainer step:
losses rtol 1e-4; the guidance leaves' Adam moments rtol 2e-3 / atol
2e-4 of each leaf's largest moment; the leaves within 2 lr of the JAX
ones (Adam's first step moves an element by about lr x sign(gradient)).
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsgen_tpu.data.cameras import CameraSamplerConfig as CamJ
from gsgen_tpu.guidance import unet2d as unet_j
from gsgen_tpu.guidance.diffusion import MockUNet as MockJ
from gsgen_tpu.guidance.sd_unet import SDUNetBackbone as BackboneJ
from gsgen_tpu.guidance.vsd import VSDConfig as VSDConfigJ
from gsgen_tpu.guidance.vsd import VSDGuidance as VSDGuidanceJ
from gsgen_tpu.io.checkpoint import _flatten_with_paths
from gsgen_tpu.models.background import BackgroundConfig as BgJ
from gsgen_tpu.models.density import DensifyConfig as DensJ
from gsgen_tpu.models.density import PruneConfig as PruneJ
from gsgen_tpu.models.init import InitConfig as InitJ
from gsgen_tpu.models.scene import RenderConfig as RenderJ
from gsgen_tpu.prompt import processors as proc_j
from gsgen_tpu.training.trainer import Trainer as TrainerJ
from gsgen_tpu.training.trainer import TrainerConfig as TcfgJ
from gsgen_torch.config import build_trainer, load_config
from gsgen_torch.data.cameras import CameraSamplerConfig
from gsgen_torch.guidance.diffusion import mock_unet_from_jax_params
from gsgen_torch.guidance.sd_unet import (TINY_VSD, SDUNetBackbone,
                                          backbone_from_jax_params)
from gsgen_torch.guidance.unet2d import set_fused_attention
from gsgen_torch.guidance.vsd import VSDConfig, VSDGuidance
from gsgen_torch.models.background import BackgroundConfig
from gsgen_torch.models.density import DensifyConfig, PruneConfig
from gsgen_torch.models.init import InitConfig
from gsgen_torch.models.scene import RenderConfig
from gsgen_torch.ops import flash_attention as fa
from gsgen_torch.prompt import processors
from gsgen_torch.training.trainer import (Trainer, TrainerConfig, _gp_leaf,
                                          train_state_from_jax_arrays)
from torch_fixtures import t

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module", autouse=True)
def _einsum_attention():
    unet_j.set_fused_attention("off")
    yield
    unet_j.set_fused_attention("auto")


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(got, want, frac, msg=""):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=frac * np.abs(want).max(), err_msg=msg)


@pytest.fixture(scope="module")
def tiny_pair():
    """TINY_VSD in both packages, the JAX parameters carried across, and
    non-zero up-projections (so that every trainable leaf has a
    gradient)."""
    bb_j = BackboneJ(unet_j.TINY_VSD, latent_size=8)
    g_j = VSDGuidanceJ(VSDConfigJ(), bb_j)
    rng = np.random.default_rng(0)
    train_j = {k: (v + 0.02 * rng.standard_normal(v.shape).astype(np.float32)
                   if k.endswith("up/kernel") else v)
               for k, v in _np(g_j.trainable_params).items()}
    bb_t = backbone_from_jax_params(_np(bb_j.params), TINY_VSD,
                                    latent_size=8, device="cpu",
                                    fp32_unet=True)
    set_fused_attention(bb_t, "on")
    return g_j, train_j, bb_t


def test_vsd_configs_build_and_train(tmp_path, monkeypatch):
    """base + guidance/vsd + prompt/vsd (merged as ``--config`` does) on
    the TINY preset: the UNet in fp32 with LoRA and a camera embedding,
    the VAE in bf16, ``gp/<name>`` optimizer leaves that move, and no
    kernel launch on the CPU."""
    monkeypatch.chdir(tmp_path)          # the prompt cache is cwd-relative
    cfgs = [ROOT / "configs" / n for n in
            ("base.yaml", "guidance/vsd.yaml", "prompt/vsd.yaml")]
    tr = build_trainer(load_config(cfgs, [
        "guidance.backbone_preset=tiny", "init.num_points=64",
        "init.capacity=128", "data.reso=[32]", "renderer.tile_size=8",
        "renderer.chunk=128", "renderer.dup_cap=4096",
        "trainer.batch_size=2"]), device="cpu")
    g = tr.guidance
    assert isinstance(g, VSDGuidance) and g.faithful
    assert g.cfg.guidance_scale == 7.5 and g.cfg.lora_rank == 4
    bb = g.backbone
    assert bb.cfg.lora_rank == 4 and bb.cfg.class_embed_proj_dim == 16
    assert all(p.dtype == torch.float32 for p in bb.unet.parameters())
    assert all(p.dtype == torch.bfloat16 for p in bb.vae.parameters())
    assert set(tr.state.gp) == set(g.trainable_params)
    assert {k for k in tr.state.opt.mu if k.startswith("gp/")} == {
        f"gp/{k}" for k in tr.state.gp}
    s = tr.sched_scalars(0)
    assert (s["min_t"], s["max_t"], s["lr_guidance"]) == (20, 980, 1e-4)
    assert tr.sched_scalars(5001)["max_t"] == 500
    gp0 = {k: v.clone() for k, v in tr.state.gp.items()}
    n = (fa.flash_self_attention.launches, fa.flash_bwd_dkv.launches,
         fa.flash_bwd_dq.launches)
    metrics = []
    tr.fit(2, callback=lambda i, m: metrics.append(m))
    assert tr.state.step == 2
    assert all(np.isfinite(float(m[k])) for m in metrics
               for k in ("loss_vsd", "loss_lora", "loss_total"))
    assert max(float((v - gp0[k]).abs().max())
               for k, v in tr.state.gp.items()) > 0
    assert (fa.flash_self_attention.launches, fa.flash_bwd_dkv.launches,
            fa.flash_bwd_dq.launches) == n
    # the guidance-eval samples of the trained state: the frozen model and
    # the LoRA model on the trainer's leaves, 2 DDIM steps, no K5 on the CPU
    emb = tr.prompt_processor()
    pose = [torch.tensor([15.0]), torch.tensor([30.0]), torch.tensor([2.5])]
    img = g.sample(emb, *pose, num_steps=2,
                   generator=torch.Generator().manual_seed(0))
    c2w = torch.eye(4)[None, :3]
    img_l = g.sample_lora(emb, *pose, c2w, num_steps=2, train=tr.state.gp,
                          generator=torch.Generator().manual_seed(0))
    assert img.shape == img_l.shape == (1, bb.image_size, bb.image_size, 3)
    assert float(img.min()) >= 0.0 and float(img.max()) <= 1.0
    assert float((img - img_l).abs().max()) > 0.0
    assert fa.flash_self_attention.launches == n[0]


def test_trainable_leaves_and_init(tiny_pair):
    g_j, _, bb_t = tiny_pair
    g_t = VSDGuidance(VSDConfig(), bb_t, device="cpu")
    assert g_t.faithful
    want = dict(_gp_leaf(k, v) for k, v in _np(g_j.trainable_params).items())
    assert set(g_t.trainable_params) == set(want)
    for k, v in g_t.trainable_params.items():
        np.testing.assert_array_equal(v.numpy(), want[k], err_msg=k)
        assert not v.requires_grad
    assert all(not p.requires_grad for p in bb_t.parameters())
    # the port's own init: up zeros, down N(0, 1/rank) in std
    bb = SDUNetBackbone(TINY_VSD, latent_size=8, device="cpu",
                        compute_dtype="bfloat16", fp32_unet=True)
    assert all(p.dtype == torch.float32 for p in bb.unet.parameters())
    assert all(p.dtype == torch.bfloat16 for p in bb.vae.parameters())
    g = VSDGuidance(VSDConfig(), bb, device="cpu").trainable_params
    ups = [v for k, v in g.items() if k.endswith("up.weight")]
    downs = torch.cat([v.reshape(-1) for k, v in g.items()
                       if k.endswith("down.weight")])
    assert ups and all(float(u.abs().max()) == 0.0 for u in ups)
    assert abs(float(downs.std()) - 0.25) < 0.02
    with pytest.raises(ValueError, match="fp32"):
        VSDGuidance(VSDConfig(), SDUNetBackbone(
            TINY_VSD, latent_size=8, device="cpu",
            compute_dtype="bfloat16"), device="cpu")


def test_eps_lora_equals_pretrain_at_init():
    """up = 0 and a zero camera: the LoRA model is the frozen one (the
    class embedding's biases start at zero); a camera breaks the tie."""
    g = VSDGuidance(VSDConfig(), SDUNetBackbone(
        TINY_VSD, latent_size=8, device="cpu", fp32_unet=True), device="cpu")
    rng = np.random.default_rng(1)
    lat = t(rng.standard_normal((2, 8, 8, 4)).astype(np.float32))
    tt = torch.tensor([10, 500])
    text = t(rng.standard_normal((2, 4, 1024)).astype(np.float32) * 0.1)
    with torch.no_grad():
        e_pre = g._eps_pretrain(lat, tt, text)
        e_lora = g._eps_lora(g.trainable_params, lat, tt, text,
                             torch.zeros(2, 16))
        e_cam = g._eps_lora(g.trainable_params, lat, tt, text,
                            torch.ones(2, 16))
    np.testing.assert_allclose(e_lora.numpy(), e_pre.numpy(), atol=1e-5)
    assert float((e_cam - e_pre).abs().max()) > 1e-6


def _jax_draws(key, sched, B, S, lat_shape, T, p):
    """The JAX VSD loss's draws from its key, in its order."""
    k_t, k_noise, k_lt, k_ln, k_drop = jax.random.split(key, 5)
    tt = jax.random.randint(k_t, (B,), sched["min_t"], sched["max_t"] + 1)
    noise = jax.random.normal(k_noise, lat_shape)
    t_l = jax.random.randint(k_lt, (B * S,), 0, T)
    noise_l = jax.random.normal(k_ln, (B * S,) + lat_shape[1:])
    drop = jax.random.bernoulli(k_drop, p)
    return dict(t=t(tt).long(), noise=t(noise), t_lora=t(t_l).long(),
                noise_lora=t(noise_l), drop=bool(drop))


@pytest.mark.parametrize("backbone", ["tiny_vsd", "mock"])
def test_vsd_loss_and_grads_match_jax(backbone, tiny_pair):
    """loss_vsd, loss_lora, grad_norm and the gradients with respect to
    the rgb and every trainable leaf.  TINY_VSD: one timestep sample, the
    camera kept (the key's draw); MockUNet adapter: two timestep samples
    and dropout probability 1 (the dropped-camera path)."""
    B = 2
    rng = np.random.default_rng(3)
    rgb = rng.uniform(0, 1, (B, 32, 32, 3)).astype(np.float32)
    c2ws = rng.standard_normal((B, 3, 4)).astype(np.float32)
    el, az, cd = (np.array(v, np.float32) for v in
                  ([10.0, 60.0], [0.0, 120.0], [2.5, 2.5]))
    sched = {"min_t": 20, "max_t": 980}
    key = jax.random.PRNGKey(3 if backbone == "tiny_vsd" else 2)
    if backbone == "tiny_vsd":
        kw = {}
        g_j, train_j, bb_t = tiny_pair
    else:
        kw = dict(lora_n_timestamp_samples=2, lora_cfg_drop_prob=1.0,
                  backbone_latent_size=8)
        g_j = VSDGuidanceJ(VSDConfigJ(**kw), MockJ(latent_size=8))
        train_j = _np(g_j.trainable_params)
        train_j["up"] = rng.standard_normal((4, 4)).astype(np.float32) * 0.1
        bb_t = mock_unet_from_jax_params(_np(g_j.backbone.params),
                                         latent_size=8, device="cpu")
    emb_j = proc_j.PromptProcessor(
        proc_j.PromptProcessorConfig(use_cache=False))()

    def losses(rgb_, train):
        out = g_j.loss({"frozen": g_j.frozen_params, "train": train}, rgb_,
                       emb_j, jnp.asarray(el), jnp.asarray(az),
                       jnp.asarray(cd), key, sched, c2ws=jnp.asarray(c2ws))
        return out["loss_vsd"] + out["loss_lora"], out

    (_, out_j), (g_rgb_j, g_train_j) = jax.jit(jax.value_and_grad(
        losses, argnums=(0, 1), has_aux=True))(
        jnp.asarray(rgb), jax.tree_util.tree_map(jnp.asarray, train_j))
    lat_shape = (B, 8, 8, 4)
    S = g_j.cfg.lora_n_timestamp_samples
    draws = _jax_draws(key, sched, B, S, lat_shape, 1000,
                       g_j.cfg.lora_cfg_drop_prob)

    g_t = VSDGuidance(VSDConfig(**kw), bb_t, device="cpu")
    emb_t = processors.PromptProcessor(
        processors.PromptProcessorConfig(use_cache=False), device="cpu")()
    train_t = {k: t(v).requires_grad_(True) for k, v in
               (_gp_leaf(k, v) for k, v in train_j.items())}
    x = t(rgb).requires_grad_(True)
    out = g_t.loss(x, emb_t, t(el), t(az), t(cd), sched=sched, c2ws=t(c2ws),
                   train=train_t, **draws)
    grads = torch.autograd.grad(out["loss_vsd"] + out["loss_lora"],
                                [x] + list(train_t.values()))
    for k in ("loss_vsd", "loss_lora", "grad_norm"):
        np.testing.assert_allclose(float(out[k].detach()), float(out_j[k]),
                                   rtol=1e-4, err_msg=k)
    _close(grads[0].numpy(), g_rgb_j, 2e-4, "rgb")
    want = dict(_gp_leaf(k, v) for k, v in _np(g_train_j).items())
    assert set(want) == set(train_t)
    assert not draws["drop"] if backbone == "tiny_vsd" else draws["drop"]
    for k, gr in zip(train_t, grads[1:]):
        # with the camera dropped, the camera projection gets no gradient
        assert np.abs(want[k]).max() > 0 or (draws["drop"] and k == "cam"), k
        _close(gr.numpy(), want[k], 2e-4, k)


def _trainer_pair():
    """One VSD trainer in each package on MockUNet (the JAX MockUNet's
    weights carried across), a fixed background, the JAX state carried
    across with train_state_from_jax_arrays (``gp`` included)."""
    lr = dict(mean=0.005, svec=0.003, qvec=0.003, color=0.01, alpha=0.003,
              bg=0.003)
    kw = dict(max_steps=100, batch_size=2, lr=lr)
    rkw = dict(tile_size=8, chunk=128, dup_cap=4096)
    init = dict(num_points=96, capacity=128, svec_val=0.05, mean_std=0.4)
    data = dict(batch_size=2, max_steps=100, reso=(32,),
                camera_distance=(2.0, 2.5))
    vkw = dict(backbone_latent_size=8, lr_lora=1e-3)
    g_j = VSDGuidanceJ(VSDConfigJ(**vkw), MockJ(latent_size=8))
    g_j.trainable_params["up"] = jnp.asarray(
        np.random.default_rng(5).standard_normal((4, 4)).astype(np.float32)
        * 0.1)
    tj = TrainerJ(cfg=TcfgJ(**kw),
                  rcfg=RenderJ(backend="pallas", pallas_interpret=True,
                               mxu_scans=False, fast_fwd_cumprod=False,
                               **rkw),
                  init_cfg=InitJ(**init),
                  bg_cfg=BgJ(type="fixed", color=(0.1, 0.6, 0.3)),
                  data_cfg=CamJ(**data), guidance=g_j,
                  dcfg=DensJ(enabled=False), pcfg=PruneJ(enabled=False),
                  prompt_processor=proc_j.PromptProcessor(
                      proc_j.PromptProcessorConfig(use_cache=False)))
    g_t = VSDGuidance(VSDConfig(**vkw), mock_unet_from_jax_params(
        _np(g_j.backbone.params), latent_size=8, device="cpu"), device="cpu")
    tt = Trainer(cfg=TrainerConfig(**kw), rcfg=RenderConfig(**rkw),
                 init_cfg=InitConfig(**init),
                 bg_cfg=BackgroundConfig(type="fixed", color=(0.1, 0.6, 0.3)),
                 data_cfg=CameraSamplerConfig(**data), guidance=g_t,
                 dcfg=DensifyConfig(enabled=False),
                 pcfg=PruneConfig(enabled=False),
                 prompt_processor=processors.PromptProcessor(
                     processors.PromptProcessorConfig(use_cache=False),
                     device="cpu"),
                 device="cpu")
    tt.state = train_state_from_jax_arrays(_flatten_with_paths(tj.state),
                                           "cpu")
    return tj, tt


def test_vsd_trainer_step_matches_jax():
    tj, tt = _trainer_pair()
    assert set(tt.state.gp) == {"down", "up", "cam", "cam_b"}
    # the JAX step's VSD draws, repeated from its key (one micro-batch)
    _, k_loop = jax.random.split(tj.state.key)
    _, k_g = jax.random.split(jax.random.split(k_loop, 1)[0])
    sched = tj.sched_scalars(0)
    draws = _jax_draws(k_g, sched, 2, 1, (2, 8, 8, 4), 1000, 0.1)
    loss_t = tt.guidance.loss
    tt.guidance.loss = lambda *a, **kw: loss_t(*a, **{**kw, **draws})
    m_j = tj.train_step(0)
    m_t = tt.train_step(0)
    for k in ("loss_vsd", "loss_lora", "grad_norm", "loss_total"):
        np.testing.assert_allclose(float(m_t[k]), float(m_j[k]), rtol=1e-4,
                                   err_msg=k)
    arrays = _flatten_with_paths(tj.state)
    st = tt.state
    lr = tt.sched_scalars(0)["lr_guidance"]
    assert lr == 1e-3
    for k in st.gp:
        for m in ("mu", "nu"):
            want = arrays[f".opt/.{m}/[2]/['{k}']"]
            got = getattr(st.opt, m)[f"gp/{k}"].numpy()
            np.testing.assert_allclose(got, want, rtol=2e-3,
                                       atol=2e-4 * np.abs(want).max(),
                                       err_msg=f"{m} {k}")
        p_j = arrays[f".gp/['{k}']"]
        np.testing.assert_allclose(st.gp[k].numpy(), p_j, rtol=0,
                                   atol=2 * lr, err_msg=k)
    moved = st.gp["up"] - t(np.asarray(tt.guidance.trainable_params["up"]))
    assert float(moved.abs().max()) > 0.5 * lr

