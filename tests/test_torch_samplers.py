"""gsgen_torch's sampling loops and the guidance samples against the JAX
package: the timestep vectors, DDIM (eta 0 and 0.5), PNDM through every
Adams-Bashforth order, DDPM ancestral, ``cfg_sample`` on a variance-split
net, ``SDSGuidance.sample`` (TINY SD with its VAE, and MockUNet), VSD's
``sample`` and ``sample_lora`` (TINY_VSD) and the trainer's guidance-eval
image.

Both sides get the same numpy inputs; where a JAX loop draws from its key
(the initial latents of ``cfg_sample``, DDIM's eta > 0 noise, the
ancestral posterior draws), the test draws the same values with the same
``jax.random`` calls and hands them to the port as ``x`` and a
``[num_steps, ...]`` ``noise`` stack.  The JAX UNet runs its einsum
attention (``set_fused_attention("off")``).  Tolerances (fp32 on the CPU):
timestep vectors exact; the loops on an analytic eps within atol 1e-5;
through a UNet within 1e-4 of the output's largest value (the CFG scale
multiplies the eps difference; the samples use 7.5).
"""

import dataclasses
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsgen_tpu.guidance import diffusion as diff_j
from gsgen_tpu.guidance import samplers as samp_j
from gsgen_tpu.guidance import unet2d as unet_j
from gsgen_tpu.guidance.sd_unet import SDUNetBackbone as BackboneJ
from gsgen_tpu.guidance.sds import SDSConfig as SDSConfigJ
from gsgen_tpu.guidance.sds import SDSGuidance as SDSGuidanceJ
from gsgen_tpu.guidance.vsd import VSDConfig as VSDConfigJ
from gsgen_tpu.guidance.vsd import VSDGuidance as VSDGuidanceJ
from gsgen_tpu.prompt import processors as proc_j
from gsgen_tpu.training.trainer import Trainer as TrainerJ
from gsgen_torch.config import build_trainer, load_config
from gsgen_torch.guidance import diffusion, samplers, upsampler
from gsgen_torch.guidance.sd_unet import TINY, TINY_VSD, \
    backbone_from_jax_params
from gsgen_torch.guidance.sds import SDSConfig, SDSGuidance
from gsgen_torch.guidance.vsd import VSDConfig, VSDGuidance
from gsgen_torch.prompt import processors
from torch_fixtures import t

ROOT = Path(__file__).resolve().parents[1]
STEPS = 4
N_VIEWS = 2
POSE = (np.array([10.0, 70.0], np.float32),
        np.array([20.0, -160.0], np.float32),
        np.array([2.5, 2.5], np.float32))


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


@pytest.fixture(scope="module")
def tiny():
    """The TINY SD backbone (UNet + VAE, latent 8) in both packages."""
    bb_j = BackboneJ(unet_j.TINY, latent_size=8)
    bb_t = backbone_from_jax_params(_np(bb_j.params), TINY, latent_size=8,
                                    device="cpu")
    return bb_j, bb_t


@pytest.fixture(scope="module")
def prompts():
    cfg = dict(prompt="a corgi", use_cache=False)
    return (proc_j.PromptProcessor(proc_j.PromptProcessorConfig(**cfg))(),
            processors.PromptProcessor(
                processors.PromptProcessorConfig(**cfg), device="cpu")())


def _step_noise(key, n, shape):
    """The per-step draws of a JAX loop: normal(split(key, n)[i])."""
    keys = jax.random.split(key, n)
    return np.stack([np.asarray(jax.random.normal(k, shape)) for k in keys])


def _cfg_draws(key, shape, n, stochastic):
    """cfg_sample's draws: x from split(key)[0], the loop's from [1]."""
    k_init, k_samp = jax.random.split(key)
    x = np.asarray(jax.random.normal(k_init, shape))
    return x, (_step_noise(k_samp, n, shape) if stochastic else None)


@pytest.mark.parametrize("n", [1, 7, 25, 50])
def test_timestep_vectors_match_jax(n):
    np.testing.assert_array_equal(
        samplers.leading_timesteps(1000, n).numpy(),
        np.asarray(samp_j.leading_timesteps(1000, n)))
    np.testing.assert_array_equal(
        samplers.leading_timesteps(1000, n, steps_offset=0).numpy(),
        np.asarray(samp_j.leading_timesteps(1000, n, 0)))
    np.testing.assert_array_equal(
        upsampler.upsampler_timesteps(1000, n).numpy(),
        np.asarray(jnp.round(jnp.linspace(999, 0, n)).astype(jnp.int32)))


def test_upsampler_timesteps_match_jax_up_to_60_steps():
    """The JAX upsampler's ``round(linspace(T - 1, 0, n))`` in float32: an
    ulp decides the rounding at points like 166.5 (n = 25)."""
    for n in range(1, 61):
        np.testing.assert_array_equal(
            upsampler.upsampler_timesteps(1000, n).numpy(),
            np.asarray(jnp.round(jnp.linspace(999, 0, n)).astype(jnp.int32)),
            err_msg=f"n = {n}")


# kind -> (type, eta, steps): PNDM at 6 steps runs the warm-up and the
# Adams-Bashforth orders 2, 3 and 4 (twice)
SAMPLERS = {"ddim": ("ddim", 0.0, STEPS), "ddim_eta": ("ddim", 0.5, STEPS),
            "pndm": ("pndm", 0.0, 6), "ancestral": ("ancestral", 0.0, STEPS)}


def _run_both(kind, eps_j, eps_t, x):
    typ, eta, n = SAMPLERS[kind]
    key = jax.random.PRNGKey(3)
    stochastic = typ == "ancestral" or eta > 0
    noise = _step_noise(key, n, x.shape) if stochastic else None
    s_j, s_t = diff_j.scaled_linear_schedule(), \
        diffusion.scaled_linear_schedule()
    cfg_j = samp_j.SamplerConfig(type=typ, num_steps=n, eta=eta)
    want = samp_j.sample(cfg_j, eps_j, s_j, jnp.asarray(x),
                         key=key if stochastic else None)
    calls = []

    def counted(x, tt):
        calls.append(tt)
        return eps_t(x, tt)

    got = samplers.sample(samplers.SamplerConfig(type=typ, num_steps=n,
                                                 eta=eta), counted, s_t,
                          t(x), noise=None if noise is None else t(noise))
    assert len(calls) == n + (typ == "pndm")
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("kind", list(SAMPLERS))
def test_sampler_loops_on_analytic_eps_match_jax(kind):
    x = np.random.default_rng(0).standard_normal((2, 5, 5, 3)).astype(
        np.float32)
    got, want = _run_both(
        kind, lambda x, tt: 0.9 * jnp.tanh(0.7 * x + tt / 1000.0 - 0.3),
        lambda x, tt: 0.9 * torch.tanh(0.7 * x + tt / 1000.0 - 0.3), x)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("kind", list(SAMPLERS))
def test_sampler_loops_on_tiny_unet_match_jax(kind, tiny):
    bb_j, bb_t = tiny
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
    ctx = rng.standard_normal((2, 7, 1024)).astype(np.float32)
    got, want = _run_both(
        kind,
        lambda x, tt: bb_j.predict_noise(
            bb_j.params, x, jnp.full((2,), tt, jnp.int32), jnp.asarray(ctx)),
        lambda x, tt: bb_t.predict_noise(x, torch.full((2,), tt), t(ctx)),
        x)
    _close(got, want)


@pytest.mark.parametrize("typ", ["ddim", "ancestral"])
def test_cfg_sample_on_a_variance_split_net_matches_jax(typ):
    """A net giving 2C channels (eps, variance) for a [2B] cond / uncond
    stack: the variance half is split off and the halves combined as
    e_u + s (e_c - e_u)."""
    B, shape = 2, (2, 4, 4, 3)
    w = np.random.default_rng(2).standard_normal((3, 6)).astype(np.float32)
    gain = np.array([1.3, 1.3, 0.8, 0.8], np.float32)[:, None, None, None]

    def net_j(lat2, t2):
        h = jnp.tanh(lat2 @ jnp.asarray(w) + t2[:, None, None, None] / 1e3)
        return h * jnp.asarray(gain)

    def net_t(lat2, t2):
        h = torch.tanh(lat2 @ t(w) + t2[:, None, None, None] / 1e3)
        return h * t(gain)

    key = jax.random.PRNGKey(5)
    x, noise = _cfg_draws(key, shape, 3, typ == "ancestral")
    cfg = dict(type=typ, num_steps=3)
    want = samp_j.cfg_sample(samp_j.SamplerConfig(**cfg),
                             diff_j.scaled_linear_schedule(), shape, key,
                             7.5, net_j)
    got = samplers.cfg_sample(
        samplers.SamplerConfig(**cfg), diffusion.scaled_linear_schedule(),
        shape, 7.5, net_t, device="cpu", x=t(x),
        noise=None if noise is None else t(noise))
    assert got.shape == (B, 4, 4, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


def test_sampler_dispatch_errors():
    s = diffusion.scaled_linear_schedule()
    x = torch.zeros(1, 2, 2, 3)
    with pytest.raises(ValueError, match="generator or noise"):
        samplers.sample(samplers.SamplerConfig(type="ancestral"),
                        lambda x, tt: x, s, x)
    with pytest.raises(NotImplementedError):
        samplers.sample(samplers.SamplerConfig(type="euler"),
                        lambda x, tt: x, s, x)
    # a generator draws the ancestral noise itself; the last step
    # returns the clipped x0
    g = torch.Generator().manual_seed(0)
    out = samplers.sample(samplers.SamplerConfig(type="ancestral",
                                                 num_steps=2),
                          lambda x, tt: torch.zeros_like(x), s, x + 50.0,
                          generator=g)
    assert float(out.abs().max()) <= 10.0


@pytest.mark.parametrize("backbone", ["tiny", "mock"])
def test_sds_sample_matches_jax(backbone, tiny, prompts):
    """TINY (decoded by its VAE) and MockUNet (x[..., :3] mapped from
    [-1, 1]), DDIM from the JAX draws."""
    emb_j, emb_t = prompts
    if backbone == "tiny":
        bb_j, bb_t = tiny
    else:
        bb_j = diff_j.MockUNet(latent_size=8)
        bb_t = diffusion.mock_unet_from_jax_params(_np(bb_j.params),
                                                   latent_size=8,
                                                   device="cpu")
    g_j = SDSGuidanceJ(SDSConfigJ(guidance_scale=7.5), bb_j)
    g_t = SDSGuidance(SDSConfig(guidance_scale=7.5), bb_t, device="cpu")
    key = jax.random.PRNGKey(7)
    x, _ = _cfg_draws(key, (N_VIEWS, 8, 8, 4), STEPS, False)
    want = g_j.sample({"frozen": g_j.frozen_params}, emb_j,
                      *map(jnp.asarray, POSE), key, num_steps=STEPS)
    got = g_t.sample(emb_t, *map(t, POSE), num_steps=STEPS, x=t(x))
    assert got.shape == tuple(want.shape)
    assert float(got.min()) >= 0.0 and float(got.max()) <= 1.0
    _close(got.numpy(), want)


@pytest.fixture(scope="module")
def tiny_vsd():
    bb_j = BackboneJ(unet_j.TINY_VSD, latent_size=8)
    g_j = VSDGuidanceJ(VSDConfigJ(), bb_j)
    rng = np.random.default_rng(0)
    # non-zero up-projections: the LoRA model differs from the frozen one
    train_j = {k: (v + 0.05 * rng.standard_normal(v.shape).astype(np.float32)
                   if k.endswith("up/kernel") else v)
               for k, v in _np(g_j.trainable_params).items()}
    bb_t = backbone_from_jax_params(_np(bb_j.params), TINY_VSD,
                                    latent_size=8, device="cpu",
                                    fp32_unet=True)
    return g_j, train_j, bb_t


def test_vsd_sample_and_sample_lora_match_jax(tiny_vsd, prompts):
    from gsgen_torch.training.trainer import _gp_leaf
    g_j, train_j, bb_t = tiny_vsd
    emb_j, emb_t = prompts
    g_t = VSDGuidance(VSDConfig(), bb_t, device="cpu")
    train_t = {k: t(v) for k, v in
               (_gp_leaf(k, v) for k, v in train_j.items())}
    params = {"frozen": g_j.frozen_params,
              "train": jax.tree_util.tree_map(jnp.asarray, train_j)}
    c2ws = np.random.default_rng(3).standard_normal((N_VIEWS, 3, 4)).astype(
        np.float32)
    pose_j = [jnp.asarray(p) for p in POSE]
    key = jax.random.PRNGKey(11)
    x, _ = _cfg_draws(key, (N_VIEWS, 8, 8, 4), STEPS, False)
    want = g_j.sample(params, emb_j, *pose_j, key, num_steps=STEPS)
    got = g_t.sample(emb_t, *map(t, POSE), num_steps=STEPS, x=t(x))
    _close(got.numpy(), want, msg="sample")
    want_l = g_j.sample_lora(params, emb_j, *pose_j, jnp.asarray(c2ws), key,
                             num_steps=STEPS)
    got_l = g_t.sample_lora(emb_t, *map(t, POSE), t(c2ws), num_steps=STEPS,
                            train=train_t, x=t(x))
    _close(got_l.numpy(), want_l, msg="sample_lora")
    assert float(np.abs(np.asarray(want_l) - np.asarray(want)).max()) > 1e-3


def test_trainer_guidance_sample_matches_jax(tiny, prompts, monkeypatch,
                                             tmp_path):
    """Trainer._guidance_sample at step 5: the JAX trainer's method (on a
    stand-in holding what it reads) against the port's, the pose (15, 30,
    2.5) and the JAX key's initial latents; None on mock guidance."""
    monkeypatch.chdir(tmp_path)
    bb_j, bb_t = tiny
    emb_j, _ = prompts
    steps, step, seed = 3, 5, 0
    g_j = SDSGuidanceJ(SDSConfigJ(guidance_scale=7.5), bb_j)
    stand_in = types.SimpleNamespace(
        prompt_processor=lambda: emb_j, guidance=g_j,
        cfg=types.SimpleNamespace(seed=seed, guidance_eval_steps=steps),
        state=types.SimpleNamespace(gp={}))
    want = TrainerJ._guidance_sample(stand_in, step)
    key = jax.random.fold_in(jax.random.PRNGKey(seed + 7), step)
    x, _ = _cfg_draws(key, (1, 8, 8, 4), steps, False)

    small = ["init.num_points=64", "init.capacity=128", "data.reso=[32]",
             "renderer.dup_cap=4096", "trainer.batch_size=1",
             "prompt.use_cache=false", "prompt.prompt=a corgi"]
    tr = build_trainer(load_config(ROOT / "configs" / "base.yaml", small),
                       device="cpu")
    tr.guidance = SDSGuidance(SDSConfig(guidance_scale=7.5), bb_t,
                              device="cpu")
    tr.prompt_processor = processors.PromptProcessor(
        processors.PromptProcessorConfig(prompt="a corgi", use_cache=False),
        device="cpu")
    tr.cfg = dataclasses.replace(tr.cfg, guidance_eval_steps=steps)
    got = tr._guidance_sample(step, x=t(x))
    assert isinstance(got, np.ndarray) and got.shape == want.shape
    _close(got, want)
    # without x the trainer's generator draws the same image twice
    a, b = tr._guidance_sample(step), tr._guidance_sample(step)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, tr._guidance_sample(step + 1))
    mock = build_trainer(load_config(ROOT / "configs" / "base.yaml",
                                     small + ["guidance.type=mock"]),
                         device="cpu")
    assert mock._guidance_sample(step) is None
