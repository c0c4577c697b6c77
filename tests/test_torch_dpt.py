"""The port's DPT-hybrid and the estimator losses against the JAX package
on the CPU.

``resize_2d`` in each mode, ``DPTHybrid`` on ``TINY_DPT`` (depth and the
3-channel normal head) with both packages filled from one random state
dict built from the port's own module, the omnidata ``.ckpt`` loader and
``DPTEstimator``, and a trainer step with the depth and with the normal
estimator (losses and every field's gradient).

Tolerances: the resizes and the networks rtol 2e-4 / atol 2e-5 of the
output's largest value (the networks: GroupNorm and LayerNorm statistics
summed in another order); the trainer step as the port's other trainer
parity tests (losses rtol 1e-4, each field's gradient within 2e-3
relative plus 2e-4 of its largest value).
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsgen_tpu.data.cameras import CameraSamplerConfig as CamJ
from gsgen_tpu.guidance.mock import MockGuidance as MockJ
from gsgen_tpu.io.checkpoint import _flatten_with_paths
from gsgen_tpu.models.background import BackgroundConfig as BgJ
from gsgen_tpu.models.density import DensifyConfig as DensJ
from gsgen_tpu.models.density import PruneConfig as PruneJ
from gsgen_tpu.models.init import InitConfig as InitJ
from gsgen_tpu.models.scene import GaussianParams
from gsgen_tpu.models.scene import RenderConfig as RenderJ
from gsgen_tpu.priors import dpt as dpt_j
from gsgen_tpu.training.trainer import Trainer as TrainerJ
from gsgen_tpu.training.trainer import TrainerConfig as TcfgJ
from gsgen_torch.data.cameras import CameraSamplerConfig
from gsgen_torch.guidance.mock import MockGuidance
from gsgen_torch.models.background import BackgroundConfig
from gsgen_torch.models.density import DensifyConfig, PruneConfig
from gsgen_torch.models.init import InitConfig
from gsgen_torch.models.scene import FIELDS, RenderConfig
from gsgen_torch.priors import dpt
from gsgen_torch.training.trainer import (Trainer, TrainerConfig,
                                          train_state_from_jax_arrays)
from torch_fixtures import scene3d, t


def _close(got, want, what=""):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=2e-4,
                               atol=2e-5 * max(np.abs(want).max(), 1e-6),
                               err_msg=what)


def random_state(module, seed, out_bias=0.0):
    """A state dict of ``module``'s names: weights ~ N(0, 1/fan_in), norm
    scales 1 + N(0, 0.1²), biases and embeddings N(0, 0.1²); the head's
    last conv a tenth of that, its bias shifted by ``out_bias`` (so the
    output sits inside (0, 1), where the ReLU and the estimator's clamp
    pass the gradient)."""
    g = torch.Generator().manual_seed(seed)
    sd = {}
    for k, v in module.state_dict().items():
        n = torch.randn(v.shape, generator=g)
        if v.dim() >= 2 and not k.endswith(("cls_token", "pos_embed")):
            sd[k] = n / math.sqrt(v[0].numel())
        elif k.endswith("weight"):
            sd[k] = 1.0 + 0.1 * n
        else:
            sd[k] = 0.1 * n
    sd["scratch.output_conv.4.weight"] *= 0.1
    sd["scratch.output_conv.4.bias"] += out_bias
    return sd


def _pair(mode, seed=1):
    nc = 1 if mode == "depth" else 3
    sd = random_state(dpt.DPTHybrid(dataclasses.replace(dpt.TINY_DPT,
                                                        num_channels=nc)),
                      seed, out_bias=0.8)
    m_t = dpt.load_dpt(sd, dpt.TINY_DPT, num_channels=nc, device="cpu")
    m_j, p_j = dpt_j.load_dpt({k: v.numpy() for k, v in sd.items()},
                              dpt_j.TINY_DPT, num_channels=nc)
    return sd, m_t, (m_j, p_j)


@pytest.mark.parametrize("mode,ac,size", [
    ("linear", False, (24, 40)), ("linear", False, (96, 80)),
    ("linear", True, (48, 48)), ("linear", True, (17, 23)),
    ("cubic", False, (20, 20)), ("cubic", False, (64, 50))])
def test_resize_2d_matches_jax(mode, ac, size):
    x = np.random.default_rng(0).standard_normal((2, 32, 36, 3)).astype(
        np.float32)
    want = dpt_j.resize_2d(jnp.asarray(x), size, mode, ac)
    got = dpt.resize_2d(t(x).permute(0, 3, 1, 2), size, mode, ac)
    _close(got.permute(0, 2, 3, 1).numpy(), want)


@pytest.mark.parametrize("mode", ["depth", "normal"])
def test_dpt_hybrid_matches_jax(mode):
    _, m_t, (m_j, p_j) = _pair(mode)
    x = np.random.default_rng(2).uniform(-1, 1, (2, 64, 64, 3)).astype(
        np.float32)
    want = jax.jit(m_j.apply)(p_j, jnp.asarray(x))
    got = m_t(t(x)).numpy()
    assert got.shape == (2, 64, 64, 1 if mode == "depth" else 3)
    assert (got > 0).mean() > 0.9           # the head's ReLU mostly open
    _close(got, want, mode)


def test_state_dict_names_are_the_jax_trees():
    """Every leaf of the JAX template has its key in the port's state dict
    at full width (vitb_rn50_384) and on TINY_DPT."""
    from gsgen_tpu.guidance.convert import _flat_paths, flax_path_to_torch_key
    for cfg_t, cfg_j in ((dpt.TINY_DPT, dpt_j.TINY_DPT),
                         (dpt.DPTConfig(), dpt_j.DPTConfig())):
        with torch.device("meta"):
            names = {k: tuple(v.shape)
                     for k, v in dpt.DPTHybrid(cfg_t).state_dict().items()}
        s = cfg_j.image_size
        tpl = jax.eval_shape(lambda: dpt_j.DPTHybrid(cfg_j).init(
            jax.random.PRNGKey(0), jnp.zeros((1, s, s, 3))))
        want = {}
        for path, leaf in _flat_paths(tpl["params"]).items():
            key, kind = flax_path_to_torch_key(path)
            shape = leaf.shape
            if kind == "kernel":
                shape = (shape[::-1] if len(shape) == 2 else
                         (shape[3], shape[2], shape[0], shape[1]))
            want[key] = tuple(shape)
        assert names == want


@pytest.mark.parametrize("mode", ["depth", "normal"])
def test_omnidata_checkpoint_and_estimator_match_jax(tmp_path, mode):
    sd, _, _ = _pair(mode, seed=3)
    ckpt = {"state_dict": {"model." + k: v for k, v in sd.items()},
            "epoch": 1}
    ckpt["state_dict"]["model.pretrained.model.head.weight"] = \
        torch.zeros(4, 32)
    path = tmp_path / f"omnidata_{mode}.ckpt"
    torch.save(ckpt, path)
    est_t = dpt.DPTEstimator.from_checkpoint(path, mode, dpt.TINY_DPT,
                                             device="cpu")
    est_j = dpt_j.DPTEstimator.from_checkpoint(str(path), mode,
                                               dpt_j.TINY_DPT)
    rgb = np.random.default_rng(4).uniform(0, 1, (2, 40, 40, 3)).astype(
        np.float32)
    w = np.random.default_rng(5).standard_normal(
        (2, 40, 40, 1 if mode == "depth" else 3)).astype(np.float32)

    def f_j(r):
        out = est_j.estimate(r)
        return jnp.sum(out * w), out

    (_, want), g_j = jax.jit(jax.value_and_grad(f_j, has_aux=True))(
        jnp.asarray(rgb))
    x = t(rgb).requires_grad_(True)
    got = est_t.estimate(x)
    assert got.shape == w.shape
    _close(got.detach().numpy(), want, mode)
    # the gradient through the estimator into its input
    (got * t(w)).sum().backward()
    _close(x.grad.numpy(), g_j, f"{mode} grad")


LR = dict(mean=0.005, svec=0.003, qvec=0.003, color=0.01, alpha=0.003,
          bg=0.003)


@pytest.mark.parametrize("mode", ["depth", "normal"])
def test_estimator_trainer_step_matches_jax(mode):
    """One step with one estimator at weight 0.5 (mock guidance, 32²,
    batch 2): the estimator loss and every field's gradient.  The normal
    estimator turns render_normal on (8 composited features)."""
    _, m_t, (m_j, p_j) = _pair(mode, seed=6)
    est = {mode: {"enabled": True, "value": 0.5}}
    kw = dict(max_steps=100, batch_size=2, lr=LR, estimators=est)
    rkw = dict(tile_size=8, chunk=128, dup_cap=4096)
    init = dict(num_points=96, capacity=128, svec_val=0.05, mean_std=0.4)
    data = dict(batch_size=2, max_steps=100, reso=(32,),
                camera_distance=(2.0, 2.5))
    tj = TrainerJ(cfg=TcfgJ(**kw),
                  rcfg=RenderJ(backend="pallas", pallas_interpret=True,
                               mxu_scans=False, fast_fwd_cumprod=False,
                               **rkw),
                  init_cfg=InitJ(**init),
                  bg_cfg=BgJ(type="fixed", color=(0.1, 0.6, 0.3)),
                  data_cfg=CamJ(**data), guidance=MockJ(),
                  dcfg=DensJ(enabled=False), pcfg=PruneJ(enabled=False),
                  estimators={mode: dpt_j.DPTEstimator(m_j, p_j, mode)})
    tt = Trainer(cfg=TrainerConfig(**kw), rcfg=RenderConfig(**rkw),
                 init_cfg=InitConfig(**init),
                 bg_cfg=BackgroundConfig(type="fixed", color=(0.1, 0.6, 0.3)),
                 data_cfg=CameraSamplerConfig(**data),
                 guidance=MockGuidance(), dcfg=DensifyConfig(enabled=False),
                 pcfg=PruneConfig(enabled=False),
                 estimators={mode: dpt.DPTEstimator(m_t, mode)},
                 device="cpu")
    assert tt.rcfg.render_normal == tj.rcfg.render_normal == (
        mode == "normal")
    raw = scene3d(96, seed=11, capacity=128, mean_std=0.4)
    tj.state = tj.state._replace(scene=tj.state.scene._replace(
        params=GaussianParams(**{f: jnp.asarray(raw[f]) for f in FIELDS})))
    tt.state = train_state_from_jax_arrays(_flatten_with_paths(tj.state),
                                           "cpu")
    assert tt.sched_scalars(0)[f"w_est_{mode}"] == 0.5
    m_j, m_t = tj.train_step(0), tt.train_step(0)
    key = f"loss_est_{mode}"
    assert float(m_t[key]) > 0
    for k in (key, "loss_sds", "loss_total"):
        np.testing.assert_allclose(float(m_t[k]), float(m_j[k]), rtol=1e-4,
                                   err_msg=k)
    arrays = _flatten_with_paths(tj.state)
    for f in FIELDS:
        mu_j = arrays[f".opt/.mu/[0]/.{f}"]
        np.testing.assert_allclose(tt.state.opt.mu[f].numpy(), mu_j,
                                   rtol=2e-3, atol=2e-4 * np.abs(mu_j).max(),
                                   err_msg=f)


def test_estimators_block_builds_only_enabled(tmp_path):
    """Disabled entries are configuration only; an enabled one without a
    checkpoint raises."""
    base = dict(max_steps=10, batch_size=1)
    kw = dict(rcfg=RenderConfig(tile_size=8, chunk=128, dup_cap=4096),
              init_cfg=InitConfig(num_points=16, capacity=16),
              bg_cfg=BackgroundConfig(type="fixed"),
              data_cfg=CameraSamplerConfig(batch_size=1, reso=(16,)),
              device="cpu")
    tr = Trainer(cfg=TrainerConfig(**base, estimators={
        "depth": {"enabled": False, "checkpoint": None},
        "normal": {"enabled": False}}), **kw)
    assert tr.estimators == {} and not tr.rcfg.render_normal
    with pytest.raises(ValueError, match="checkpoint"):
        Trainer(cfg=TrainerConfig(**base, estimators={
            "depth": {"enabled": True}}), **kw)
