"""gsgen_torch's Point-E (the text-vec transformer, the upsampler, the
auxiliary SDS on the Gaussian means, the two-stage Karras sampler and the
text -> cloud init) against the JAX package.

Inputs are numpy arrays from a seed handed to both packages; weights are
the JAX models' random parameters carried across by name
(``flax_to_torch_state``), or a random upstream-layout state dict saved
with ``torch.save`` that both packages load, with ``output_proj`` filled
(a fresh model predicts exactly 0).  Where the JAX code draws from a key,
the test repeats its draws and hands them to the port.

Tolerances: timestep embeddings atol 2e-4 (an ulp of exp moves args of
up to 1e3 rad by ~1e-4); transformer outputs atol 2e-5 of their largest
value (fp32, LayerNorm and matmul summation order); the aux loss rtol
1e-4 and its gradients atol 1e-4 of their largest value (CFG 100 scales
the eps difference); sampler stages atol 1e-4 of their largest value
(eight Heun steps, clip and CFG 3); FPS indices, the Heun constants and
the init arrays exactly; the corgi.yaml trainer step as
tests/test_torch_trainer.py (losses rtol 1e-4, Adam first moments rtol
2e-3 / atol 2e-4 of each field's largest).
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gsgen_tpu.priors as priors_j
from gsgen_tpu.config import build_trainer as build_trainer_j
from gsgen_tpu.config import load_config as load_config_j
from gsgen_tpu.guidance import point_e as pe_j
from gsgen_tpu.guidance import point_e_aux as aux_j
from gsgen_tpu.io.checkpoint import _flatten_with_paths
from gsgen_tpu.models.scene import GaussianParams
from gsgen_tpu.priors import point_e_sampler as samp_j
from gsgen_tpu.utils.ops import farthest_point_sampling as fps_j
from gsgen_torch import main as main_mod
from gsgen_torch import priors
from gsgen_torch.config import build_trainer, load_config
from gsgen_torch.guidance import convert
from gsgen_torch.guidance import point_e as pe
from gsgen_torch.guidance import point_e_aux as aux
from gsgen_torch.models.scene import FIELDS
from gsgen_torch.priors import point_e_sampler as samp
from gsgen_torch.training.trainer import train_state_from_jax_arrays
from gsgen_torch.utils.ops import farthest_point_sampling
from torch_fixtures import scene3d, t

ROOT = Path(__file__).resolve().parents[1]
CORGI = ROOT / "configs" / "corgi.yaml"
SMALL = ["init.num_points=96", "init.capacity=128", "data.reso=[32]",
         "renderer.tile_size=8", "renderer.chunk=128",
         "renderer.dup_cap=4096", "trainer.batch_size=2",
         "prompt.use_cache=false", "guidance.type=mock",
         "auxiliary.base_name=tiny", "auxiliary.num_points=32",
         "auxiliary.batch_size=2"]
# the JAX render on its exact path (the port accepts these keys and always
# runs the exact scans) and a fixed background
EXACT = ["renderer.backend=pallas", "renderer.pallas_interpret=true",
         "renderer.mxu_scans=false", "renderer.fast_fwd_cumprod=false",
         "renderer.background.type=fixed"]


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _fill_output_proj(params, seed, std=0.05):
    """A JAX Point-E param tree with ``output_proj`` drawn from a seed."""
    params = _np(params)
    rng = np.random.default_rng(seed)
    proj = params["params"]["output_proj"]
    for k in proj:
        proj[k] = (rng.standard_normal(proj[k].shape) * std).astype(
            np.float32)
    return params


def _close(got, want, share, what=""):
    scale = float(np.abs(want).max())
    assert scale > 0, what
    np.testing.assert_allclose(got, want, rtol=0, atol=share * scale,
                               err_msg=what)


@pytest.fixture(scope="module")
def tiny_pair():
    """The JAX TINY base model with output_proj filled, and the port's
    model on its parameters."""
    m_j = pe_j.PointEModel(pe_j.TINY_POINT_E, key=jax.random.PRNGKey(1))
    m_j.params = _fill_output_proj(m_j.params, 2)
    m_t = pe.PointEModel(pe.TINY_POINT_E, device="cpu").load_weights(
        convert.flax_to_torch_state(m_j.params))
    return m_j, m_t


@pytest.fixture(scope="module")
def tiny_up_pair():
    m_j = pe_j.PointEUpsamplerModel(pe_j.TINY_UPSAMPLE,
                                    key=jax.random.PRNGKey(3))
    m_j.params = _fill_output_proj(m_j.params, 4)
    m_t = pe.PointEUpsamplerModel(pe.TINY_UPSAMPLE, device="cpu"
                                  ).load_weights(
        convert.flax_to_torch_state(m_j.params))
    return m_j, m_t


@pytest.mark.parametrize("dim", [32, 33, 512])
def test_timestep_embedding(dim):
    tt = np.array([0, 1, 17, 500, 1023], np.float32)
    np.testing.assert_allclose(
        pe.point_e_timestep_embedding(t(tt), dim).numpy(),
        np.asarray(pe_j.point_e_timestep_embedding(jnp.asarray(tt), dim)),
        rtol=0, atol=2e-4)


def test_jax_params_map_onto_the_port_by_name(tiny_pair, tiny_up_pair):
    """flax_to_torch_state's names (resblocks_N, clip_embed_0/1, ln_1/2,
    c_fc/c_qkv/c_proj) are the port modules' state dict, shape for
    shape, with kernels transposed."""
    for m_j, m_t in (tiny_pair, tiny_up_pair):
        state = convert.flax_to_torch_state(_np(m_j.params))
        mine = m_t.module.state_dict()
        assert sorted(state) == sorted(mine)
        for k, v in state.items():
            assert tuple(v.shape) == tuple(mine[k].shape), k
            np.testing.assert_array_equal(mine[k].numpy(), v, err_msg=k)
    names = set(tiny_up_pair[1].module.state_dict())
    assert {"backbone.resblocks.1.attn.c_qkv.weight", "clip_embed.0.weight",
            "clip_embed.1.bias", "backbone.resblocks.0.ln_2.bias",
            "backbone.resblocks.0.mlp.c_fc.weight"} <= names


def _inputs(n, seed, C=6, B=2):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, C, n)).astype(np.float32)
    tt = np.array([3.0, 700.0], np.float32)[:B]
    return x, tt, rng


def test_transformer_forward_matches_jax(tiny_pair, tiny_up_pair):
    m_j, m_t = tiny_pair
    x, tt, rng = _inputs(32, 0)
    cond = rng.standard_normal((2, 16)).astype(np.float32)
    want = np.asarray(jax.jit(m_j.apply)(m_j.params, jnp.asarray(x),
                                         jnp.asarray(tt), jnp.asarray(cond)))
    got = m_t.apply(t(x), t(tt), t(cond)).numpy()
    assert got.shape == (2, 12, 32)
    _close(got, want, 2e-5, "base")
    u_j, u_t = tiny_up_pair
    x, tt, rng = _inputs(64, 1)
    low = rng.uniform(-1, 255, (2, 6, 32)).astype(np.float32)
    want = np.asarray(jax.jit(u_j.apply)(u_j.params, jnp.asarray(x),
                                         jnp.asarray(tt),
                                         low_res=jnp.asarray(low)))
    got = u_t.apply(t(x), t(tt), t(low)).numpy()
    assert got.shape == (2, 12, 64)
    _close(got, want, 2e-5, "upsample")


def _upstream_state(module, seed, extra):
    """A random state dict in the upstream layout of ``module`` plus the
    upstream keys the models drop (the CLIP tower, channel buffers)."""
    rng = np.random.default_rng(seed)
    state = {k: (rng.standard_normal(v.shape) * 0.2).astype(np.float32)
             for k, v in module.state_dict().items()}
    for k in extra:
        state[k] = rng.standard_normal((3, 4)).astype(np.float32)
    return state


@pytest.mark.parametrize("stage", ["base", "upsample"])
def test_upstream_pt_state_dict_loads_in_both(tmp_path, stage):
    if stage == "base":
        m_t = pe.PointEModel(pe.TINY_POINT_E, device="cpu")
        m_j = pe_j.PointEModel(pe_j.TINY_POINT_E)
        extra = ["clip.model.positional_embedding"]
    else:
        m_t = pe.PointEUpsamplerModel(pe.TINY_UPSAMPLE, device="cpu")
        m_j = pe_j.PointEUpsamplerModel(pe_j.TINY_UPSAMPLE)
        extra = ["clip.model.proj", "channel_scales", "channel_biases"]
    state = _upstream_state(m_t.module, 5, extra)
    path = tmp_path / f"{stage}.pt"
    torch.save({k: torch.from_numpy(v) for k, v in state.items()}, path)
    m_t.load_weights(str(path))
    m_j.load_weights(dict(state))
    # both ways: the JAX tree maps back onto the file's keys, bitwise
    back = convert.flax_to_torch_state(_np(m_j.params))
    kept = {k: v for k, v in state.items() if k not in extra}
    assert sorted(back) == sorted(kept)
    for k, v in kept.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
        np.testing.assert_array_equal(m_t.module.state_dict()[k].numpy(), v)
    x, tt, rng = _inputs(m_t.cfg.n_ctx, 6)
    if stage == "base":
        cond = rng.standard_normal((2, 16)).astype(np.float32)
        want = jax.jit(m_j.apply)(m_j.params, jnp.asarray(x),
                                  jnp.asarray(tt), jnp.asarray(cond))
        got = m_t.apply(t(x), t(tt), t(cond))
    else:
        low = rng.uniform(0, 1, (2, 6, 32)).astype(np.float32)
        want = jax.jit(m_j.apply)(m_j.params, jnp.asarray(x),
                                  jnp.asarray(tt), low_res=jnp.asarray(low))
        got = m_t.apply(t(x), t(tt), t(low))
    _close(got.numpy(), np.asarray(want), 2e-5, stage)
    with pytest.raises(FileNotFoundError, match="no .safetensors"):
        m_t.load_weights(str(tmp_path / "w.safetensors"))


@pytest.mark.parametrize("D", [1024, 16])
def test_predict_noise_pools_a_sequence(tiny_pair, D):
    """A [B, L, D] embedding is mean-pooled; at D != clip_feature_dim (the
    port's mock prompt embeddings: 1024 vs 16 here, 768 at full width) the
    pooled vector is dropped for zeros."""
    m_j, m_t = tiny_pair
    x, tt, rng = _inputs(32, 7)
    seq = rng.standard_normal((2, 5, D)).astype(np.float32)
    want = np.asarray(jax.jit(m_j.predict_noise)(
        m_j.params, jnp.asarray(x), jnp.asarray(tt), jnp.asarray(seq)))
    got = m_t.predict_noise(t(x), t(tt), t(seq)).numpy()
    _close(got, want, 2e-5, f"D={D}")
    zeros = m_t.predict_noise(t(x), t(tt), None).numpy()
    assert np.array_equal(got, zeros) == (D == 1024)


@pytest.mark.parametrize("masked", [False, True])
def test_fps_indices_match_jax(masked):
    rng = np.random.default_rng(8)
    pts = rng.standard_normal((300, 3)).astype(np.float32)
    mask = rng.uniform(size=300) < 0.6
    mask[:5] = False                       # the start is not row 0
    want = np.asarray(fps_j(jnp.asarray(pts), 64,
                            mask=jnp.asarray(mask) if masked else None))
    got = farthest_point_sampling(t(pts), 64,
                                  mask=t(mask) if masked else None)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    if masked:
        assert got[0] == np.argmax(mask) and mask[got.numpy()].all()


AUX_CASES = [("mock", True, "sds", False), ("mock", False, "uniform", True),
             ("tiny", True, "sds", False), ("tiny", False, "fantasia", False)]


@pytest.mark.parametrize("model,mean_only,weighting,normalize", AUX_CASES)
def test_aux_loss_and_grads_match_jax(tiny_pair, model, mean_only, weighting,
                                      normalize):
    kw = dict(num_points=48, batch_size=3, mean_only=mean_only,
              weighting_strategy=weighting, normalize=normalize)
    if model == "mock":
        mj = aux_j.MockPointDiffusion()
        mt = aux.MockPointDiffusion.from_jax_params(_np(mj.params), "cpu")
    else:
        mj, mt = tiny_pair
    g_j = aux_j.PointEAuxGuidance(aux_j.PointEAuxConfig(**kw), model=mj)
    g_t = aux.PointEAuxGuidance(aux.PointEAuxConfig(**kw), model=mt,
                                device="cpu")
    rng = np.random.default_rng(9)
    M = 160
    mean = rng.standard_normal((M, 3)).astype(np.float32) * 0.7
    color = rng.uniform(0, 1, (M, 3)).astype(np.float32)
    active = np.arange(M) < 120
    active[:3] = False
    text = rng.standard_normal((7, 1024)).astype(np.float32)
    key = jax.random.PRNGKey(21)

    def loss_j(m, c):
        return g_j.loss(g_j.params, m, c, jnp.asarray(active),
                        jnp.asarray(text), key)["loss_aux"]

    val, (gm, gc) = jax.jit(jax.value_and_grad(loss_j, argnums=(0, 1)))(
        jnp.asarray(mean), jnp.asarray(color))
    _, k_t, k_n = jax.random.split(key, 3)
    tt = jax.random.randint(k_t, (3,), 20, 1003)
    noise = jax.random.normal(k_n, (3, 6, 48))

    m, c = t(mean).requires_grad_(True), t(color).requires_grad_(True)
    out = g_t.loss(m, c, t(active), t(text), t=t(tt).long(), noise=t(noise))
    out["loss_aux"].backward()
    np.testing.assert_allclose(float(out["loss_aux"].detach()), float(val),
                               rtol=1e-4)
    _close(m.grad.numpy(), np.asarray(gm), 1e-4, "mean")
    if mean_only:
        assert c.grad is None and not np.asarray(gc).any()
    else:
        _close(c.grad.numpy(), np.asarray(gc), 1e-4, "color")
    assert not m.grad[~t(active)].any()


@pytest.mark.parametrize("schedule,churn", [("cosine", 3.0), ("linear", 0.0)])
def test_karras_sigmas_and_heun_constants(schedule, churn):
    s_j = samp_j.NoiseSchedule.named(schedule)
    s_t = samp.NoiseSchedule.named(schedule)
    np.testing.assert_array_equal(s_t.alphas_cumprod, s_j.alphas_cumprod)
    sig_j = samp_j.karras_sigmas(64, 1e-3, 160.0)
    sig_t = samp.karras_sigmas(64, 1e-3, 160.0)
    np.testing.assert_array_equal(sig_t, sig_j)
    c_j = samp_j.heun_step_constants(s_j, sig_j, churn)
    c_t = samp.heun_step_constants(s_t, sig_t, churn)
    assert sorted(c_j) == sorted(c_t)
    for k in c_j:
        assert c_t[k].dtype == np.float32, k
        np.testing.assert_array_equal(c_t[k], np.asarray(c_j[k]), err_msg=k)
    assert (c_t["noise_scale"] > 0).any() == (churn > 0)


def _jax_churn_noises(key, steps, shape):
    """The JAX stage sampler's per-step draws: one split a Heun step, one
    for the epilogue."""
    out = []
    for _ in range(steps):
        key, k = jax.random.split(key)
        out.append(torch.from_numpy(np.array(jax.random.normal(k, shape))))
    return out


@pytest.mark.parametrize("stage", ["base", "upsample"])
def test_stage_sampler_matches_jax(tiny_pair, tiny_up_pair, stage):
    """8 Karras-Heun steps: the base stage with churn 3 and CFG 3 on a
    text vector, the upsample stage unguided on a low-res cloud.  At 3-4
    steps from sigma 120 the float32 rounding of either package alone
    moves the result by up to 3e-3 from a float64 run of the same steps;
    at 8, by 2e-5."""
    steps, key = 8, jax.random.PRNGKey(13)
    rng = np.random.default_rng(10)
    if stage == "base":
        m_j, m_t = tiny_pair
        args = (steps, 1e-3, 120.0, 3.0, 3.0, "cosine")
        s_j, smax = samp_j.make_stage_sampler(
            lambda p, x, tt, cond=None, low_res=None:
                m_j.apply(p, x, tt, cond=cond), *args)
        s_t, smax_t = samp.make_stage_sampler(
            lambda x, tt, cond=None, low_res=None:
                m_t.apply(x, tt, cond=cond), *args)
        vec = rng.standard_normal((2, 16)).astype(np.float32)
        cond = np.concatenate([vec, np.zeros_like(vec)])
        x_T = (rng.standard_normal((2, 6, 32)) * smax).astype(np.float32)
        low = None
    else:
        m_j, m_t = tiny_up_pair
        args = (steps, 1e-3, 160.0, 0.0, 0.0, "linear")
        s_j, smax = samp_j.make_stage_sampler(
            lambda p, x, tt, cond=None, low_res=None:
                m_j.apply(p, x, tt, low_res=low_res), *args)
        s_t, smax_t = samp.make_stage_sampler(
            lambda x, tt, cond=None, low_res=None:
                m_t.apply(x, tt, low_res), *args)
        cond = None
        x_T = (rng.standard_normal((1, 6, 64)) * smax).astype(np.float32)
        low = rng.uniform(-0.5, 255, (1, 6, 32)).astype(np.float32)
    assert smax_t == smax
    want = np.asarray(s_j(m_j.params, jnp.asarray(x_T),
                          None if cond is None else jnp.asarray(cond),
                          None if low is None else jnp.asarray(low), key))
    noises = _jax_churn_noises(key, steps, x_T.shape)
    got = s_t(t(x_T), None if cond is None else t(cond),
              None if low is None else t(low), noises=noises).numpy()
    _close(got, want, 1e-4, stage)
    # the churn draws come from a generator when none are handed in
    g = torch.Generator().manual_seed(0)
    assert np.isfinite(s_t(t(x_T), None if cond is None else t(cond),
                           None if low is None else t(low),
                           generator=g).numpy()).all()


@pytest.fixture
def asset_dir(tmp_path, monkeypatch):
    """A temporary GSGEN_ASSET_DIR for both packages (the JAX package reads
    it when imported, the port when called)."""
    d = tmp_path / "assets"
    monkeypatch.setenv("GSGEN_ASSET_DIR", str(d))
    monkeypatch.setattr(priors_j, "ASSET_DIR", str(d))
    for k in ("GSGEN_POINT_E_BASE", "GSGEN_POINT_E_UPSAMPLE",
              "GSGEN_CLIP_DIR"):
        monkeypatch.delenv(k, raising=False)
    return d


def _write_asset(prompt, n, seed=0):
    rng = np.random.default_rng(seed)
    p = priors._asset_path(prompt)
    assert p == priors_j._asset_path("point_e", prompt)
    p.parent.mkdir(parents=True, exist_ok=True)
    xyz = (rng.standard_normal((n, 3)) * 0.4 + 0.1).astype(np.float32)
    rgb = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    np.savez(p, xyz=xyz, rgb=rgb)
    return xyz, rgb


@pytest.mark.parametrize("num_points,random_exceed", [(5000, False),
                                                      (5000, True),
                                                      (3000, False)])
def test_point_e_init_arrays_from_asset(asset_dir, num_points,
                                        random_exceed):
    _write_asset("a corgi", 4096)
    kw = dict(num_points=num_points, mean_std=0.8, z_scale=0.5,
              random_exceed=random_exceed, seed=3)
    xyz_j, rgb_j = priors_j.point_e_init_arrays("a corgi", **kw)
    xyz_t, rgb_t = priors.point_e_init_arrays("a corgi", **kw)
    assert xyz_t.shape == (num_points, 3)
    np.testing.assert_array_equal(xyz_t, xyz_j)
    np.testing.assert_array_equal(rgb_t, rgb_j)


def test_point_e_generate_resolution(asset_dir, tmp_path):
    """No asset and no checkpoint: the JAX package's FileNotFoundError;
    CLIP conditioning raises; TINY checkpoints sample in process (3 + 3
    steps), write the cache, which both packages then read."""
    with pytest.raises(FileNotFoundError) as e_t:
        priors.point_e_generate("a fox")
    with pytest.raises(FileNotFoundError) as e_j:
        priors_j.point_e_generate("a fox")
    assert str(e_t.value) == str(e_j.value)
    paths = {}
    for name, model in (("base", pe.PointEModel(pe.TINY_POINT_E, "cpu")),
                        ("up", pe.PointEUpsamplerModel(pe.TINY_UPSAMPLE,
                                                       "cpu"))):
        paths[name] = tmp_path / f"{name}.pt"
        torch.save(model.module.state_dict(), paths[name])
    kw = dict(base_weights=str(paths["base"]),
              upsample_weights=str(paths["up"]), karras_steps=(3, 3),
              base_cfg=pe.TINY_POINT_E, up_cfg=pe.TINY_UPSAMPLE,
              device="cpu")
    with pytest.raises(FileNotFoundError, match="no .safetensors"):
        priors.point_e_generate("a fox", clip_model_dir="/nowhere", **kw)
    xyz, rgb = priors.point_e_generate("a fox", **kw)
    assert xyz.shape == (32 + 64, 3) and rgb.shape == xyz.shape
    assert np.isfinite(xyz).all() and (rgb >= 0).all() and (rgb <= 1).all()
    cached = priors._asset_path("a fox")
    assert cached.exists()
    for again in (priors.point_e_generate("a fox", num_points=50),
                  priors_j.point_e_generate("a fox", num_points=50)):
        np.testing.assert_array_equal(again[0], xyz[:50])
        np.testing.assert_array_equal(again[1], rgb[:50])


@pytest.mark.parametrize("random_color", [True, False])
def test_config_point_e_init_matches_jax(asset_dir, random_color):
    """init.type=point_e -> the asset's arrays -> a point_cloud scene with
    the facex rotation; colours from the asset unless random_color."""
    _write_asset("A high quality photo of a furry corgi", 4096, seed=4)
    over = SMALL + ["init.type=point_e", f"init.random_color={random_color}"]
    tj = build_trainer_j(load_config_j(CORGI, over + EXACT))
    tt = build_trainer(load_config(CORGI, over + EXACT), device="cpu")
    sj, st = tj.state.scene, tt.state.scene
    np.testing.assert_array_equal(st.active.numpy(), np.asarray(sj.active))
    np.testing.assert_allclose(st.params["mean"].numpy(),
                               np.asarray(sj.params.mean), rtol=0, atol=0)
    if not random_color:
        np.testing.assert_allclose(st.params["color"].numpy(),
                                   np.asarray(sj.params.color), rtol=1e-6,
                                   atol=1e-6)


def test_config_auxiliary_block(asset_dir):
    tr = build_trainer(load_config(CORGI, SMALL), device="cpu")
    assert isinstance(tr.aux_guidance, aux.PointEAuxGuidance)
    assert isinstance(tr.aux_guidance.model, pe.PointEModel)
    assert tr.aux_guidance.cfg.guidance_scale == 100.0
    assert tr.sched_scalars(0)["w_aux"] == 0.01
    with pytest.raises(NotImplementedError):
        build_trainer(load_config(CORGI, SMALL + ["auxiliary.type=shap_e"]),
                      device="cpu")
    # the image-to-3D block and the CLIP text vector are ported: a missing
    # image file or CLIP directory raises
    for bad in (["init.type=point_e"], ["image.path=/nowhere/a.png"],
                ["auxiliary.clip_model_id=/nowhere/clip"]):
        with pytest.raises(FileNotFoundError):
            build_trainer(load_config(CORGI, SMALL + bad), device="cpu")
    with pytest.raises(KeyError, match="init_asset"):
        build_trainer(load_config(CORGI, SMALL + ["init.type=point_cloud"]),
                      device="cpu")


def test_corgi_trainer_step_matches_jax():
    """One build_trainer step of configs/corgi.yaml (mock guidance, the
    TINY Point-E aux at weight 0.01, 32²): losses and every field's
    gradient (Adam's first moment after one step, 0.1 x the gradient)."""
    tj = build_trainer_j(load_config_j(CORGI, SMALL + EXACT))
    tj.aux_guidance.params = _fill_output_proj(tj.aux_guidance.params, 12,
                                               std=0.5)
    # anisotropic, rotated Gaussians (the base init's rotation gradient is
    # zero up to rounding)
    raw = scene3d(96, seed=11, capacity=128, mean_std=0.4)
    tj.state = tj.state._replace(scene=tj.state.scene._replace(
        params=GaussianParams(**{f: jnp.asarray(raw[f]) for f in FIELDS})))
    tt = build_trainer(load_config(CORGI, SMALL + EXACT), device="cpu")
    tt.aux_guidance.model.load_weights(
        convert.flax_to_torch_state(tj.aux_guidance.params))
    tt.state = train_state_from_jax_arrays(_flatten_with_paths(tj.state),
                                           "cpu")
    # the JAX step's aux draws: state.key -> k_loop -> keys[0] -> k_g
    _, k_loop = jax.random.split(tj.state.key)
    _, k_g = jax.random.split(jax.random.split(k_loop, 1)[0])
    _, k_t, k_n = jax.random.split(k_g, 3)
    B = 2
    tt_aux = jax.random.randint(k_t, (B,), 20, 1003)
    noise = jax.random.normal(k_n, (B, 6, 32))
    loss_t = tt.aux_guidance.loss

    def injected(*a, generator=None):
        return loss_t(*a, t=t(tt_aux).long(), noise=t(noise))

    tt.aux_guidance.loss = injected
    m_j, m_t = tj.train_step(0), tt.train_step(0)
    assert float(m_t["loss_aux"]) > 0
    for k in ("loss_sds", "loss_aux", "loss_sparsity", "loss_total"):
        np.testing.assert_allclose(float(m_t[k]), float(m_j[k]), rtol=1e-4,
                                   err_msg=k)
    arrays = _flatten_with_paths(tj.state)
    for f in FIELDS:
        mu_j = arrays[f".opt/.mu/[0]/.{f}"]
        np.testing.assert_allclose(tt.state.opt.mu[f].numpy(), mu_j,
                                   rtol=2e-3, atol=2e-4 * np.abs(mu_j).max(),
                                   err_msg=f)


def test_main_runs_corgi_on_cpu(asset_dir, capsys):
    assert main_mod.main(["--config", str(CORGI), "--steps", "2",
                          "--device", "cpu", "--no-log", *SMALL]) == 0
