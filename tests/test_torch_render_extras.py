"""gsgen_torch's render extras vs the JAX package: SH colour, ray
directions, the learned_const / mlp backgrounds and random_aug, estimated
and learned normals, PBR shading, render_view with sh_degree,
normal_as_rgb, pbr and render_normal (F = 8, both layouts), the seven
penalties, densify / prune carrying the PBR fields, mock ``scene`` mode,
trainer steps of PBR + learned_const + random_aug + every penalty and of
the four preset overlays, and checkpoints with PBR fields and an MLP
background both ways.

Same numpy inputs into both packages (RES 32, TILE 8, CHUNK 128); the JAX
side renders with its Pallas kernels in interpret mode on the exact scans;
the port runs its kernels' plain versions on CPU tensors.  Random draws
are replayed from the JAX keys and injected.  Tolerances are stated in
each test: elementwise maths rtol 1e-5 / atol 1e-6; renders as in
``test_torch_scene.py`` (images rtol 1e-4 / atol 1e-5, gradients rtol
2e-3 / atol 2e-4 of each field's largest).  Normals go through a batched
3x3 ``eigh`` (LAPACK in both packages, different builds): values atol
1e-5, gradients rtol 2e-3 / atol 1e-3 of the largest, on well-conditioned
clouds (points on a sphere).
"""

import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsgen_tpu.config import build_trainer as build_trainer_j
from gsgen_tpu.guidance.mock import MockGuidance as MockJ
from gsgen_tpu.io import checkpoint as ckpt_j
from gsgen_tpu.models import background as bg_j
from gsgen_tpu.models import density as dens_j
from gsgen_tpu.models import scene as scene_j
from gsgen_tpu.ops import camera as cam_j
from gsgen_tpu.ops import sh as sh_j
from gsgen_tpu.training import losses as losses_j
from gsgen_tpu.training.optimizer import AdamState as AdamJ
from gsgen_tpu.utils import ops as ops_j
from gsgen_torch.config import build_trainer, load_config
from gsgen_torch.data.cameras import CameraPoseProvider, CameraSamplerConfig
from gsgen_torch.guidance.mock import MockGuidance
from gsgen_torch.io import checkpoint as ckpt_t
from gsgen_torch.models import background as bg_t
from gsgen_torch.models import density as dens_t
from gsgen_torch.models import scene as scene_t
from gsgen_torch.ops import camera as cam_t
from gsgen_torch.ops import sh as sh_t
from gsgen_torch.training import losses as losses_t
from gsgen_torch.training import trainer as trainer_mod
from gsgen_torch.training.optimizer import AdamState
from gsgen_torch.training.trainer import train_state_from_jax_arrays
from gsgen_torch.utils import ops as ops_t
from torch_fixtures import CHUNK, RES, TILE, scene3d, t

ROOT = Path(__file__).resolve().parents[1]
KW = dict(tile_size=TILE, chunk=CHUNK, dup_cap=4096)
EXACT_J = dict(backend="pallas", pallas_interpret=True, mxu_scans=False,
               fast_fwd_cumprod=False)
FIELDS = scene_t.FIELDS
ALL_FIELDS = FIELDS + scene_t.OPTIONAL_FIELDS


def _close(a, b, rtol=1e-5, atol=1e-6, what=""):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol,
                               atol=atol, err_msg=what)


def _close_grad(a, b, rtol=2e-3, atol=2e-4, what=""):
    """Gradients: atol relative to the reference's largest entry."""
    b = np.asarray(b)
    scale = max(float(np.abs(b).max()), 1e-6)
    np.testing.assert_allclose(np.asarray(a), b, rtol=rtol,
                               atol=atol * scale, err_msg=what)


def _batch(B, seed):
    cfg = CameraSamplerConfig(batch_size=B, reso=(RES,),
                              camera_distance=(2.0, 2.5))
    return CameraPoseProvider(cfg, seed=seed).get_batch()


def _sphere(n, seed, capacity=None, radius=0.7):
    """scene3d with its live means on a sphere: well-conditioned normals."""
    raw = scene3d(n, seed=seed, capacity=capacity, svec=0.04)
    v = np.random.default_rng(seed + 100).standard_normal((n, 3))
    raw["mean"][:n] = (radius * v / np.linalg.norm(v, axis=1,
                                                   keepdims=True))
    return raw


def _with_pbr(raw, seed):
    """Raw specular and normal fields beside a scene3d scene."""
    rng = np.random.default_rng(seed)
    m = raw["mean"].shape[0]
    raw = dict(raw)
    raw["specular"] = rng.normal(-2.0, 0.5, (m, 3)).astype(np.float32)
    raw["normal"] = rng.standard_normal((m, 3)).astype(np.float32)
    return raw


def _params_j(raw):
    return scene_j.GaussianParams(**{f: jnp.asarray(raw[f]) for f in
                                     ALL_FIELDS if f in raw})


# -- SH, rays ------------------------------------------------------------

@pytest.mark.parametrize("degree", [1, 2, 3, 4, 5])
def test_sh_basis_and_color_match_jax(degree):
    """Values rtol 1e-5 / atol 1e-6; gradients of a weighted sum wrt the
    coefficients and the directions the same, of their largest."""
    rng = np.random.default_rng(degree)
    d = rng.standard_normal((64, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    K = degree * degree
    co = rng.standard_normal((64, 3, K)).astype(np.float32)
    w = rng.standard_normal((64, 3)).astype(np.float32)
    _close(sh_t.eval_sh_basis(t(d), degree).numpy(),
           sh_j.eval_sh_basis(jnp.asarray(d), degree))
    (gc_j, gd_j) = jax.grad(lambda c, x: jnp.sum(
        sh_j.eval_sh_color(c, x) * w), argnums=(0, 1))(jnp.asarray(co),
                                                        jnp.asarray(d))
    c_t, d_t = t(co).requires_grad_(True), t(d).requires_grad_(True)
    col = sh_t.eval_sh_color(c_t, d_t)
    (col * t(w)).sum().backward()
    _close(col.detach().numpy(),
           sh_j.eval_sh_color(jnp.asarray(co), jnp.asarray(d)))
    _close_grad(c_t.grad.numpy(), gc_j, 1e-5, 1e-6, "coeffs")
    if degree == 1:                 # the constant band: no direction
        assert d_t.grad is None and float(jnp.abs(gd_j).max()) == 0.0
    else:
        _close_grad(d_t.grad.numpy(), gd_j, 1e-5, 1e-6, "dirs")
    with pytest.raises(ValueError):
        sh_t.eval_sh_basis(t(d), 6)


@pytest.mark.parametrize("square", [True, False])
def test_get_rays_d_matches_jax(square):
    """[H, W, 3] unnormalized directions, rtol 1e-5 / atol 1e-6."""
    intr_kw = (dict(fx=32.0, fy=32.0, cx=16.0, cy=16.0, w=32, h=32) if square
               else dict(fx=20.5, fy=24.0, cx=15.5, cy=12.25, w=31, h=24))
    c2w = _batch(1, seed=3)["c2w"][0]
    want = cam_j.get_rays_d(jnp.asarray(c2w), cam_j.CameraIntrinsics(**intr_kw))
    got = cam_t.get_rays_d(t(c2w), cam_t.CameraIntrinsics(**intr_kw))
    assert tuple(got.shape) == (intr_kw["h"], intr_kw["w"], 3)
    _close(got.numpy(), want)


# -- backgrounds -----------------------------------------------------------

MLP_CFG = dict(type="mlp", sh_degree=3, hidden=16, n_layers=2)


def _rays():
    c2w = _batch(1, seed=4)["c2w"][0]
    return np.asarray(cam_j.get_rays_d(jnp.asarray(c2w),
                                       cam_j.CameraIntrinsics.from_reso(RES)))


def test_mlp_background_matches_jax():
    """The JAX init's weights carried across; the [H, W, 3] image rtol
    1e-5 / atol 1e-6, gradients wrt every weight rtol 1e-4 / atol 1e-6 of
    the largest.  The port's own init: He-normal weights, zero biases."""
    cfg_j, cfg_t = bg_j.BackgroundConfig(**MLP_CFG), \
        bg_t.BackgroundConfig(**MLP_CFG)
    p_j = bg_j.init_background(jax.random.PRNGKey(5), cfg_j)
    assert sorted(p_j) == ["b0", "b1", "b2", "w0", "w1", "w2"]
    dirs = _rays()
    w = np.random.default_rng(6).standard_normal((RES, RES, 3)).astype(
        np.float32)

    def f_j(p):
        return jnp.sum(bg_j.apply_background(p, cfg_j, jnp.asarray(dirs),
                                             jax.random.PRNGKey(0)) * w)

    g_j = jax.grad(f_j)(p_j)
    p_t = {k: v.requires_grad_(True) for k, v in
           bg_t.background_from_numpy(
               jax.tree_util.tree_map(np.asarray, p_j), "cpu").items()}
    img = bg_t.apply_background(p_t, cfg_t, None, "cpu", dirs=t(dirs))
    assert tuple(img.shape) == (RES, RES, 3)
    (img * t(w)).sum().backward()
    _close(img.detach().numpy(), bg_j.apply_background(
        p_j, cfg_j, jnp.asarray(dirs), jax.random.PRNGKey(0)))
    for k in p_t:
        _close_grad(p_t[k].grad.numpy(), g_j[k], 1e-4, 1e-6, k)
    own = bg_t.init_background(cfg_t, torch.Generator().manual_seed(0),
                               "cpu")
    assert {k: tuple(v.shape) for k, v in own.items()} == {
        k: tuple(v.shape) for k, v in p_j.items()}
    assert all(float(own[f"b{i}"].abs().max()) == 0.0 for i in range(3))
    np.testing.assert_allclose(float(own["w0"].std()), (2.0 / 9) ** 0.5,
                               rtol=0.25)


def test_learned_const_background_matches_jax():
    """``bg_color`` from ``initial_color``; the colour and its gradient
    exactly."""
    kw = dict(type="learned_const", initial_color=(0.2, 0.4, 0.6))
    cfg_j, cfg_t = bg_j.BackgroundConfig(**kw), bg_t.BackgroundConfig(**kw)
    p_j = bg_j.init_background(jax.random.PRNGKey(0), cfg_j)
    p_t = bg_t.init_background(cfg_t, None, "cpu")
    _close(p_t["bg_color"].numpy(), p_j["bg_color"], 0, 0)
    w = np.array([1.0, -2.0, 0.5], np.float32)
    g_j = jax.grad(lambda p: jnp.sum(bg_j.apply_background(
        p, cfg_j, None, jax.random.PRNGKey(1)) * w))(p_j)
    p = {"bg_color": p_t["bg_color"].requires_grad_(True)}
    (bg_t.apply_background(p, cfg_t, None, "cpu") * t(w)).sum().backward()
    _close(p["bg_color"].grad.numpy(), g_j["bg_color"], 0, 0)


def _jax_view_uniforms(key):
    """The uniforms the JAX ``apply_background`` draws from one view's key:
    the random colour's (k_bg) then the wrapper's (k_aug), as ``u`` [6]."""
    k_aug, k_bg = jax.random.split(key)
    return np.concatenate([np.asarray(jax.random.uniform(k_bg, (3,))),
                           np.asarray(jax.random.uniform(k_aug, (3,)))])


@pytest.mark.parametrize("kind", ["learned_const", "mlp", "random"])
def test_random_aug_matches_jax(kind):
    """The wrapper on injected draws over 24 keys at prob 0.5: the same
    background (rtol 1e-5 / atol 1e-6) and the same choice.  The model's
    background is used exactly when rand_color[0] < random_aug_prob: the
    JAX package draws the coin ``uniform(k, ())`` from the colour's key,
    which equals ``uniform(k, (3,))[0]``; both choices occur."""
    kw = dict(MLP_CFG) if kind == "mlp" else dict(type=kind)
    kw.update(random_aug=True, random_aug_prob=0.5)
    cfg_j, cfg_t = bg_j.BackgroundConfig(**kw), bg_t.BackgroundConfig(**kw)
    p_j = bg_j.init_background(jax.random.PRNGKey(2), cfg_j)
    p_t = bg_t.background_from_numpy(
        jax.tree_util.tree_map(np.asarray, p_j), "cpu")
    dirs = _rays() if kind == "mlp" else None
    used = set()
    for i in range(24):
        key = jax.random.PRNGKey(100 + i)
        want = bg_j.apply_background(p_j, cfg_j, None if dirs is None
                                     else jnp.asarray(dirs), key)
        u = _jax_view_uniforms(key)
        k_aug = jax.random.split(key)[0]
        assert float(jax.random.uniform(k_aug, ())) == u[3]
        got = bg_t.apply_background(p_t, cfg_t, None, "cpu",
                                    dirs=None if dirs is None else t(dirs),
                                    u=t(u))
        _close(got.numpy(), want, what=f"key {i}")
        model = u[3] < 0.5
        used.add(model)
        if not model:
            _close(got.numpy(), np.broadcast_to(u[3:], got.shape), 0, 0)
    assert used == {True, False}
    # eval renders skip the wrapper
    ev = bg_t.apply_background(p_t, cfg_t, None, "cpu",
                               dirs=None if dirs is None else t(dirs),
                               training=False)
    ev_j = bg_j.apply_background(p_j, cfg_j, None if dirs is None
                                 else jnp.asarray(dirs),
                                 jax.random.PRNGKey(0), training=False)
    _close(ev.numpy(), ev_j)


# -- normals, shading --------------------------------------------------------

@pytest.mark.parametrize("masked", [False, True])
def test_estimate_normals_match_jax(masked):
    """Unit sphere, k = 8 (masked: capacity-padded with 64 rows far away
    that the mask must hide): normals atol 1e-5, radial and outward;
    gradients of a weighted sum wrt the points rtol 2e-3 / atol 1e-3 of
    the largest."""
    rng = np.random.default_rng(1)
    v = rng.standard_normal((512, 3))
    pts = (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(np.float32)
    mask = None
    if masked:
        pts = np.concatenate([pts, rng.uniform(3.0, 4.0, (64, 3)).astype(
            np.float32)])
        mask = np.arange(576) < 512
    w = rng.standard_normal(pts.shape).astype(np.float32)

    def f_j(p):
        n = ops_j.estimate_pointcloud_normals(
            p, 8, None if mask is None else jnp.asarray(mask))
        return jnp.sum(n * w), n

    g_j, n_j = jax.grad(f_j, has_aux=True)(jnp.asarray(pts))
    p_t = t(pts).requires_grad_(True)
    n_t = ops_t.estimate_pointcloud_normals(
        p_t, 8, None if mask is None else t(mask))
    (n_t * t(w)).sum().backward()
    _close(n_t.detach().numpy(), n_j, 0, 1e-5)
    live = n_t.detach()[:512]
    dots = (live * t(pts[:512])).sum(-1)
    assert float(dots.abs().mean()) > 0.95 and float(dots.mean()) > 0.9
    _close_grad(p_t.grad.numpy(), g_j, 2e-3, 1e-3)


def test_estimate_normals_in_eigh_batches(monkeypatch):
    """Batches of EIGH_BATCH matrices (cuSOLVER refuses 32,768 or more at
    once): the normals and their gradients are bitwise those of one
    call."""
    rng = np.random.default_rng(4)
    v = rng.standard_normal((300, 3))
    pts = (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(np.float32)
    outs = []
    for batch in (ops_t.EIGH_BATCH, 64):
        monkeypatch.setattr(ops_t, "EIGH_BATCH", batch)
        p = t(pts).requires_grad_(True)
        n = ops_t.estimate_pointcloud_normals(p, 8)
        n.sum().backward()
        outs.append((n.detach(), p.grad))
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1], outs[1][1])


def test_pbr_scene_init_and_learned_normals_match_jax():
    """make_scene with pbr: raw specular inv_sigmoid(0.05) on every slot,
    the learned normal's raw init the estimated normals of the initial
    means (no inverse of tanh), zero padding; then scene_normals(learned)
    and its gradient (rtol 1e-5 / atol 1e-6)."""
    rng = np.random.default_rng(2)
    v = rng.standard_normal((200, 3))
    mean = (0.7 * v / np.linalg.norm(v, axis=1, keepdims=True)).astype(
        np.float32)
    q = np.tile(np.float32([1, 0, 0, 0]), (200, 1))
    s = np.full((200, 3), 0.05, np.float32)
    c = np.full((200, 3), 0.5, np.float32)
    a = np.full(200, 0.8, np.float32)
    kw = dict(pbr=True, normal_type="learned", normal_neighborhood=8)
    rc_j = scene_j.RenderConfig(**kw)
    rc_t = scene_t.RenderConfig(**kw)
    st_j = scene_j.make_scene(*(jnp.asarray(x) for x in (mean, q, s, c, a)),
                              rc_j, capacity=256)
    st_t = scene_t.make_scene(*(t(x) for x in (mean, q, s, c, a)), rc_t,
                              capacity=256)
    assert scene_t.present_fields(st_t.params) == scene_t.FIELDS + (
        "specular", "normal")
    _close(st_t.params["specular"].numpy(), st_j.params.specular)
    _close(st_t.params["normal"].numpy(), st_j.params.normal, 0, 1e-5)
    assert float(st_t.params["normal"][200:].abs().max()) == 0.0
    raw = _with_pbr(scene3d(64, seed=3), 4)
    w = rng.standard_normal((64, 3)).astype(np.float32)
    g_j = jax.grad(lambda p: jnp.sum(scene_j.scene_normals(
        p, None, rc_j) * w))(_params_j(raw))
    p_t = {k: t(v).requires_grad_(True) for k, v in raw.items()
           if k in ALL_FIELDS}
    n_t = scene_t.scene_normals(p_t, None, rc_t)
    (n_t * t(w)).sum().backward()
    _close(n_t.detach().numpy(),
           scene_j.scene_normals(_params_j(raw), None, rc_j))
    _close_grad(p_t["normal"].grad.numpy(), g_j.normal, 1e-5, 1e-6)
    with pytest.raises(ValueError):
        scene_t.scene_normals({"mean": t(raw["mean"])}, None,
                              scene_t.RenderConfig(normal_type="learned"))


def test_shaded_color_matches_jax():
    """The specular term and its gradients wrt normal, specular and mean:
    rtol 1e-5 / atol 1e-6 (of the largest, for gradients)."""
    rng = np.random.default_rng(3)
    n = rng.standard_normal((50, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    spec = rng.uniform(0, 1, (50, 3)).astype(np.float32)
    mean = rng.standard_normal((50, 3)).astype(np.float32) * 0.5
    lp, lc, cam = (np.float32([2.5, 1.0, 1.0]), np.float32([1.0, 0.9, 0.8]),
                   np.float32([0.0, -2.5, 0.3]))
    w = rng.standard_normal((50, 3)).astype(np.float32)
    args = [jnp.asarray(x) for x in (n, spec, mean)]
    val_j, g_j = jax.value_and_grad(lambda a, b, c: jnp.sum(
        scene_j.shaded_color(jnp.asarray(lp), jnp.asarray(lc), a, b, c,
                             jnp.asarray(cam)) * w), argnums=(0, 1, 2))(*args)
    ts = [t(x).requires_grad_(True) for x in (n, spec, mean)]
    val = (scene_t.shaded_color(t(lp), t(lc), *ts, t(cam)) * t(w)).sum()
    val.backward()
    _close(float(val.detach()), float(val_j))
    for a, b, k in zip(ts, g_j, ("normal", "specular", "mean")):
        _close_grad(a.grad.numpy(), b, 1e-5, 1e-6, k)


# -- render_view ----------------------------------------------------------

RENDER_CASES = {
    # name: (RenderConfig overrides, light, rgb_only, sphere scene)
    "sh2": (dict(sh_degree=2), False, False, False),
    "normal_as_rgb": (dict(normal_as_rgb=True, normal_neighborhood=8),
                      False, False, True),
    "pbr_learned": (dict(pbr=True, normal_type="learned"), True, True,
                    False),
    "pbr_estimated": (dict(pbr=True, normal_neighborhood=8), True, False,
                      True),
    "render_normal_padded": (dict(pbr=True, normal_type="learned",
                                  render_normal=True), True, False, False),
    "render_normal_compact": (dict(pbr=True, normal_type="learned",
                                   render_normal=True,
                                   binning_layout="compact"), True, False,
                              False),
    "render_normal_estimated": (dict(render_normal=True,
                                     normal_neighborhood=8), False, False,
                                True),
}


@pytest.mark.parametrize("case", sorted(RENDER_CASES))
def test_render_view_extras_match_jax(case):
    """One view, every output (``normal`` [H, W, 3] with render_normal: F =
    8 through the plain K1/K2 or K8/K9) rtol 1e-4 / atol 1e-5; gradients of
    a weighted sum of rgb, T, depth and normal wrt every field (specular,
    normal included) rtol 2e-3 / atol 2e-4 of the largest (2e-3 / 1e-3
    where estimated normals go through eigh)."""
    over, light, rgb_only, sphere = RENDER_CASES[case]
    raw = (_sphere(150, seed=5, capacity=192) if sphere
           else scene3d(150, seed=5, capacity=192))
    if over.get("pbr"):
        raw = _with_pbr(raw, 6)
    if over.get("sh_degree"):
        raw["color"] = np.random.default_rng(7).standard_normal(
            (192, 12)).astype(np.float32)
    rc_j = scene_j.RenderConfig(**EXACT_J, **KW, **over)
    rc_t = scene_t.RenderConfig(**KW, **over)
    b = _batch(1, seed=8)
    cam = {k: b[k][0] for k in ("c2w", "fx", "fy", "cx", "cy", "light_pos",
                                "light_color")}
    bg = np.array([0.2, 0.5, 0.9], np.float32)
    rng = np.random.default_rng(9)
    w = rng.standard_normal((RES, RES, 3)).astype(np.float32)
    wd = rng.standard_normal((RES, RES)).astype(np.float32)
    intr_j = cam_j.CameraIntrinsics.from_reso(RES)
    intr_t = cam_t.CameraIntrinsics.from_reso(RES)
    lk = ("light_pos", "light_color")

    def loss_j(p):
        o = scene_j.render_view(
            p, jnp.asarray(raw["active"]), jnp.asarray(cam["c2w"]), intr_j,
            rc_j, jnp.asarray(bg),
            *(jnp.float32(cam[k]) for k in ("fx", "fy", "cx", "cy")),
            rgb_only=rgb_only,
            **({k: jnp.asarray(cam[k]) for k in lk} if light else {}))
        s = jnp.sum(o["rgb"] * w) + jnp.sum(o["T"] * wd)
        if not rgb_only:
            s = s + 0.1 * jnp.sum(o["depth"] * wd)
        if "normal" in o:
            s = s + jnp.sum(o["normal"] * w[::-1])
        return s, o

    g_j, out_j = jax.grad(loss_j, has_aux=True)(_params_j(raw))
    p_t = {k: t(v).requires_grad_(True) for k, v in raw.items()
           if k in ALL_FIELDS}
    out_t = scene_t.render_view(
        p_t, t(raw["active"]), cam["c2w"], intr_t, rc_t, bg, cam["fx"],
        cam["fy"], cam["cx"], cam["cy"], rgb_only=rgb_only,
        **({k: cam[k] for k in lk} if light else {}))
    s = (out_t["rgb"] * t(w)).sum() + (out_t["T"] * t(wd)).sum()
    if not rgb_only:
        s = s + 0.1 * (out_t["depth"] * t(wd)).sum()
    if "normal" in out_t:
        s = s + (out_t["normal"] * t(np.ascontiguousarray(w[::-1]))).sum()
    s.backward()
    assert set(out_t) == set(out_j)
    assert ("normal" in out_t) == (over.get("render_normal", False))
    for k in out_j:
        if k in ("visible", "n_dup"):
            np.testing.assert_array_equal(out_t[k].numpy(),
                                          np.asarray(out_j[k]), k)
        else:
            _close(out_t[k].detach().numpy(), out_j[k], 1e-4, 1e-5, k)
    eig = rc_t.normal_type == "estimated" and sphere
    for k, v in p_t.items():
        if v.grad is None:          # a field this render does not read
            assert float(jnp.abs(getattr(g_j, k)).max()) == 0.0, k
            continue
        _close_grad(v.grad.numpy(), getattr(g_j, k), 2e-3,
                    1e-3 if eig else 2e-4, k)
    if light:
        assert float(p_t["specular"].grad.abs().max()) > 0


def test_render_batch_lights_and_shared_normals():
    """render_batch computes the normals once for its views and gives each
    view its own light: the same as render_view per view (exactly)."""
    raw = _with_pbr(scene3d(120, seed=10, capacity=128), 11)
    rc = scene_t.RenderConfig(**KW, pbr=True, normal_type="learned",
                              render_normal=True)
    b = _batch(2, seed=12)
    sc = scene_t.scene_from_numpy(raw, "cpu")
    bgs = np.zeros((2, 3), np.float32)
    out = scene_t.render_batch(sc.params, sc.active, t(b["c2w"]),
                               cam_t.CameraIntrinsics.from_reso(RES), rc,
                               t(bgs), t(b["fx"]), t(b["fy"]), t(b["cx"]),
                               t(b["cy"]), light_pos=t(b["light_pos"]),
                               light_color=t(b["light_color"]))
    for i in range(2):
        one = scene_t.render_view(
            sc.params, sc.active, b["c2w"][i],
            cam_t.CameraIntrinsics.from_reso(RES), rc, bgs[i], b["fx"][i],
            b["fy"][i], b["cx"][i], b["cy"][i],
            light_pos=b["light_pos"][i], light_color=b["light_color"][i])
        for k in ("rgb", "normal", "depth"):
            assert torch.equal(out[k][i], one[k]), k


# -- penalties ------------------------------------------------------------

PENALTY_CASES = [("alpha", k) for k in ("center_weighted", "uniform_l1",
                                        "uniform_l2")] + \
    [("mean", k) for k in ("uniform_l1", "uniform_l2", "weighted_l1",
                           "weighted_l2")] + \
    [("scale", None), ("NN", None), ("compat", "l1"), ("compat", "l2"),
     ("move", None), ("specular", None)]


@pytest.mark.parametrize("name,kind", PENALTY_CASES)
def test_penalties_match_jax(name, kind):
    """Each penalty in each kind through the trainer's dispatch
    (``losses.penalty``) against the JAX function with the JAX trainer's
    keywords: value rtol 1e-5, gradients wrt every field rtol 1e-4 / atol
    1e-6 of the largest.  A reference fault the port does not copy: the
    JAX ``mean_penalty``'s gradient is NaN in the padding rows, whose means
    sit at the origin (the norm's 0 / 0); the port's is 0 there.  Every
    other gradient row is compared as it is."""
    raw = _with_pbr(scene3d(100, seed=13, capacity=128, svec=0.08), 14)
    prev = (raw["mean"] + np.random.default_rng(15).normal(
        0, 0.01, raw["mean"].shape)).astype(np.float32)
    rc_j, rc_t = scene_j.RenderConfig(), scene_t.RenderConfig()
    kw = {"alpha": dict(cfg=rc_j), "compat": dict(cfg=rc_j),
          "scale": dict(cfg=rc_j), "move": dict(prev_mean=jnp.asarray(prev))
          }.get(name, {})
    if kind is not None:
        kw["kind"] = kind
    val_j, g_j = jax.value_and_grad(lambda p: losses_j.PENALTIES[name](
        p, jnp.asarray(raw["active"]), **kw))(_params_j(raw))
    p_t = {k: t(v).requires_grad_(True) for k, v in raw.items()
           if k in ALL_FIELDS}
    spec = {} if kind is None else {"type": kind}
    val = losses_t.penalty(name, spec, p_t, t(raw["active"]), rc_t, t(prev))
    assert float(val_j) != 0.0
    _close(float(val), float(val_j), 1e-5, 0, name)
    val.backward()
    pad = ~raw["active"]
    for k, v in p_t.items():
        g = np.array(getattr(g_j, k))
        if v.grad is None:
            assert float(np.abs(g).max()) == 0.0, k
            continue
        got = v.grad.numpy()
        assert np.isfinite(got).all(), k
        if name == "mean" and k == "mean":
            assert np.isnan(g[pad]).all() and not np.isnan(g[~pad]).any()
            assert float(np.abs(got[pad]).max()) == 0.0
            g[pad] = 0.0
        _close_grad(got, g, 1e-4, 1e-6, k)


def test_penalty_errors():
    """Unknown kinds and a missing specular field raise, as in the JAX
    package."""
    raw = scene3d(16, seed=1)
    p = {k: t(v) for k, v in raw.items() if k in FIELDS}
    act = t(raw["active"])
    rc = scene_t.RenderConfig()
    with pytest.raises(ValueError):
        losses_t.penalty("mean", {"type": "bogus"}, p, act, rc, p["mean"])
    with pytest.raises(ValueError):
        losses_t.penalty("compat", {"type": "l3"}, p, act, rc, p["mean"])
    with pytest.raises(ValueError):
        losses_t.penalty("specular", {}, p, act, rc, p["mean"])
    assert sorted(losses_t.PENALTIES) == sorted(losses_j.PENALTIES)


# -- density control with the PBR fields -------------------------------------

def _pbr_world(n, cap, seed):
    raw = _with_pbr(scene3d(n, seed=seed, capacity=cap, svec=0.03), seed)
    rng = np.random.default_rng(seed + 1)
    raw["grad_accum"] = rng.uniform(0.0, 0.1, cap).astype(np.float32)
    raw["grad_cnt"] = rng.integers(0, 4, cap).astype(np.float32)
    raw["max_radii2d"] = rng.uniform(0.0, 2.0, cap).astype(np.float32)
    mom = {k: {f: rng.standard_normal(raw[f].shape).astype(np.float32)
               for f in ALL_FIELDS} for k in ("mu", "nu")}
    st_j = scene_j.SceneState(
        params=_params_j(raw), active=jnp.asarray(raw["active"]),
        **{s: jnp.asarray(raw[s]) for s in scene_t.STATS})
    opt_j = AdamJ(*(scene_j.GaussianParams(**{f: jnp.asarray(mom[k][f])
                                              for f in ALL_FIELDS})
                    for k in ("mu", "nu")), count=jnp.int32(3))
    opt_t = AdamState(mu={f: t(mom["mu"][f]) for f in ALL_FIELDS},
                      nu={f: t(mom["nu"][f]) for f in ALL_FIELDS}, count=3)
    return raw, st_j, opt_j, scene_t.scene_from_numpy(raw, "cpu"), opt_t


@pytest.mark.parametrize("event", ["legacy", "official", "compatness",
                                   "prune"])
def test_density_events_carry_pbr_fields(event):
    """Clone / split copy the parent's specular and normal rows, the
    compactness fill copies them too, prune masks them; every field
    (specular and normal included) rtol 1e-5 / atol 1e-6, ``active`` and
    the Adam moments (their own rows for specular and normal) exactly."""
    raw, st_j, opt_j, st_t, opt_t = _pbr_world(40, 160, seed=16)
    rc_j, rc_t = scene_j.RenderConfig(pbr=True), scene_t.RenderConfig(
        pbr=True)
    key = jax.random.PRNGKey(3)
    if event == "prune":
        cfg_kw = dict(enabled=True, radii2d_thresh=1.0, alpha_thresh=0.4,
                      radii3d_thresh=0.035)
        new_j, o_j, info_j = dens_j.prune(
            st_j, opt_j, dens_j.PruneConfig(**cfg_kw), rc_j, 1.0, 0.4)
        new_t, o_t, info_t = dens_t.prune(
            st_t, opt_t, dens_t.PruneConfig(**cfg_kw), rc_t, 1.0, 0.4)
    else:
        over = {"legacy": dict(use_legacy=True, mean2d_thresh=0.01),
                "official": dict(use_legacy=False, type="official",
                                 mean2d_thresh=0.01),
                "compatness": dict(use_legacy=False, type="compatness")
                }[event]
        cfg_j = dataclasses.replace(dens_j.DensifyConfig(), **over)
        cfg_t = dataclasses.replace(dens_t.DensifyConfig(), **over)
        new_j, o_j, info_j = dens_j.densify(st_j, opt_j, cfg_j, rc_j, key)
        noise = None
        if event != "compatness":
            noise, k = [], key
            for _ in range(2):
                k, k1 = jax.random.split(k)
                noise.append(np.asarray(jax.random.normal(k1, (160, 3))))
        new_t, o_t, info_t = dens_t.densify(st_t, opt_t, cfg_t, rc_t,
                                            noise=noise)
    assert {k: int(v) for k, v in info_j.items()} == info_t
    assert sum(info_t.values()) > 0
    np.testing.assert_array_equal(new_t.active.numpy(),
                                  np.asarray(new_j.active))
    for f in ALL_FIELDS:
        _close(new_t.params[f].numpy(), getattr(new_j.params, f), 1e-5,
               1e-6, f)
        for m in ("mu", "nu"):
            np.testing.assert_array_equal(
                getattr(o_t, m)[f].numpy(),
                np.asarray(getattr(getattr(o_j, m), f)), err_msg=m + f)


# -- mock scene mode ------------------------------------------------------

@pytest.mark.parametrize("reso", [RES, 16])
def test_mock_scene_mode_matches_jax(reso):
    """An rgb_only render of a frozen target on white backgrounds; at a
    render resolution other than the target's intrinsics (16 against 32)
    the intrinsics are rebuilt.  Loss rtol 1e-4, its gradient wrt the
    render rtol 1e-4 / atol 1e-5 of the largest."""
    raw = scene3d(120, seed=17, capacity=128)
    rc_j = scene_j.RenderConfig(**EXACT_J, **KW)
    rc_t = scene_t.RenderConfig(**KW)
    g_j = MockJ(mode="scene", target_scene=_params_j(raw),
                target_active=jnp.asarray(raw["active"]),
                intr=cam_j.CameraIntrinsics.from_reso(RES), rcfg=rc_j)
    g_t = MockGuidance(mode="scene",
                       target_scene={k: t(v) for k, v in raw.items()
                                     if k in FIELDS},
                       target_active=t(raw["active"]),
                       intr=cam_t.CameraIntrinsics.from_reso(RES), rcfg=rc_t)
    cfg = CameraSamplerConfig(batch_size=2, reso=(reso,),
                              camera_distance=(2.0, 2.5))
    b = CameraPoseProvider(cfg, seed=18).get_batch()
    rgb = np.random.default_rng(19).uniform(0, 1, (2, reso, reso, 3)
                                            ).astype(np.float32)
    cams = {k: b[k] for k in ("fx", "fy", "cx", "cy")}

    def f_j(x):
        return g_j.loss({}, x, None, None, None, None, None, None,
                        c2ws=jnp.asarray(b["c2w"]),
                        fxs=jnp.asarray(cams["fx"]),
                        fys=jnp.asarray(cams["fy"]),
                        cxs=jnp.asarray(cams["cx"]),
                        cys=jnp.asarray(cams["cy"]))["loss_sds"]

    val_j, gr_j = jax.value_and_grad(f_j)(jnp.asarray(rgb))
    x = t(rgb).requires_grad_(True)
    val = g_t.loss(x, None, None, None, None, c2ws=t(b["c2w"]),
                   **{f"{k}s": t(v) for k, v in cams.items()})["loss_sds"]
    val.backward()
    _close(float(val), float(val_j), 1e-4, 0)
    _close_grad(x.grad.numpy(), gr_j, 1e-4, 1e-5)
    with pytest.raises(ValueError):
        MockGuidance(mode="scene")


# -- trainer steps ---------------------------------------------------------

SMALL = ["init.num_points=96", "init.capacity=128", "data.reso=[32]",
         "renderer.tile_size=8", "renderer.chunk=128",
         "renderer.dup_cap=4096", "trainer.batch_size=2",
         "prompt.use_cache=false", "guidance.type=mock"]
EXACT = ["renderer.backend=pallas", "renderer.pallas_interpret=true",
         "renderer.mxu_scans=false", "renderer.fast_fwd_cumprod=false"]
PBR = ["renderer.pbr=true", "renderer.normal_type=learned",
       "renderer.render_normal=true",
       "renderer.background.type=learned_const",
       "renderer.background.random_aug=true",
       "renderer.background.random_aug_prob=0.5"]
PENALTY = ["trainer.penalty.alpha.value=0.01",
           "trainer.penalty.mean.value=0.01",
           "trainer.penalty.mean.type=weighted_l2",
           "trainer.penalty.scale.value=10.0",
           "trainer.penalty.NN.value=0.01",
           "trainer.penalty.compat.value=0.01",
           "trainer.penalty.compat.type=l2",
           "trainer.penalty.move.value=0.01",
           "trainer.penalty.specular.value=0.01"]


def _trainer_pair(cfg_names, overrides, pbr_seed=None, sphere=False,
                  capacity=128):
    """build_trainer in each package from one config dict (the JAX side on
    its exact render path), started from the same scene: the JAX trainer's
    state, its scene replaced by a scene3d (or sphere) scene of 96 live
    Gaussians, carried to the port through the checkpoint key paths."""
    paths = [ROOT / "configs" / n for n in cfg_names]
    over = SMALL + overrides + [f"init.capacity={capacity}"]
    tj = build_trainer_j(load_config(paths, over + EXACT))
    tt = build_trainer(load_config(paths, over), device="cpu")
    raw = (_sphere(96, seed=20, capacity=capacity) if sphere
           else scene3d(96, seed=20, capacity=capacity, mean_std=0.4))
    if pbr_seed is not None:
        raw = _with_pbr(raw, pbr_seed)
    if tt.rcfg.sh_degree:
        raw["color"] = np.random.default_rng(21).standard_normal(
            (capacity, 3 * tt.rcfg.sh_degree ** 2)).astype(np.float32)
    tj.state = tj.state._replace(scene=tj.state.scene._replace(
        params=_params_j(raw)))
    tt.state = train_state_from_jax_arrays(
        ckpt_j._flatten_with_paths(tj.state), "cpu")
    return tj, tt


def _jax_step_bg_draws(tj):
    """The background uniforms the JAX trainer's next step draws, one [6]
    per view: state.key -> k_loop -> keys[a] -> k_bg -> one key a view."""
    _, k_loop = jax.random.split(tj.state.key)
    out = []
    for ka in jax.random.split(k_loop, tj.cfg.grad_accum):
        k_bg, _ = jax.random.split(ka)
        for kv in jax.random.split(k_bg, tj.cfg.batch_size):
            out.append(_jax_view_uniforms(kv))
    return out


def _step_both(tj, tt, step, monkeypatch):
    draws = _jax_step_bg_draws(tj)
    orig = bg_t.apply_background

    def injected(*a, **kw):
        return orig(*a, u=t(draws.pop(0)), **kw)

    monkeypatch.setattr(trainer_mod, "apply_background", injected)
    m_j, m_t = tj.train_step(step), tt.train_step(step)
    assert not draws
    return m_j, m_t


def _check_state(tj, tt, what):
    """Adam's first moments (0.1 x the averaged gradients, decayed) of
    every scene field and background leaf: rtol 2e-3 / atol 2e-4 of the
    largest (2e-3 / 1e-3 for fields reached through eigh)."""
    arrays = ckpt_j._flatten_with_paths(tj.state)
    eig = (tt.rcfg.normal_as_rgb and tt.rcfg.normal_type == "estimated")
    for f in scene_t.present_fields(tt.state.scene.params):
        _close_grad(tt.state.opt.mu[f].numpy(),
                    arrays[f".opt/.mu/[0]/.{f}"], 2e-3,
                    1e-3 if eig else 2e-4, f"{what} mu {f}")
    for k in tt.state.bg:
        _close_grad(tt.state.opt.mu[f"bg/{k}"].numpy(),
                    arrays[f".opt/.mu/[1]/['{k}']"], 2e-3, 2e-4,
                    f"{what} mu bg {k}")


@pytest.mark.parametrize("layout", ["padded", "compact"])
def test_pbr_penalties_trainer_steps_match_jax(layout, monkeypatch):
    """Two build_trainer steps of base.yaml with pbr (learned normals,
    render_normal: F = 8), learned_const + random_aug at prob 0.5 and
    every penalty at a nonzero weight, mock guidance, each view's light
    from the batch; the JAX trainer's background draws injected.  Losses
    and penalties rtol 1e-4 (the move penalty's second step reads the
    means before the first update); moments as :func:`_check_state`.
    The scene fills its capacity: with padding rows the JAX mean penalty
    turns them NaN (:func:`test_mean_penalty_padding_rows_stay_finite`)."""
    over = PBR + PENALTY + [f"renderer.binning_layout={layout}"]
    tj, tt = _trainer_pair(["base.yaml"], over, pbr_seed=22, capacity=96)
    assert set(tt.state.scene.params) == set(ALL_FIELDS)
    assert set(tt.state.bg) == {"bg_color"}
    for step in range(2):
        m_j, m_t = _step_both(tj, tt, step, monkeypatch)
        for k in ("loss_sds", "loss_total", *(f"pen_{n}" for n in
                                              losses_t.PENALTIES)):
            _close(float(m_t[k]), float(m_j[k]), 1e-4, 0, f"{step} {k}")
        _check_state(tj, tt, f"step {step}")
    assert float(m_t["pen_move"]) > 1e-5


def test_mean_penalty_padding_rows_stay_finite():
    """A reference fault the port does not copy: the JAX mean penalty's
    gradient is NaN in the padding rows (means at the origin), so Adam
    writes NaN there, and the compat penalty's backward carries it into
    the live means by the third step.  The port's trainer keeps every
    field finite over the same three steps."""
    over = ["trainer.penalty.mean.value=0.01",
            "trainer.penalty.compat.value=0.01"]
    tj, tt = _trainer_pair(["base.yaml"], over)
    for step in range(3):
        tj.train_step(step)
        tt.train_step(step)
    m_j = np.asarray(tj.state.scene.params.mean)
    live = np.asarray(tj.state.scene.active)
    assert np.isnan(m_j[~live]).all() and np.isnan(m_j[live]).any()
    for k, v in tt.state.scene.params.items():
        assert bool(torch.isfinite(v).all()), k
    assert float(tt.state.scene.params["mean"][~tt.state.scene.active]
                 .abs().max()) == 0.0


PRESETS = ["renderer/mlp_bg.yaml", "renderer/legacy.yaml",
           "renderer/normal_as_rgb.yaml",
           "renderer/no_densify_normal_as_rgb.yaml"]


@pytest.mark.parametrize("preset", PRESETS)
def test_preset_overlay_step_matches_jax(preset, monkeypatch):
    """One build_trainer step of base.yaml + the preset overlay (mlp
    background, SH degree 1, estimated normals as rgb with k = 30 on a
    sphere scene) on mock guidance, with the JAX trainer's background
    draws injected: loss rtol 1e-4; moments as :func:`_check_state`."""
    tj, tt = _trainer_pair(["base.yaml", preset], [],
                           sphere="normal" in preset)
    if "mlp" in preset:
        assert set(tt.state.bg) == {"b0", "b1", "b2", "w0", "w1", "w2"}
    m_j, m_t = _step_both(tj, tt, 0, monkeypatch)
    for k in ("loss_sds", "loss_total"):
        _close(float(m_t[k]), float(m_j[k]), 1e-4, 0, k)
    _check_state(tj, tt, preset)


# -- checkpoints ---------------------------------------------------------

def _ckpt_pair():
    over = ["renderer.pbr=true", "renderer.normal_type=learned",
            "renderer.background.type=mlp"]
    return _trainer_pair(["base.yaml"], over, pbr_seed=23)


def _random_like(arr, rng):
    arr = np.asarray(arr)
    if arr.dtype == bool:
        return rng.random(arr.shape) < 0.5
    if arr.dtype.kind in "iu":
        return rng.integers(1, 1000, arr.shape).astype(arr.dtype)
    return rng.standard_normal(arr.shape).astype(arr.dtype)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_checkpoint_pbr_and_mlp_bg_both_ways(tmp_path, writer):
    """A checkpoint with specular / normal (and their moments) and the
    MLP background's weights (and theirs), written by one package and
    read by the other: every array equal, keys in the JAX tree order."""
    tj, tt = _ckpt_pair()
    rng = np.random.default_rng(24)
    if writer == "port":
        arrays = {k: _random_like(v, rng) for k, v in
                  ckpt_t.state_arrays(tt.state, seed=3).items()}
        tt.state = train_state_from_jax_arrays(arrays, "cpu")
        ckpt_t.save_checkpoint(tmp_path / "ckpts", 7, tt.state, seed=3)
        state_j, step = ckpt_j.load_checkpoint(tmp_path / "ckpts", tj.state)
        assert step == 7
        got = ckpt_j._flatten_with_paths(state_j)
        want = ckpt_t.state_arrays(tt.state, seed=3)
    else:
        leaves, treedef = jax.tree_util.tree_flatten(tj.state)
        tj.state = jax.tree_util.tree_unflatten(
            treedef, [jnp.asarray(_random_like(x, rng)) for x in leaves])
        ckpt_j.save_checkpoint(tmp_path / "ckpts", 5, tj.state)
        assert tt.load(tmp_path / "ckpts" / "step_5") == 5
        want = ckpt_j._flatten_with_paths(tj.state)
        got = ckpt_t.state_arrays(tt.state, seed=0)
        got[".key"] = want[".key"]          # the port carries no JAX key
    assert list(got) == list(want)
    for k in (".scene/.params/.specular", ".scene/.params/.normal",
              ".opt/.nu/[0]/.normal", ".bg/['w2']", ".opt/.mu/[1]/['b0']"):
        assert k in want, k
    for k, v in want.items():
        assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    a_t = ckpt_t.scene_arrays_from_checkpoint(tmp_path / "ckpts")
    a_j = ckpt_j.scene_arrays_from_checkpoint(tmp_path / "ckpts")
    assert set(a_t) == set(a_j) == set(ALL_FIELDS)
    for k in a_j:
        np.testing.assert_array_equal(a_t[k], a_j[k], err_msg=k)
