"""The port's image-to-3D path against the JAX package on the CPU.

Matting, ``read_png`` (against imageio), the init types, the single-view
camera sampler, ``lift_to_3d``, ``image_initialize`` (the JAX back-point
draws injected), the Pearson depth and L2 image losses, ``sit3d_losses``,
a trainer step with the image target and the gradient mask (losses, each
field's gradient, the frozen rows bitwise unchanged), and build_trainer
on an ``image:`` block over a temporary PNG.

Tolerances: numpy code (matting, the sampler) and index results exact;
tensor functions rtol 2e-4 / atol 2e-5 as the JAX-vs-oracle tests; the
trainer step's losses rtol 1e-4 and each field's gradient (Adam's first
moment after one step) within 2e-3 relative plus 2e-4 of its largest
value, as the port's other trainer parity tests (a sum over every pixel
of four views at 32²).
"""

import copy
import dataclasses
import struct
import zlib
from pathlib import Path

import imageio.v2 as imageio
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsgen_tpu.config import build_trainer as build_trainer_j
from gsgen_tpu.data import cameras as cam_j
from gsgen_tpu.guidance.mock import MockGuidance as MockJ
from gsgen_tpu.io.checkpoint import _flatten_with_paths
from gsgen_tpu.models import init as init_j
from gsgen_tpu.models.background import BackgroundConfig as BgJ
from gsgen_tpu.models.density import DensifyConfig as DensJ
from gsgen_tpu.models.density import PruneConfig as PruneJ
from gsgen_tpu.models.scene import RenderConfig as RenderJ
from gsgen_tpu.ops.camera import CameraIntrinsics as IntrJ
from gsgen_tpu.training import losses as losses_j
from gsgen_tpu.training import sit3d as sit3d_j
from gsgen_tpu.training.trainer import LossConfig as LossJ
from gsgen_tpu.training.trainer import Trainer as TrainerJ
from gsgen_tpu.training.trainer import TrainerConfig as TcfgJ
from gsgen_tpu.utils import matting as matting_j
from gsgen_tpu.utils.ops import mean_knn_sqdist as mean_knn_sqdist_j
from gsgen_torch.config import build_trainer, load_config
from gsgen_torch.data import cameras as cam_t
from gsgen_torch.guidance.mock import MockGuidance
from gsgen_torch.io.logging import read_png, write_png
from gsgen_torch.models import init as init_t
from gsgen_torch.models.background import BackgroundConfig
from gsgen_torch.models.density import DensifyConfig, PruneConfig
from gsgen_torch.models.scene import FIELDS, RenderConfig
from gsgen_torch.ops.camera import CameraIntrinsics
from gsgen_torch.training import losses as losses_t
from gsgen_torch.training import sit3d as sit3d_t
from gsgen_torch.training.trainer import (LossConfig, Trainer, TrainerConfig,
                                          train_state_from_jax_arrays)
from gsgen_torch.utils import matting as matting_t
from gsgen_torch.utils.ops import mean_knn_sqdist
from torch_fixtures import t

ROOT = Path(__file__).resolve().parents[1]
RES = 32
TOL = dict(rtol=2e-4, atol=2e-5)
# the front camera of the JAX config's image mode, 2 units out on +x
C2W = np.array([[0, 0, -1, 2.0], [1, 0, 0, 0], [0, -1, 0, 0]], np.float32)


def shaded_sphere(h=RES, w=RES, backdrop=1.0, radius=None):
    """An RGB image: a shaded disc on a uniform backdrop."""
    yy, xx = np.mgrid[:h, :w]
    r = radius or min(h, w) * 0.3
    r2 = ((xx - w / 2) ** 2 + (yy - h / 2) ** 2) / r ** 2
    img = np.full((h, w, 3), backdrop, np.float32)
    shade = np.sqrt(np.clip(1.0 - r2, 0.0, 1.0))[..., None]
    col = np.array([0.8, 0.3, 0.2], np.float32) * (0.3 + 0.7 * shade)
    return np.where(r2[..., None] < 1.0, col, img).astype(np.float32)


def target_np(seed=0):
    rng = np.random.default_rng(seed)
    img = shaded_sphere()
    mask = np.any(img < 0.99, axis=-1)
    depth = (2.0 + 0.3 * rng.standard_normal((RES, RES))).astype(np.float32)
    return img, depth, mask


# ---- matting and read_png ----

@pytest.mark.parametrize("backdrop", [1.0, 0.2])
def test_matting_matches_jax(backdrop):
    img = shaded_sphere(40, 48, backdrop=backdrop)
    rng = np.random.default_rng(1)
    img = np.clip(img + 0.01 * rng.standard_normal(img.shape), 0,
                  1).astype(np.float32)
    a_t = matting_t.estimate_alpha(img)
    np.testing.assert_array_equal(a_t, matting_j.estimate_alpha(img))
    assert a_t[20, 24] == 1.0 and a_t[0, 0] == 0.0
    np.testing.assert_array_equal(matting_t.ensure_rgba(img),
                                  matting_j.ensure_rgba(img))
    rgba = np.concatenate([img, a_t[..., None]], -1)
    np.testing.assert_array_equal(matting_t.ensure_rgba(rgba), rgba)


def _chunk(tag, data):
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def _png_every_filter(img, colour):
    """An 8-bit PNG whose rows cycle through filter types 0-4."""
    h, w = img.shape[:2]
    c = 1 if img.ndim == 2 else img.shape[2]
    rows = img.reshape(h, w * c).astype(np.int64)
    prev = np.zeros(w * c, np.int64)
    raw = b""
    for y in range(h):
        ft, r = y % 5, rows[y]
        a = np.concatenate([np.zeros(c, np.int64), r[:-c]])
        cc = np.concatenate([np.zeros(c, np.int64), prev[:-c]])
        p = a + prev - cc
        pa, pb, pc = np.abs(p - a), np.abs(p - prev), np.abs(p - cc)
        paeth = np.where((pa <= pb) & (pa <= pc), a,
                         np.where(pb <= pc, prev, cc))
        pred = [np.zeros_like(r), a, prev, (a + prev) // 2, paeth][ft]
        raw += bytes([ft]) + ((r - pred) % 256).astype(np.uint8).tobytes()
        prev = r
    return (b"\x89PNG\r\n\x1a\n"
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, colour, 0, 0,
                                          0))
            + _chunk(b"IDAT", zlib.compress(raw)) + _chunk(b"IEND", b""))


@pytest.mark.parametrize("colour,channels", [(0, 1), (2, 3), (4, 2), (6, 4)])
def test_read_png_matches_imageio(tmp_path, colour, channels):
    rng = np.random.default_rng(colour)
    shape = (23, 17) if channels == 1 else (23, 17, channels)
    img = rng.integers(0, 256, shape).astype(np.uint8)
    p = tmp_path / "filters.png"
    p.write_bytes(_png_every_filter(img, colour))
    got, want = read_png(p), imageio.imread(p)
    assert got.dtype == want.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, img)
    if channels in (3, 4):
        # imageio's own writer (its filter choice), and the port's writer
        q = tmp_path / "imageio.png"
        imageio.imwrite(q, img)
        np.testing.assert_array_equal(read_png(q), imageio.imread(q))
    if channels == 3:
        write_png(tmp_path / "port.png", img)
        np.testing.assert_array_equal(read_png(tmp_path / "port.png"), img)


def test_read_png_refuses_other_files(tmp_path):
    img = np.zeros((8, 8, 3), np.uint8)
    imageio.imwrite(tmp_path / "a.jpg", img)
    with pytest.raises(ValueError, match="JPEG"):
        read_png(tmp_path / "a.jpg")
    imageio.imwrite(tmp_path / "a.bmp", img)
    with pytest.raises(ValueError, match="BMP"):
        read_png(tmp_path / "a.bmp")
    pal = (b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", struct.pack(
        ">IIBBBBB", 8, 8, 8, 3, 0, 0, 0)) + _chunk(b"IEND", b""))
    (tmp_path / "p.png").write_bytes(pal)
    with pytest.raises(ValueError, match="palette"):
        read_png(tmp_path / "p.png")


# ---- the init types ----

@pytest.mark.parametrize("semi", [False, True])
def test_sphere_points_match_jax(semi):
    key = jax.random.PRNGKey(3)
    want = np.asarray(init_j._sphere_points(key, 200, 0.7, semi=semi))
    k1, k2 = jax.random.split(key)
    u1, u2 = jax.random.uniform(k1, (200,)), jax.random.uniform(k2, (200,))
    got = init_t.sphere_points(t(u1), t(u2), 0.7, semi=semi).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 0.7, rtol=1e-5)
    if semi:
        assert (got[:, 0] <= 1e-6).all()


def test_box_points_match_jax():
    key = jax.random.PRNGKey(4)
    want = np.asarray(init_j._box_points(key, 301, 0.5))
    k1, k2, k3 = jax.random.split(key, 3)
    draws = (jax.random.uniform(k1, (301,)), jax.random.uniform(k2, (301,)),
             jax.random.randint(k3, (301,), 0, 3))
    got = init_t.box_points(*(t(d) for d in draws), 0.5).numpy()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("kind", ["unisphere", "semisphere", "box",
                                  "unbounded", "base"])
def test_geometric_init_types_build(kind):
    cfg = init_t.InitConfig(type=kind, num_points=64, capacity=96,
                            mean_std=0.5)
    sc = init_t.initialize(cfg, RenderConfig(),
                           torch.Generator().manual_seed(0), "cpu")
    mean = sc.params["mean"][:64]
    assert sc.params["mean"].shape == (96, 3) and int(sc.active.sum()) == 64
    r = torch.linalg.norm(mean, dim=-1)
    if kind in ("unisphere", "semisphere", "unbounded"):
        np.testing.assert_allclose(r.numpy(), 0.5, rtol=1e-5)
    if kind == "box":
        assert float(mean.abs().max()) <= 0.5 + 1e-6


def test_knn_scale_and_ckpt_init_match_jax():
    rng = np.random.default_rng(2)
    pts = rng.standard_normal((80, 3)).astype(np.float32) * 0.4
    cols = rng.uniform(0, 1, (80, 3)).astype(np.float32)
    np.testing.assert_allclose(mean_knn_sqdist(t(pts)).numpy(),
                               np.asarray(mean_knn_sqdist_j(jnp.asarray(pts))),
                               **TOL)
    for knn in (dict(knn_scale=True), dict(svec_val=0.0)):
        kw = dict(type="point_cloud", capacity=96, **knn)
        sj = init_j.initialize(jax.random.PRNGKey(0),
                               init_j.InitConfig(**kw), RenderJ(), pts, cols)
        st = init_t.initialize(init_t.InitConfig(**kw), RenderConfig(),
                               torch.Generator(), "cpu", pts, cols)
        for f in FIELDS:
            np.testing.assert_allclose(st.params[f].numpy(),
                                       np.asarray(getattr(sj.params, f)),
                                       **TOL, err_msg=f)
    raw = dict(mean=pts, qvec=rng.standard_normal((80, 4)).astype(np.float32),
               svec=np.log(np.full((80, 3), 0.03, np.float32)),
               color=cols, alpha=np.zeros(80, np.float32))
    sj = init_j.initialize(jax.random.PRNGKey(0),
                           init_j.InitConfig(type="ckpt", capacity=128),
                           RenderJ(), raw_values=raw)
    st = init_t.initialize(init_t.InitConfig(type="ckpt", capacity=128),
                           RenderConfig(), torch.Generator(), "cpu",
                           raw_values=raw)
    for f in FIELDS:
        np.testing.assert_array_equal(st.params[f].numpy(),
                                      np.asarray(getattr(sj.params, f)))
    with pytest.raises(ValueError, match="raw_values"):
        init_t.initialize(init_t.InitConfig(type="ckpt"), RenderConfig(),
                          torch.Generator(), "cpu")


# ---- the single-view sampler, lifting, the image init ----

@pytest.mark.parametrize("prob", [0.0, 0.5, 1.0])
def test_single_view_sampler_matches_jax(prob):
    kw = dict(batch_size=4, max_steps=10, reso=(RES,))
    pj = cam_j.SingleViewCameraPoseProvider(cam_j.CameraSamplerConfig(**kw),
                                            seed=5, original_view_prob=prob)
    pt = cam_t.SingleViewCameraPoseProvider(cam_t.CameraSamplerConfig(**kw),
                                            seed=5, original_view_prob=prob)
    for _ in range(3):
        bj, bt = pj.get_batch(), pt.get_batch()
        assert set(bj) == set(bt)
        for k in bj:
            np.testing.assert_array_equal(bt[k], bj[k], err_msg=k)
    if prob in (0.0, 1.0):
        assert (bt["is_original"] == prob).all()


def test_lift_to_3d_matches_jax():
    _, depth, _ = target_np()
    intr_t, intr_j = CameraIntrinsics.from_reso(RES), IntrJ.from_reso(RES)
    got = sit3d_t.lift_to_3d(t(depth), intr_t, t(C2W)).numpy()
    want = np.asarray(sit3d_j.lift_to_3d(jnp.asarray(depth), intr_j,
                                         jnp.asarray(C2W)))
    np.testing.assert_allclose(got, want, **TOL)
    # the centre pixel's ray is the optical axis: depth along -x
    np.testing.assert_allclose(got[RES // 2, RES // 2, 0],
                               2.0 - depth[RES // 2, RES // 2], rtol=1e-5)


def _jax_back_draws(key, n, mean_std):
    k1, k2 = jax.random.split(key)
    return (np.asarray(init_j._sphere_points(k1, n, mean_std, semi=True)),
            np.asarray(jax.random.uniform(k2, (n, 3))))


@pytest.mark.parametrize("num_points,grad_mask", [(64, True), (2000, False)])
def test_image_initialize_matches_jax(num_points, grad_mask):
    """FPS over the foreground (fewer foreground pixels than samples in the
    second case), the back points from the JAX draws, the mask."""
    img, depth, mask = target_np()
    icfg = dict(num_points=num_points, capacity=4096, svec_val=0.05,
                mean_std=0.5)
    key = jax.random.PRNGKey(9)
    tj = sit3d_j.ImageTarget(jnp.asarray(img), jnp.asarray(depth),
                             jnp.asarray(mask))
    sj, gj = sit3d_j.image_initialize(key, init_j.InitConfig(**icfg),
                                      RenderJ(), tj, IntrJ.from_reso(RES),
                                      jnp.asarray(C2W), grad_mask=grad_mask)
    back, back_rgb = _jax_back_draws(key, num_points, 0.5)
    tt = sit3d_t.ImageTarget(t(img), t(depth), t(mask))
    st, gt = sit3d_t.image_initialize(
        init_t.InitConfig(**icfg), RenderConfig(), tt,
        CameraIntrinsics.from_reso(RES), t(C2W), torch.Generator(),
        grad_mask=grad_mask, back_mean=back, back_rgb=back_rgb)
    np.testing.assert_array_equal(st.active.numpy(), np.asarray(sj.active))
    for f in FIELDS:
        np.testing.assert_allclose(st.params[f].numpy(),
                                   np.asarray(getattr(sj.params, f)),
                                   **TOL, err_msg=f)
    if grad_mask:
        np.testing.assert_array_equal(gt.numpy(), np.asarray(gj))
        assert int(gt.sum()) == num_points
    else:
        assert gt is None and gj is None


# ---- losses ----

def test_pearson_and_l2_image_loss_match_jax():
    rng = np.random.default_rng(6)
    a, b = (rng.uniform(0, 3, (RES, RES)).astype(np.float32)
            for _ in range(2))
    np.testing.assert_allclose(
        float(losses_t.pearson_depth_loss(t(a), t(b))),
        float(losses_j.pearson_depth_loss(jnp.asarray(a), jnp.asarray(b))),
        **TOL)
    c = np.full((RES, RES), 2.0, np.float32)
    np.testing.assert_allclose(
        float(losses_t.pearson_depth_loss(t(c), t(b))),
        float(losses_j.pearson_depth_loss(jnp.asarray(c), jnp.asarray(b))),
        **TOL)
    x, y = (rng.uniform(0, 1, (RES, RES, 3)).astype(np.float32)
            for _ in range(2))
    for kind in ("l1", "l2"):
        np.testing.assert_allclose(
            float(losses_t.image_loss(t(x), t(y), 0.2, kind)),
            float(losses_j.image_loss(jnp.asarray(x), jnp.asarray(y), 0.2,
                                      kind)), **TOL)


@pytest.mark.parametrize("size", [RES, 40])
def test_sit3d_losses_and_grads_match_jax(size):
    """The target at the render's size and at 40² (resized to 32²)."""
    rng = np.random.default_rng(7)
    img = shaded_sphere(size, size)
    depth = rng.uniform(1.5, 2.5, (size, size)).astype(np.float32)
    mask = np.ones((size, size), bool)
    rgb = rng.uniform(0, 1, (3, RES, RES, 3)).astype(np.float32)
    dep = rng.uniform(1.0, 3.0, (3, RES, RES)).astype(np.float32)
    is_orig = np.array([1.0, 0.0, 1.0], np.float32)
    tj = sit3d_j.ImageTarget(jnp.asarray(img), jnp.asarray(depth),
                             jnp.asarray(mask))

    def f_j(r, d):
        out = sit3d_j.sit3d_losses({"rgb": r, "depth": d},
                                   {"is_original": jnp.asarray(is_orig)},
                                   tj, {})
        return out["loss_image"] + 10.0 * out["loss_depth"], out

    (_, lj), (g_r, g_d) = jax.value_and_grad(f_j, argnums=(0, 1),
                                             has_aux=True)(
        jnp.asarray(rgb), jnp.asarray(dep))
    r, d = t(rgb).requires_grad_(True), t(dep).requires_grad_(True)
    lt = sit3d_t.sit3d_losses({"rgb": r, "depth": d},
                              {"is_original": t(is_orig)},
                              sit3d_t.ImageTarget(t(img), t(depth), t(mask)))
    (lt["loss_image"] + 10.0 * lt["loss_depth"]).backward()
    for k in ("loss_image", "loss_depth"):
        np.testing.assert_allclose(float(lt[k].detach()), float(lj[k]), **TOL,
                                   err_msg=k)
    for got, want in ((r.grad, g_r), (d.grad, g_d)):
        want = np.asarray(want)
        assert np.abs(want[1]).max() == 0.0       # a novel view: no grad
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-4,
                                   atol=2e-5 * np.abs(want).max())


# ---- the trainer ----

LR = dict(mean=0.005, svec=0.003, qvec=0.003, color=0.01, alpha=0.003,
          bg=0.003)


def _sit3d_pair(mask_steps, prune=None):
    """Both trainers on the same image init (the JAX back draws injected),
    a single-view sampler at p 0.5, mock guidance, a fixed background."""
    img, depth, mask = target_np()
    loss = dict(sds=1.0, image=10.0, depth=0.1, sparsity=0.01)
    kw = dict(max_steps=100, batch_size=4, lr=LR)
    tcfg_j = dataclasses.replace(TcfgJ(**kw), loss=LossJ(**loss))
    tcfg_t = dataclasses.replace(TrainerConfig(**kw), loss=LossConfig(**loss))
    rkw = dict(tile_size=8, chunk=128, dup_cap=8192)
    icfg = dict(num_points=48, capacity=128, svec_val=0.06, mean_std=0.5)
    data = dict(batch_size=4, max_steps=100, reso=(RES,),
                camera_distance=(2.0, 2.0))
    pr = prune or dict(enabled=False)
    key = jax.random.PRNGKey(2)
    tj_img = sit3d_j.ImageTarget(jnp.asarray(img), jnp.asarray(depth),
                                 jnp.asarray(mask))
    rj = RenderJ(backend="pallas", pallas_interpret=True, mxu_scans=False,
                 fast_fwd_cumprod=False, **rkw)
    scene_j, gmask_j = sit3d_j.image_initialize(
        key, init_j.InitConfig(**icfg), rj, tj_img, IntrJ.from_reso(RES),
        jnp.asarray(C2W))
    tj = TrainerJ(cfg=tcfg_j, rcfg=rj, init_cfg=init_j.InitConfig(**icfg),
                  bg_cfg=BgJ(type="fixed", color=(0.1, 0.6, 0.3)),
                  data_cfg=cam_j.CameraSamplerConfig(**data),
                  guidance=MockJ(), dcfg=DensJ(enabled=False),
                  pcfg=PruneJ(**pr), image_target=tj_img, grad_mask=gmask_j,
                  mask_steps=mask_steps)
    # anisotropic, rotated Gaussians (the isotropic init's rotation
    # gradient is zero up to rounding)
    rng = np.random.default_rng(11)
    qvec = rng.standard_normal((128, 4)).astype(np.float32)
    svec = np.log(0.06 * rng.uniform(0.5, 1.5, (128, 3))).astype(np.float32)
    scene_j = scene_j._replace(params=scene_j.params._replace(
        qvec=jnp.asarray(qvec), svec=jnp.asarray(svec)))
    tj.state = tj.state._replace(scene=scene_j)
    tj.data = cam_j.SingleViewCameraPoseProvider(
        cam_j.CameraSamplerConfig(**data), seed=0, original_view_prob=0.5)

    back, back_rgb = _jax_back_draws(key, 48, 0.5)
    rcfg = RenderConfig(**rkw)
    target = sit3d_t.ImageTarget(t(img), t(depth), t(mask))
    _, gmask_t = sit3d_t.image_initialize(
        init_t.InitConfig(**icfg), rcfg, target,
        CameraIntrinsics.from_reso(RES), t(C2W), torch.Generator(),
        back_mean=back, back_rgb=back_rgb)
    tt = Trainer(cfg=tcfg_t, rcfg=rcfg, init_cfg=init_t.InitConfig(**icfg),
                 bg_cfg=BackgroundConfig(type="fixed", color=(0.1, 0.6, 0.3)),
                 data_cfg=cam_t.CameraSamplerConfig(**data),
                 guidance=MockGuidance(), dcfg=DensifyConfig(enabled=False),
                 pcfg=PruneConfig(**pr), image_target=target,
                 grad_mask=gmask_t, mask_steps=mask_steps, device="cpu")
    tt.state = train_state_from_jax_arrays(_flatten_with_paths(tj.state),
                                           "cpu")
    tt.data = cam_t.SingleViewCameraPoseProvider(
        cam_t.CameraSamplerConfig(**data), seed=0, original_view_prob=0.5)
    return tj, tt


def _check_step(tj, tt, s, keys):
    m_j, m_t = tj.train_step(s), tt.train_step(s)
    for k in keys:
        np.testing.assert_allclose(float(m_t[k]), float(m_j[k]), rtol=1e-4,
                                   err_msg=f"step {s} {k}")
    arrays = _flatten_with_paths(tj.state)
    for f in FIELDS:
        mu_j = arrays[f".opt/.mu/[0]/.{f}"]
        np.testing.assert_allclose(tt.state.opt.mu[f].numpy(), mu_j,
                                   rtol=2e-3, atol=2e-4 * np.abs(mu_j).max(),
                                   err_msg=f"step {s} mu {f}")
    return m_t, arrays


@pytest.mark.parametrize("mask_on", [True, False])
def test_sit3d_trainer_step_matches_jax(mask_on):
    """One step: the image and depth losses of the original views, every
    field's gradient; with the mask window on, the 48 front rows' moments
    are 0 and their parameters bitwise unchanged, in both packages."""
    tj, tt = _sit3d_pair((0, 10) if mask_on else (5, 10))
    p0 = {f: v.clone() for f, v in tt.state.scene.params.items()}
    sched = tt.sched_scalars(0)
    assert sched["grad_mask_on"] == tj.sched_scalars(0)["grad_mask_on"] \
        == float(mask_on)
    assert (sched["w_image"], sched["w_depth"]) == (10.0, 0.1)
    m_t, arrays = _check_step(tj, tt, 0, ("loss_image", "loss_depth",
                                          "loss_sds", "loss_total"))
    assert float(m_t["loss_image"]) > 0 and float(m_t["loss_depth"]) != 0
    for f in FIELDS:
        front = tt.state.scene.params[f][:48]
        moved = tt.state.scene.params[f][48:96] != p0[f][48:96]
        assert bool(moved.any()), f
        if mask_on:
            assert torch.equal(front, p0[f][:48]), f
            np.testing.assert_array_equal(
                arrays[f".scene/.params/.{f}"][:48], p0[f][:48].numpy())
            assert not bool(tt.state.opt.mu[f][:48].any()), f
        else:
            assert not torch.equal(front, p0[f][:48]), f


def test_sit3d_mask_through_prune_matches_jax():
    """A prune event inside the mask window (its alpha threshold halfway
    between the moved rows' lowest and highest opacity after step 0): the
    mask stays on row indices, as in the JAX package, and the next step
    matches."""
    prune = dict(enabled=True, warm_up=0, end=10, period=1,
                 radii2d_thresh=0.0, alpha_thresh=0.5)
    tj, tt = _sit3d_pair((0, 10), prune)
    keys = ("loss_image", "loss_depth", "loss_total")
    _check_step(tj, tt, 0, keys)
    alpha = torch.sigmoid(tt.state.scene.params["alpha"][48:96])
    assert float(alpha.min()) < float(alpha.max())
    thresh = 0.5 * float(alpha.min() + alpha.max())
    tj.pcfg = dataclasses.replace(tj.pcfg, alpha_thresh=thresh)
    tt.pcfg = dataclasses.replace(tt.pcfg, alpha_thresh=thresh)
    info_t, info_j = tt.density_step(0), tj.density_step(0)
    assert info_t["num_pruned_alpha"] == info_j["num_pruned_alpha"] > 0
    np.testing.assert_array_equal(tt.state.scene.active.numpy(),
                                  np.asarray(tj.state.scene.active))
    _check_step(tj, tt, 1, keys)


# ---- build_trainer on an image: block ----

SMALL = ["init.num_points=64", "init.capacity=256", "data.reso=[32]",
         "renderer.tile_size=8", "renderer.chunk=128",
         "renderer.dup_cap=8192", "trainer.batch_size=2",
         "prompt.use_cache=false", "guidance.type=mock",
         "renderer.background.type=fixed"]
SIT3D = [ROOT / "configs" / "base.yaml", ROOT / "configs" / "data" /
         "sit3d.yaml"]


def test_build_trainer_image_block(tmp_path):
    """base.yaml + data/sit3d.yaml + image.path in both packages (the same
    config dict): the matted target, the gradient mask and the front rows
    (FPS over the lifted foreground; the back rows are each package's own
    draws), the single-view sampler; a step logs the image losses.  A
    block without a path, or estimators not enabled, build as before."""
    write_png(tmp_path / "in.png", shaded_sphere())
    # a depth map without ties (FPS over a plane breaks its many exact
    # ties by each package's rounding)
    depth = np.random.default_rng(3).uniform(1.7, 1.9, (RES, RES))
    np.save(tmp_path / "depth.npy", depth.astype(np.float32))
    over = SMALL + [f"image.path={tmp_path / 'in.png'}",
                    f"image.depth={tmp_path / 'depth.npy'}",
                    "image.distance=2.0", "estimators.depth.enabled=false"]
    cfg = load_config(SIT3D, over)
    tt = build_trainer(copy.deepcopy(cfg), device="cpu")
    tj = build_trainer_j(copy.deepcopy(cfg))
    assert isinstance(tt.data, cam_t.SingleViewCameraPoseProvider)
    assert tt.data.original_view_prob == tj.data.original_view_prob == 0.2
    assert tt.estimators == {} == tj.estimators
    tgt_j = tj.image_target
    np.testing.assert_array_equal(tt.image_target.mask.numpy(),
                                  np.asarray(tgt_j.mask))
    assert 0 < int(tt.image_target.mask.sum()) < RES * RES
    np.testing.assert_allclose(tt.image_target.image.numpy(),
                               np.asarray(tgt_j.image), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(tt.image_target.depth.numpy(),
                                  np.asarray(tgt_j.depth))
    np.testing.assert_array_equal(tt.grad_mask.numpy(),
                                  np.asarray(tj.grad_mask))
    assert tt.mask_steps == tuple(tj.mask_steps) == (0, 1000)
    n = int(tt.grad_mask.sum())
    assert n == 64
    for f in ("mean", "color"):
        np.testing.assert_allclose(
            tt.state.scene.params[f][:n].numpy(),
            np.asarray(getattr(tj.state.scene.params, f))[:n], **TOL)
    x = tt.state.scene.params["mean"][:n, 0].numpy()
    assert ((x > 0.1 - 1e-5) & (x < 0.3 + 1e-5)).all()
    tt.data.original_view_prob = 1.0
    m = tt.train_step(0)
    assert float(m["loss_image"]) > 0 and np.isfinite(float(m["loss_depth"]))
    # a block without a path configures only
    plain = build_trainer(load_config(SIT3D, SMALL), device="cpu")
    assert plain.image_target is None and plain.grad_mask is None
    assert type(plain.data) is cam_t.CameraPoseProvider


def test_main_runs_image_mode_on_cpu(tmp_path, capsys):
    from gsgen_torch import main as main_mod
    write_png(tmp_path / "in.png", shaded_sphere())
    assert main_mod.main([
        "--config", str(SIT3D[0]), "--config", str(SIT3D[1]), "--steps",
        "2", "--device", "cpu", "--no-log", *SMALL,
        f"image.path={tmp_path / 'in.png'}"]) == 0
    assert "step      1" in capsys.readouterr().out
