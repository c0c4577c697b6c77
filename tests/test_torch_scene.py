"""gsgen_torch scene rendering vs the JAX package: ``render_view`` and
``render_batch`` from the same raw params (``scene_from_numpy``), values
and gradients, including the ``mean2d_tap`` gradients densify reads.

The JAX side renders with its Pallas kernels in interpret mode with the
exact scans (``mxu_scans=False``, ``fast_fwd_cumprod=False``); the port
renders with backend ``auto`` on CPU tensors, i.e. the kernels' plain
versions.  Tolerances: image-space outputs rtol 1e-4 / atol 1e-5 (fp32,
summation order); gradients rtol 2e-3 / atol 2e-4 relative to each
field's largest gradient (the kernels' suffix trick vs autograd,
accumulated through projection).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsgen_tpu.models.scene import GaussianParams
from gsgen_tpu.models.scene import RenderConfig as RenderConfigJ
from gsgen_tpu.models.scene import render_batch as batch_j
from gsgen_tpu.models.scene import render_view as view_j
from gsgen_tpu.ops.camera import CameraIntrinsics as IntrJ
from gsgen_torch.data.cameras import CameraPoseProvider, CameraSamplerConfig
from gsgen_torch.models.scene import (FIELDS, RenderConfig, make_scene,
                                      render_batch, render_view,
                                      scene_from_numpy)
from gsgen_torch.ops.camera import CameraIntrinsics
from torch_fixtures import RES, scene3d, t

KW = dict(tile_size=8, chunk=128, dup_cap=4096)
RCFG_J = RenderConfigJ(backend="pallas", pallas_interpret=True,
                       mxu_scans=False, fast_fwd_cumprod=False, **KW)
RCFG_T = RenderConfig(**KW)
OUT_KEYS = ("rgb", "T", "depth", "opacity", "z_var", "radii2d")


def _batch(B, seed=0):
    cfg = CameraSamplerConfig(batch_size=B, reso=(RES,),
                              camera_distance=(2.0, 2.5))
    return CameraPoseProvider(cfg, seed=seed).get_batch()


def _params_j(raw):
    return GaussianParams(**{f: jnp.asarray(raw[f]) for f in FIELDS})


def _check_outputs(out_t, out_j):
    for k in OUT_KEYS:
        np.testing.assert_allclose(out_t[k].detach().numpy(),
                                   np.asarray(out_j[k]), rtol=1e-4,
                                   atol=1e-5, err_msg=k)
    np.testing.assert_array_equal(out_t["visible"].numpy(),
                                  np.asarray(out_j["visible"]))
    np.testing.assert_array_equal(out_t["n_dup"].numpy(),
                                  np.asarray(out_j["n_dup"]))


def _check_grads(g_t, g_j):
    for k in g_t:
        a, b = g_t[k], np.asarray(g_j[k])
        scale = max(float(np.abs(b).max()), 1e-6)
        np.testing.assert_allclose(a, b, rtol=2e-3, atol=2e-4 * scale,
                                   err_msg=k)


@pytest.mark.parametrize("rgb_only", [False, True])
def test_render_view_matches_jax(rgb_only):
    raw = scene3d(150, seed=1, capacity=192)
    b = _batch(1, seed=2)
    intr_j, intr_t = IntrJ.from_reso(RES), CameraIntrinsics.from_reso(RES)
    cam = {k: b[k][0] for k in ("c2w", "fx", "fy", "cx", "cy")}
    bg = np.array([0.2, 0.5, 0.9], np.float32)
    rng = np.random.default_rng(3)
    w = rng.standard_normal((RES, RES, 3)).astype(np.float32)
    wd = rng.standard_normal((RES, RES)).astype(np.float32)

    def loss_j(p, tap):
        o = view_j(p, jnp.asarray(raw["active"]), jnp.asarray(cam["c2w"]),
                   intr_j, RCFG_J, jnp.asarray(bg),
                   *(jnp.float32(cam[k]) for k in ("fx", "fy", "cx", "cy")),
                   rgb_only=rgb_only, mean2d_tap=tap)
        extra = 0.0 if rgb_only else 0.1 * jnp.sum(o["depth"] * wd)
        return jnp.sum(o["rgb"] * w) + jnp.sum(o["T"] * wd) + extra, o

    tap0 = jnp.zeros((192, 2), jnp.float32)
    (g_p, g_tap), out_j = jax.grad(loss_j, argnums=(0, 1), has_aux=True)(
        _params_j(raw), tap0)

    scene = scene_from_numpy(raw, "cpu")
    params = {k: v.requires_grad_(True) for k, v in scene.params.items()}
    tap = torch.zeros(192, 2, requires_grad=True)
    out_t = render_view(params, scene.active, cam["c2w"], intr_t, RCFG_T,
                        bg, cam["fx"], cam["fy"], cam["cx"], cam["cy"],
                        rgb_only=rgb_only, mean2d_tap=tap)
    extra = 0.0 if rgb_only else 0.1 * (out_t["depth"] * t(wd)).sum()
    ((out_t["rgb"] * t(w)).sum() + (out_t["T"] * t(wd)).sum()
     + extra).backward()

    if rgb_only:
        for k in ("rgb", "T"):
            np.testing.assert_allclose(out_t[k].detach().numpy(),
                                       np.asarray(out_j[k]), rtol=1e-4,
                                       atol=1e-5, err_msg=k)
    else:
        _check_outputs(out_t, out_j)
    g_t = {k: params[k].grad.numpy() for k in FIELDS}
    g_t["mean2d_tap"] = tap.grad.numpy()
    g_jd = {k: getattr(g_p, k) for k in FIELDS}
    g_jd["mean2d_tap"] = g_tap
    _check_grads(g_t, g_jd)
    assert np.abs(g_t["mean2d_tap"]).max() > 0


def test_render_batch_matches_jax_with_taps():
    raw = scene3d(120, seed=4, capacity=128)
    B = 2
    b = _batch(B, seed=5)
    intr_j, intr_t = IntrJ.from_reso(RES), CameraIntrinsics.from_reso(RES)
    bgs = np.array([[1.0, 1.0, 1.0], [0.0, 0.3, 0.6]], np.float32)

    def loss_j(p, taps):
        o = batch_j(p, jnp.asarray(raw["active"]), jnp.asarray(b["c2w"]),
                    intr_j, RCFG_J, jnp.asarray(bgs),
                    *(jnp.asarray(b[k]) for k in ("fx", "fy", "cx", "cy")),
                    mean2d_taps=taps)
        return jnp.sum(o["rgb"] ** 2) + jnp.sum(o["opacity"]), o

    (g_p, g_taps), out_j = jax.grad(loss_j, argnums=(0, 1), has_aux=True)(
        _params_j(raw), jnp.zeros((B, 128, 2), jnp.float32))

    scene = scene_from_numpy(raw, "cpu")
    params = {k: v.requires_grad_(True) for k, v in scene.params.items()}
    taps = torch.zeros(B, 128, 2, requires_grad=True)
    out_t = render_batch(params, scene.active, t(b["c2w"]), intr_t, RCFG_T,
                         t(bgs), t(b["fx"]), t(b["fy"]), t(b["cx"]),
                         t(b["cy"]), mean2d_taps=taps)
    ((out_t["rgb"] ** 2).sum() + out_t["opacity"].sum()).backward()
    _check_outputs(out_t, out_j)
    g_t = {k: params[k].grad.numpy() for k in FIELDS}
    g_t["mean2d_taps"] = taps.grad.numpy()
    g_jd = {k: getattr(g_p, k) for k in FIELDS}
    g_jd["mean2d_taps"] = g_taps
    _check_grads(g_t, g_jd)


def test_make_scene_padding_and_unported_features():
    cfg = RenderConfig()
    sc = make_scene(torch.zeros(3, 3), torch.tensor([[1.0, 0, 0, 0]] * 3),
                    torch.full((3, 3), 0.02), torch.full((3, 3), 0.5),
                    torch.full((3,), 0.8), cfg, capacity=5)
    assert sc.active.tolist() == [True] * 3 + [False] * 2
    assert sc.params["alpha"][3:].tolist() == [-10.0, -10.0]
    assert sc.params["qvec"][4].tolist() == [1.0, 0.0, 0.0, 0.0]
    np.testing.assert_allclose(sc.params["svec"][4].numpy(), np.log(1e-4),
                               rtol=1e-6)
    for bad in (dict(binning_layout="tiled"), dict(backend="triton")):
        with pytest.raises(ValueError):
            render_view(sc.params, sc.active, np.eye(3, 4, dtype=np.float32),
                        CameraIntrinsics.from_reso(16),
                        dataclasses.replace(cfg, **bad), np.ones(3))
    # tile_mesh is ported (parallel/sharded_render.py): a view whose
    # height does not divide into the mesh's slabs of whole tile rows is
    # refused before any collective runs

    class FourSlabs:
        """What the tile-sharded render reads of a mesh before rendering."""
        mesh_dim_names = ("tile",)

        def size(self, dim):
            return 4

        def get_local_rank(self, axis):
            return 0

        def get_group(self, axis):
            return None

    with pytest.raises(ValueError, match="must divide by devices"):
        render_batch(sc.params, sc.active, np.eye(3, 4, dtype=np.float32)[None],
                     CameraIntrinsics.from_reso(16), cfg, np.ones((1, 3)),
                     tile_mesh=FourSlabs())
