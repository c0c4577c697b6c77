"""gsgen_torch's compact binning layout (the plain versions of kernels K8 and
K9) vs the JAX package's compact path, and vs the port's padded layout.

The JAX side runs ``bin_gaussians(layout="compact")`` and its compact
Pallas kernels in interpret mode with the exact scans (``mxu_scans=False``,
``fast_fwd_cumprod=False``).  Tolerances: binning fields and the window
count row exact; T rtol 1e-5 / atol 1e-6, image rtol 1e-4 / atol 1e-5 and
gradients rtol 2e-3 / atol 2e-4 (5e-3 / 5e-4 on the early-exit scene) are
tests/test_torch_raster.py's gates.  Compact against padded in the port:
image and T rtol 1e-6 / atol 1e-7, gradients rtol 1e-5 / atol 2e-5, the
gates tests/test_pallas.py::test_compact_layout_matches_padded holds the
JAX pair to (boundary windows regroup the fp32 sums).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gsgen_tpu.models.scene as scene_jax
from gsgen_tpu.models.scene import GaussianParams
from gsgen_tpu.models.scene import RenderConfig as RenderConfigJ
from gsgen_tpu.ops.binning import bin_gaussians as bin_jax
from gsgen_tpu.ops.camera import CameraIntrinsics as IntrJ
from gsgen_tpu.ops.pallas_raster import (_make_core_compact, pack_dup,
                                         rasterize_tiles_pallas)
import gsgen_torch.models.scene as scene_torch
from gsgen_torch.models.scene import (FIELDS, RenderConfig, render_view,
                                      scene_from_numpy)
from gsgen_torch.ops import cuda_raster
from gsgen_torch.ops.binning import bin_gaussians as bin_torch
from gsgen_torch.ops.camera import CameraIntrinsics
from torch_fixtures import CHUNK, FX, RES, TILE, conic_np, scene2d, scene3d, t

TOPLEFT = (-1.0, -1.0)
PSZ = (1.0 / FX, 1.0 / FX)
KEPT = ("starts", "ends", "total", "gid_cum", "padded_total", "gid_s")
NONE = ("padded_gid", "row_valid", "chunk_tile")


def _scene(n, seed, alpha=None, corner=False, cov_scale=0.02):
    mean2d, cov2d, a, feats, depth = scene2d(
        n, seed, spread=0.35 if corner else 0.6, alpha=alpha,
        cov_scale=cov_scale)
    if corner:
        # Gaussians in the top-left quadrant only: the other tiles are
        # empty and start wherever the sorted table's demand ended
        mean2d = mean2d - np.float32(0.45)
    return mean2d, cov2d, a, feats, depth


def _bins(scene, cap, radius, layout="compact"):
    mean2d, cov2d, a, _, depth = scene
    n = mean2d.shape[0]
    args = (mean2d, cov2d, depth, np.arange(n) % 9 != 4, FX, FX, RES / 2.0,
            RES / 2.0, RES, RES, TILE, cap)
    kw = dict(chunk=CHUNK, tile_culling_radius=radius, layout=layout)
    bj = bin_jax(*[jnp.asarray(x) if isinstance(x, np.ndarray) else x
                   for x in args], alpha=jnp.asarray(a), **kw)
    bt = bin_torch(*[t(x) if isinstance(x, np.ndarray) else x
                     for x in args], alpha=t(a), **kw)
    return bj, bt


CASES = {
    "generic": dict(n=60, seed=0, cap=2048, radius=60.0),
    "overflow": dict(n=300, seed=2, cap=256, radius=6.0),
    "corner": dict(n=40, seed=5, cap=2048, radius=6.0, corner=True),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_compact_bins_exact(case):
    c = CASES[case]
    bj, bt = _bins(_scene(c["n"], c["seed"], corner=c.get("corner", False)),
                   c["cap"], c["radius"])
    for f in KEPT:
        a, b = np.asarray(getattr(bj, f)), getattr(bt, f).numpy()
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(b, a, err_msg=f)
    for f in NONE:
        assert getattr(bt, f) is None and getattr(bj, f) is None, f
    starts, ends = bt.starts.numpy(), bt.ends.numpy()
    if case == "overflow":
        assert int(bt.total) > c["cap"] and ends[-1] == c["cap"]
        assert (bt.gid_s.numpy() < c["n"]).all()
    if case == "corner":
        empty = (starts == ends) & (starts % CHUNK != 0)
        assert empty.any()                  # an empty, unaligned tile
        assert (bt.gid_s.numpy()[int(bt.total):] == c["n"]).all()


def _rasterize(bins, args, jax_side):
    if jax_side:
        return rasterize_tiles_pallas(
            *args, bins, TOPLEFT, PSZ, w=RES, h=RES, tile_size=TILE,
            chunk=CHUNK, interpret=True, mxu_scans=False,
            fast_fwd_cumprod=False)
    return cuda_raster.rasterize_tiles_cuda(
        *args, bins, TOPLEFT, PSZ, w=RES, h=RES, tile_size=TILE, chunk=CHUNK)


def _forward_and_grads(bj, bt, args, gimg, gT):
    def loss_j(*p):
        img, T = _rasterize(bj, p, True)
        return jnp.sum(img * gimg) + jnp.sum(T * gT), (img, T)

    g_j, (img_j, T_j) = jax.grad(loss_j, argnums=(0, 1, 2, 3),
                                 has_aux=True)(*map(jnp.asarray, args))
    ps = [t(x).requires_grad_(True) for x in args]
    img_t, T_t = _rasterize(bt, ps, False)
    (torch.sum(img_t * t(gimg)) + torch.sum(T_t * t(gT))).backward()
    return ((img_t.detach().numpy(), T_t.detach().numpy(),
             [p.grad.numpy() for p in ps]),
            (np.asarray(img_j), np.asarray(T_j),
             [np.asarray(g) for g in g_j]))


@pytest.mark.parametrize("case", ["generic", "corner", "early_exit"])
def test_compact_forward_and_gradients_match_pallas(case):
    scene = _scene(80 if case == "early_exit" else 60,
                   {"generic": 1, "corner": 5, "early_exit": 3}[case],
                   alpha=0.999 if case == "early_exit" else None,
                   corner=case == "corner")
    bj, bt = _bins(scene, 2048, 6.0 if case == "corner" else 60.0)
    mean2d, cov2d, a, feats, _ = scene
    args = (mean2d, conic_np(cov2d), a, feats)
    rng = np.random.default_rng(99)
    gimg = rng.standard_normal((RES, RES, 5)).astype(np.float32)
    gT = rng.standard_normal((RES, RES)).astype(np.float32)
    (img_t, T_t, g_t), (img_j, T_j, g_j) = _forward_and_grads(
        bj, bt, args, gimg, gT)
    np.testing.assert_allclose(T_t, T_j, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(img_t, img_j, rtol=1e-4, atol=1e-5)
    rtol, atol = (5e-3, 5e-4) if case == "early_exit" else (2e-3, 2e-4)
    for name, x, y in zip(["mean2d", "conic", "alpha", "feats"], g_t, g_j):
        np.testing.assert_allclose(x, y, rtol=rtol, atol=atol, err_msg=name)
    assert np.abs(g_t[0]).max() > 0


@pytest.mark.parametrize("case", ["corner", "early_exit"])
def test_window_count_row_matches_pallas(case):
    """K8's plain version writes the windows each tile processed, exactly
    as the TPU kernel: 1 for an empty tile with an unaligned start, fewer
    than its window count for a tile that left early."""
    if case == "corner":
        scene = _scene(40, 5, corner=True)
    else:   # wide, nearly opaque Gaussians: tiles leave after 1 of 2-3
        scene = _scene(200, 3, alpha=0.999, cov_scale=0.2)
    bj, bt = _bins(scene, 4096, 6.0)
    mean2d, cov2d, a, feats, _ = scene
    args = (mean2d, conic_np(cov2d), a, feats)
    dup = cuda_raster.pack_dup(*map(t, args), bt.gid_s,
                               torch.ones_like(bt.gid_s, dtype=torch.bool))
    wcount = cuda_raster.window_counts(bt.starts, bt.ends, CHUNK)
    geom = torch.tensor([*TOPLEFT, *PSZ], dtype=torch.float32)
    out = cuda_raster.raster_fwd_compact(
        dup, bt.starts, bt.ends, wcount, geom, n_tiles_w=4, tile_size=TILE,
        chunk=CHUNK, F=5, ch_out=8, T_thresh=1e-4)
    cap = int(bj.gid_s.shape[0])
    dup_j = pack_dup(*map(jnp.asarray, args), bj.gid_s,
                     jnp.ones((cap,), bool), cap)
    core = _make_core_compact(16, 4, TILE, CHUNK, 5, cap,
                              int(bj.step_tile.shape[0]), 1e-4, True,
                              mxu_scans=False)
    wc_j = (bj.ends + CHUNK - 1) // CHUNK - bj.starts // CHUNK
    np.testing.assert_array_equal(wcount.numpy(), np.asarray(wc_j))
    out_j = core(dup_j, bj.step_tile, bj.step_window, bj.starts, bj.ends,
                 wc_j.astype(jnp.int32),
                 jnp.asarray([*TOPLEFT, *PSZ], jnp.float32))
    cnt = out[:, 7, :].numpy()
    np.testing.assert_array_equal(cnt, np.asarray(out_j[:, 7, :]))
    np.testing.assert_allclose(out.numpy(), np.asarray(out_j), rtol=1e-4,
                               atol=1e-5)
    starts, ends = bt.starts.numpy(), bt.ends.numpy()
    if case == "corner":
        empty = (starts == ends) & (starts % CHUNK != 0)
        assert empty.any() and (cnt[empty] == 1).all()
    else:
        assert (cnt[:, 0] < wcount.numpy()).any()


@pytest.mark.parametrize("case", ["generic", "early_exit"])
def test_compact_matches_padded_in_port(case):
    scene = _scene(96, 0 if case == "generic" else 3,
                   alpha=0.999 if case == "early_exit" else None)
    mean2d, cov2d, a, feats, _ = scene
    args = (mean2d, conic_np(cov2d), a, feats)
    rng = np.random.default_rng(7)
    gimg = rng.uniform(size=(RES, RES, 5)).astype(np.float32)
    gT = rng.uniform(size=(RES, RES)).astype(np.float32)
    res = []
    for layout in ("padded", "compact"):
        _, bt = _bins(scene, 2048, 6.0, layout=layout)
        ps = [t(x).requires_grad_(True) for x in args]
        img, T = _rasterize(bt, ps, False)
        (torch.sum(img * t(gimg)) + torch.sum(T * t(gT))).backward()
        res.append((img.detach().numpy(), T.detach().numpy(),
                    [p.grad.numpy() for p in ps]))
    (img_p, T_p, g_p), (img_c, T_c, g_c) = res
    np.testing.assert_allclose(img_c, img_p, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(T_c, T_p, rtol=1e-6, atol=1e-7)
    for x, y in zip(g_c, g_p):
        np.testing.assert_allclose(x, y, rtol=1e-5, atol=2e-5)


KW = dict(tile_size=8, chunk=128, dup_cap=4096, binning_layout="compact")


def test_render_view_compact_matches_jax():
    raw = scene3d(150, seed=1, capacity=192)
    c2w = np.array([[1, 0, 0, 0.1], [0, 1, 0, -0.2], [0, 0, 1, -2.5]],
                   np.float32)
    bg = np.array([0.2, 0.5, 0.9], np.float32)
    rng = np.random.default_rng(3)
    w = rng.standard_normal((RES, RES, 3)).astype(np.float32)
    wd = rng.standard_normal((RES, RES)).astype(np.float32)
    rcfg_j = RenderConfigJ(backend="pallas", pallas_interpret=True,
                           mxu_scans=False, fast_fwd_cumprod=False, **KW)

    def loss_j(p):
        o = scene_jax.render_view(p, jnp.asarray(raw["active"]),
                                  jnp.asarray(c2w), IntrJ.from_reso(RES),
                                  rcfg_j, jnp.asarray(bg))
        return (jnp.sum(o["rgb"] * w) + jnp.sum(o["T"] * wd)
                + 0.1 * jnp.sum(o["depth"] * wd)), o

    g_j, out_j = jax.grad(loss_j, has_aux=True)(GaussianParams(
        **{f: jnp.asarray(raw[f]) for f in FIELDS}))
    sc = scene_from_numpy(raw, "cpu")
    params = {k: v.requires_grad_(True) for k, v in sc.params.items()}
    out_t = render_view(params, sc.active, c2w, CameraIntrinsics.from_reso(
        RES), RenderConfig(**KW), bg)
    ((out_t["rgb"] * t(w)).sum() + (out_t["T"] * t(wd)).sum()
     + 0.1 * (out_t["depth"] * t(wd)).sum()).backward()
    for k in ("rgb", "T", "depth", "opacity", "z_var", "radii2d"):
        np.testing.assert_allclose(out_t[k].detach().numpy(),
                                   np.asarray(out_j[k]), rtol=1e-4,
                                   atol=1e-5, err_msg=k)
    assert int(out_t["n_dup"]) == int(out_j["n_dup"])
    for f in FIELDS:
        b = np.asarray(getattr(g_j, f))
        np.testing.assert_allclose(params[f].grad.numpy(), b, rtol=2e-3,
                                   atol=2e-4 * max(np.abs(b).max(), 1e-6),
                                   err_msg=f)


class _Stop(Exception):
    pass


@pytest.mark.parametrize("reso,tile,want", [(512, 16, "compact"),
                                            (1024, 16, "padded"),
                                            (32, 8, "compact")])
def test_layout_gate_matches_jax(monkeypatch, reso, tile, want):
    """Both packages pick the same layout: compact while the cotangents
    (n_tiles * 8 * P * 4 bytes) fit 9 MiB, padded above (1024^2 at tile
    16: 16 MiB).  Each side's binner records its layout and stops."""
    seen = {}

    def record(side):
        def fn(*args, layout="padded", **kw):
            seen[side] = layout
            raise _Stop
        return fn

    monkeypatch.setattr(scene_jax, "bin_gaussians", record("jax"))
    monkeypatch.setattr(scene_torch, "bin_gaussians", record("torch"))
    raw = scene3d(8, seed=2)
    c2w = np.eye(3, 4, dtype=np.float32)
    kw = dict(KW, tile_size=tile)
    with pytest.raises(_Stop):
        scene_jax.render_view(
            GaussianParams(**{f: jnp.asarray(raw[f]) for f in FIELDS}),
            jnp.asarray(raw["active"]), jnp.asarray(c2w),
            IntrJ.from_reso(reso), RenderConfigJ(backend="pallas", **kw),
            jnp.ones(3))
    sc = scene_from_numpy(raw, "cpu")
    with pytest.raises(_Stop):
        render_view(sc.params, sc.active, c2w,
                    CameraIntrinsics.from_reso(reso), RenderConfig(**kw),
                    np.ones(3, np.float32))
    assert seen == {"jax": want, "torch": want}
    # backend "xla" keeps the padded layout in both packages
    assert scene_torch.binning_layout(
        dataclasses.replace(RenderConfig(**kw), backend="xla"), 4,
        False) == "padded"
