"""gsgen_torch compositing (the autograd Function on CPU tensors, i.e. the
plain versions of kernels K1/K2) vs
the JAX package's Pallas kernels in interpret mode and the dense oracle,
forward and gradients.

Tolerances: T rtol 1e-5 / atol 1e-6 and image rtol 1e-4 / atol 1e-5 are
tests/test_pallas.py's forward gates (fp32 with different summation
order).  Gradients rtol 2e-3 / atol 2e-4 are its gradient gates: the
kernels' suffix trick and the autograd path cancel differently.  The
early-exit scene uses test_pallas.py's 5e-3 / 5e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsgen_tpu.ops.binning import bin_gaussians as bin_jax
from gsgen_tpu.ops.oracle import composite_dense as dense_jax
from gsgen_tpu.ops.oracle import pixel_grid as grid_jax
from gsgen_tpu.ops.pallas_raster import rasterize_tiles_pallas
from gsgen_torch.ops import cuda_raster
from gsgen_torch.ops.binning import bin_gaussians as bin_torch
from gsgen_torch.ops.oracle import composite_dense, pixel_grid
from torch_fixtures import CHUNK, FX, RES, TILE, conic_np, scene2d, t

TOPLEFT = (-1.0, -1.0)
PSZ = (1.0 / FX, 1.0 / FX)


def _inputs(n, seed, F=5, alpha=None, radius=60.0):
    mean2d, cov2d, a, feats, depth = scene2d(n, seed, F=F, alpha=alpha)
    conic = conic_np(cov2d)
    active = np.ones(n, bool)
    args = (mean2d, cov2d, depth, active, FX, FX, RES / 2.0, RES / 2.0,
            RES, RES, TILE, 4096)
    kw = dict(chunk=CHUNK, tile_culling_radius=radius)
    bj = bin_jax(*[jnp.asarray(x) if isinstance(x, np.ndarray) else x
                   for x in args], **kw)
    bt = bin_torch(*[t(x) if isinstance(x, np.ndarray) else x
                     for x in args], **kw)
    return (mean2d, conic, a, feats, depth, active), bj, bt


def _jax_pallas(bins):
    def f(mean2d, conic, alpha, feats):
        return rasterize_tiles_pallas(
            mean2d, conic, alpha, feats, bins, TOPLEFT, PSZ, w=RES, h=RES,
            tile_size=TILE, chunk=CHUNK, interpret=True, mxu_scans=False,
            fast_fwd_cumprod=False)
    return f


def _torch_fn(bins):
    def f(mean2d, conic, alpha, feats):
        return cuda_raster.rasterize_tiles_cuda(
            mean2d, conic, alpha, feats, bins, TOPLEFT, PSZ, w=RES, h=RES,
            tile_size=TILE, chunk=CHUNK)
    return f


@pytest.mark.parametrize("F", [3, 5])
def test_forward_matches_pallas_and_dense(F):
    (mean2d, conic, a, feats, depth, active), bj, bt = _inputs(60, 0, F=F)
    img_j, T_j = _jax_pallas(bj)(*map(jnp.asarray, (mean2d, conic, a,
                                                    feats)))
    img_t, T_t = _torch_fn(bt)(*map(t, (mean2d, conic, a, feats)))
    np.testing.assert_allclose(T_t.numpy(), np.asarray(T_j),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(img_t.numpy(), np.asarray(img_j),
                               rtol=1e-4, atol=1e-5)
    pix = pixel_grid(TOPLEFT, PSZ, RES, RES)
    out_d, T_d = composite_dense(*map(t, (mean2d, conic, a, feats, depth,
                                          active)), pix)
    np.testing.assert_allclose(T_t.numpy().reshape(-1), T_d.numpy(),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(img_t.numpy().reshape(-1, F), out_d.numpy(),
                               rtol=1e-4, atol=1e-5)


def test_dense_oracle_matches_jax_oracle():
    mean2d, cov2d, a, feats, depth = scene2d(40, 4)
    conic = conic_np(cov2d)
    active = np.arange(40) % 5 != 0
    pix_j = grid_jax(TOPLEFT, PSZ, RES, RES)
    pix_t = pixel_grid(TOPLEFT, PSZ, RES, RES)
    np.testing.assert_array_equal(pix_t.numpy(), np.asarray(pix_j))
    out_j, T_j = dense_jax(*map(jnp.asarray, (mean2d, conic, a, feats,
                                              depth, active)), pix_j)
    out_t, T_t = composite_dense(*map(t, (mean2d, conic, a, feats, depth,
                                          active)), pix_t)
    np.testing.assert_allclose(T_t.numpy(), np.asarray(T_j), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), rtol=1e-4,
                               atol=1e-5)


def _grads_jax(fn, args, gimg, gT):
    def loss(*p):
        img, T = fn(*p)
        return jnp.sum(img * gimg) + jnp.sum(T * gT)
    return jax.grad(loss, argnums=(0, 1, 2, 3))(*map(jnp.asarray, args))


def _grads_torch(fn, args, gimg, gT):
    ps = [t(x).requires_grad_(True) for x in args]
    img, T = fn(*ps)
    (torch.sum(img * t(gimg)) + torch.sum(T * t(gT))).backward()
    return [p.grad.numpy() for p in ps]


def test_gradients_match_pallas():
    (mean2d, conic, a, feats, _, _), bj, bt = _inputs(40, 1)
    rng = np.random.default_rng(99)
    gimg = rng.standard_normal((RES, RES, 5)).astype(np.float32)
    gT = rng.standard_normal((RES, RES)).astype(np.float32)
    args = (mean2d, conic, a, feats)
    g_j = _grads_jax(_jax_pallas(bj), args, gimg, gT)
    g_t = _grads_torch(_torch_fn(bt), args, gimg, gT)
    for name, x, y in zip(["mean2d", "conic", "alpha", "feats"], g_t, g_j):
        np.testing.assert_allclose(x, np.asarray(y), rtol=2e-3, atol=2e-4,
                                   err_msg=name)


def test_early_exit_scene_forward_and_gradients():
    """Opaque scene: tiles exit early, grads behind the front are zero."""
    (mean2d, conic, a, feats, depth, active), bj, bt = _inputs(
        80, 3, alpha=0.999)
    fn_t = _torch_fn(bt)
    img_j, T_j = _jax_pallas(bj)(*map(jnp.asarray, (mean2d, conic, a,
                                                    feats)))
    img_t, T_t = fn_t(*map(t, (mean2d, conic, a, feats)))
    np.testing.assert_allclose(T_t.numpy(), np.asarray(T_j), rtol=1e-5,
                               atol=1e-7)
    np.testing.assert_allclose(img_t.numpy(), np.asarray(img_j), rtol=1e-4,
                               atol=1e-5)
    gimg = 2.0 * np.asarray(img_j)
    gT = np.ones((RES, RES), np.float32)
    args = (mean2d, conic, a, feats)
    g_j = _grads_jax(_jax_pallas(bj), args, gimg, gT)
    g_t = _grads_torch(fn_t, args, gimg, gT)
    for name, x, y in zip(["mean2d", "conic", "alpha", "feats"], g_t, g_j):
        np.testing.assert_allclose(x, np.asarray(y), rtol=5e-3, atol=5e-4,
                                   err_msg=name)


def test_processed_chunk_count_matches_pallas():
    """The count row K2 bounds its walk with equals the TPU kernel's."""
    (mean2d, conic, a, feats, _, _), bj, bt = _inputs(300, 6, alpha=0.95)
    dup = cuda_raster.pack_dup(*map(t, (mean2d, conic, a, feats)),
                               bt.padded_gid, bt.row_valid)
    nck = ((bt.ends - bt.starts + CHUNK - 1) // CHUNK).to(torch.int32)
    geom = torch.tensor([*TOPLEFT, *PSZ], dtype=torch.float32)
    out = cuda_raster.raster_fwd(dup, bt.starts, nck, geom, n_tiles_w=4,
                                 tile_size=TILE, chunk=CHUNK, F=5, ch_out=8,
                                 T_thresh=1e-4)
    from gsgen_tpu.ops.pallas_raster import _make_core, pack_dup
    dup_j = pack_dup(*map(jnp.asarray, (mean2d, conic, a, feats)),
                     bj.padded_gid, bj.row_valid, bj.padded_gid.shape[0])
    core = _make_core(16, 4, TILE, CHUNK, 5, int(bj.padded_gid.shape[0]),
                      1e-4, True, mxu_scans=False)
    nck_j = (bj.ends - bj.starts + CHUNK - 1) // CHUNK
    out_j = core(dup_j, bj.chunk_tile, bj.starts, bj.ends, nck_j,
                 jnp.asarray([*TOPLEFT, *PSZ], jnp.float32))
    assert int(nck.max()) > 1                    # some tile has 2+ chunks
    np.testing.assert_array_equal(out[:, 7, :].numpy(),
                                  np.asarray(out_j[:, 7, :]))
    np.testing.assert_allclose(out.numpy(), np.asarray(out_j), rtol=1e-4,
                               atol=1e-5)
