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
from torch_fixtures import (CHUNK, FX, RES, TILE, conic_np, poison_padding,
                            scene2d, t)

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
    out = cuda_raster.raster_fwd(dup, bt.starts, bt.ends, nck, geom,
                                 n_tiles_w=4, tile_size=TILE, chunk=CHUNK,
                                 F=5, ch_out=8, T_thresh=1e-4)
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


def test_padded_walk_ends_at_ends():
    """The padded path walks each tile's rows only up to ends[t].  With
    the padding lanes of every tile's last chunk poisoned (alpha 0.9,
    finite garbage), the plain padded path gives bitwise the out and
    gradient it gives on the clean table, and both match the JAX padded
    kernel on the clean table, which does not mask by ends but relies on
    the sentinel's alpha 0.  Walking whole chunks (ends at the chunk end)
    on the poisoned table changes the image: the poison is on the walk."""
    (mean2d, conic, a, feats, _, _), bj, bt = _inputs(300, 6)
    dup = cuda_raster.pack_dup(*map(t, (mean2d, conic, a, feats)),
                               bt.padded_gid, bt.row_valid)
    nck = ((bt.ends - bt.starts + CHUNK - 1) // CHUNK).to(torch.int32)
    lens = bt.ends - bt.starts
    assert bool(((lens % CHUNK != 0) & (lens > 0)).any())  # partial chunks
    geom = torch.tensor([*TOPLEFT, *PSZ], dtype=torch.float32)
    st = dict(n_tiles_w=4, tile_size=TILE, chunk=CHUNK, F=5, ch_out=8,
              T_thresh=1e-4)
    poisoned = poison_padding(dup, bt.row_valid, 8)
    rng = np.random.default_rng(9)
    g = rng.standard_normal((16, 8, TILE * TILE)).astype(np.float32)
    g[:, 6:] = 0.0                                 # pad and count rows
    res = []
    for d in (dup, poisoned):
        out = cuda_raster.raster_fwd(d, bt.starts, bt.ends, nck, geom, **st)
        grad = cuda_raster.raster_bwd(d, out, t(g), bt.starts, bt.ends, nck,
                                      geom, **st)
        res.append((out, grad))
    (out_c, grad_c), (out_x, grad_x) = res
    assert torch.equal(out_x, out_c)
    assert torch.equal(grad_x, grad_c)
    whole = torch.clamp(bt.starts + nck * CHUNK, max=dup.shape[1])
    out_w = cuda_raster.raster_fwd(poisoned, bt.starts, whole, nck, geom,
                                   **st)
    assert float((out_w[:, :5] - out_c[:, :5]).abs().max()) > 1e-2

    from gsgen_tpu.ops.pallas_raster import _make_core, pack_dup
    dup_j = pack_dup(*map(jnp.asarray, (mean2d, conic, a, feats)),
                     bj.padded_gid, bj.row_valid, bj.padded_gid.shape[0])
    core = _make_core(16, 4, TILE, CHUNK, 5, int(bj.padded_gid.shape[0]),
                      1e-4, True, mxu_scans=False)
    nck_j = (bj.ends - bj.starts + CHUNK - 1) // CHUNK
    out_j, vjp = jax.vjp(lambda d: core(
        d, bj.chunk_tile, bj.starts, bj.ends, nck_j,
        jnp.asarray([*TOPLEFT, *PSZ], jnp.float32)), dup_j)
    (grad_j,) = vjp(jnp.asarray(g))
    np.testing.assert_array_equal(out_c[:, 7].numpy(),
                                  np.asarray(out_j[:, 7]))
    np.testing.assert_allclose(out_c[:, 5].numpy(), np.asarray(out_j[:, 5]),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(out_c[:, :5].numpy(),
                               np.asarray(out_j[:, :5]), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(grad_c[:11].numpy(), np.asarray(grad_j[:11]),
                               rtol=2e-3, atol=2e-4)


def _transpose_reduce_np(vals):
    """raster_bwd.cu::transpose_reduce16 on a warp's [32 lanes, 16 rows]
    values, step by step in float32: exchanges with the xor partners 16,
    8, 4, 2, a lane whose partner bit is set keeping the upper half of its
    rows and adding the partner's copy of it, then one add across xor 1.
    Returns what each lane holds."""
    v = vals.astype(np.float32)
    lane = np.arange(32)
    for h in (8, 4, 2, 1):
        upper = ((lane & (2 * h)) != 0)[:, None]
        give = np.where(upper, v[:, :h], v[:, h:2 * h])
        keep = np.where(upper, v[:, h:2 * h], v[:, :h])
        v = keep + give[lane ^ (2 * h)]
    return v[:, 0] + v[lane ^ 1, 0]


@pytest.mark.parametrize("kind", ["integers", "normal"])
def test_transpose_reduce_schedule_sums_rows(kind):
    """Lane l of the schedule holds the warp's sum of row l >> 1: exactly
    for integer values (every partial sum is exact in fp32), within fp32
    summation error for normal ones; lanes l and l ^ 1 agree bitwise."""
    rng = np.random.default_rng(17)
    for _ in range(20):
        if kind == "integers":
            vals = rng.integers(-1000, 1000, (32, 16)).astype(np.float32)
        else:
            vals = rng.standard_normal((32, 16)).astype(np.float32)
        got = _transpose_reduce_np(vals)
        want = vals.astype(np.float64).sum(axis=0)[np.arange(32) >> 1]
        assert np.array_equal(got, got[np.arange(32) ^ 1])
        if kind == "integers":
            np.testing.assert_array_equal(got, want.astype(np.float32))
        else:
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
