"""gsgen_torch's CUDA kernels against their plain versions, on the card.

These tests need a CUDA device and skip elsewhere.  The file imports
neither JAX nor the JAX package, so it also runs on a machine without
them; there, skip the JAX-importing conftest:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Tolerances as in test_pallas.py: T rtol 1e-5 / atol 1e-6, image rtol
1e-4 / atol 1e-5, gradients rtol 2e-3 / atol 2e-4; index kernels and the
processed chunk / window counts exact.  On the deep multi-window scenes
the gradient's atol is 2e-4 of each row's largest value, as chip_smoke.py
scales it at full size (sums over thousands of lanes).
"""

import numpy as np
import pytest
import torch

from gsgen_torch.models.scene import RenderConfig, render_view
from gsgen_torch.ops import binning, cuda_raster, expansion_rank, gid_repack
from gsgen_torch.ops.camera import CameraIntrinsics
from gsgen_torch.utils.precision import exact_fp32
from torch_fixtures import (CHUNK, FX, RES, TILE, conic_np, poison_padding,
                            scene2d, scene3d, t)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    exact_fp32()
    return torch.device("cuda")


def test_index_kernels_match_plain(cuda):
    rng = np.random.default_rng(0)
    counts = rng.integers(0, 30, 3000).astype(np.int32)
    cum = t(np.cumsum(counts).astype(np.int32)).to(cuda)
    for cap in (4096, 1 << 16):
        n0 = expansion_rank.expansion_gid.launches
        got = expansion_rank.expansion_gid(cum, cap)
        assert expansion_rank.expansion_gid.launches == n0 + 1
        assert torch.equal(got, expansion_rank.expansion_gid_plain(cum, cap))
    seen = {}

    def record(*args):
        seen["args"] = args
        return gid_repack.repack_gid(*args)

    mean2d, cov2d, alpha, _, depth = scene2d(200, 1)
    orig = binning.repack_gid
    binning.repack_gid = record
    try:
        binning.bin_gaussians(*(t(x).to(cuda) for x in
                                (mean2d, cov2d, depth)),
                              torch.ones(200, dtype=torch.bool, device=cuda),
                              FX, FX, RES / 2.0, RES / 2.0, RES, RES, TILE,
                              4096, chunk=CHUNK, alpha=t(alpha).to(cuda))
    finally:
        binning.repack_gid = orig
    assert torch.equal(gid_repack.repack_gid(*seen["args"]),
                       gid_repack.repack_gid_plain(*seen["args"]))


def _k3_counts(case, rng):
    """Per-Gaussian duplicate counts and cap of one K3 edge case."""
    if case == "total 0":
        return np.zeros(5000, np.int64), 4096
    if case == "total over cap":
        return rng.integers(0, 50, 3000), 3 * 4096 + 1234
    if case == "N 1":
        return np.array([7]), 4096
    if case == "N 1 over cap":
        return np.array([5000]), 4096
    counts = rng.integers(0, 8, 60000)
    if case == "zero runs":
        for a, b in ((0, 20000), (30000, 45000), (52000, 60000)):
            counts[a:b] = 0
        return counts, 1 << 18
    return rng.integers(0, 3, 10000), 5 * 4096 + 3    # ragged cap


@pytest.mark.parametrize("case", ["total 0", "total over cap", "N 1",
                                  "N 1 over cap", "zero runs", "ragged cap"])
def test_expansion_rank_edge_cases(cuda, case):
    """K3 bitwise equal to its plain version where the merge's shares
    hold only cum entries, only slots, one entry, or a ragged end."""
    counts, cap = _k3_counts(case, np.random.default_rng(1))
    cum = t(np.cumsum(counts).astype(np.int32)).to(cuda)
    assert torch.equal(expansion_rank.expansion_gid(cum, cap),
                       expansion_rank.expansion_gid_plain(cum, cap))


@pytest.mark.parametrize("F", [3, 5])
def test_raster_kernels_match_plain(cuda, F):
    mean2d, cov2d, alpha, feats, depth = scene2d(80, 2, F=F)
    args = (mean2d, conic_np(cov2d), alpha, feats)
    results = []
    for dev in ("cpu", cuda):
        bins = binning.bin_gaussians(
            t(mean2d).to(dev), t(cov2d).to(dev), t(depth).to(dev),
            torch.ones(80, dtype=torch.bool, device=dev), FX, FX, RES / 2.0,
            RES / 2.0, RES, RES, TILE, 4096, chunk=CHUNK,
            tile_culling_radius=60.0)
        ps = [t(x).to(dev).requires_grad_(True) for x in args]
        img, T = cuda_raster.rasterize_tiles_cuda(
            *ps, bins, (-1.0, -1.0), (1 / FX, 1 / FX), w=RES, h=RES,
            tile_size=TILE, chunk=CHUNK)
        (img.square().sum() + T.sum()).backward()
        results.append((img.detach().cpu(), T.detach().cpu(),
                        [p.grad.cpu() for p in ps]))
    (img_c, T_c, g_c), (img_k, T_k, g_k) = results
    np.testing.assert_allclose(T_k.numpy(), T_c.numpy(), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(img_k.numpy(), img_c.numpy(), rtol=1e-4,
                               atol=1e-5)
    for a, b in zip(g_k, g_c):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-3,
                                   atol=2e-4)


def test_render_view_on_card_matches_cpu(cuda):
    raw = scene3d(150, seed=3, capacity=160)
    from gsgen_torch.models.scene import scene_from_numpy
    cfg = RenderConfig(tile_size=8, chunk=128, dup_cap=4096)
    c2w = np.array([[1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 1, -2.5]],
                   np.float32)
    outs = []
    for dev in ("cpu", cuda):
        sc = scene_from_numpy(raw, dev)
        o = render_view(sc.params, sc.active, c2w,
                        CameraIntrinsics.from_reso(RES), cfg,
                        np.ones(3, np.float32))
        outs.append({k: v.cpu() for k, v in o.items()})
    for k in ("rgb", "T", "depth", "z_var"):
        np.testing.assert_allclose(outs[1][k].numpy(), outs[0][k].numpy(),
                                   rtol=1e-4, atol=1e-5, err_msg=k)
    assert torch.equal(outs[1]["n_dup"], outs[0]["n_dup"])


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("D", [40, 64, 160])
def test_flash_attention_matches_plain(cuda, dtype, D):
    """K5 against its plain version (fp32 scores and softmax): fp32 within
    1e-4 of max|out|, bf16 within 2e-2 of max|out| (the plain path rounds
    the normalised weights to bf16, K5 the unnormalised ones).  Instances:
    bf16 D <= 64 wgmma + TMA, bf16 D = 160 mma.sync, fp32 3xTF32."""
    from gsgen_torch.ops import flash_attention as fa
    rng = np.random.default_rng(D)
    dt = getattr(torch, dtype)
    q, k, v = (t(rng.standard_normal((2, 256, 3, D)).astype(np.float32))
               .to(cuda, dt) for _ in range(3))
    scale = 1.0 / np.sqrt(D)
    n0 = fa.flash_self_attention.launches
    got = fa.flash_self_attention(q, k, v, scale)
    assert fa.flash_self_attention.launches == n0 + 1
    want = fa.flash_self_attention_plain(q, k, v, scale)
    torch.cuda.synchronize()
    assert got.dtype == dt and got.shape == q.shape
    err = float((got.float() - want.float()).abs().max())
    tol = (2e-2 if dt == torch.bfloat16 else 1e-4) * float(
        want.float().abs().max())
    assert err <= tol, (err, tol)
    with pytest.raises(ValueError):
        fa.flash_self_attention(q[:, :100], k[:, :100], v[:, :100], scale)


def _qkv_dout(cuda, shape, dt, seed):
    rng = np.random.default_rng(seed)
    return [t(rng.standard_normal(shape).astype(np.float32)).to(cuda, dt)
            for _ in range(4)]


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("D", [40, 64, 160])
def test_flash_backward_kernels_match_plain(cuda, dtype, D):
    """K5's lse within 1e-5 (fp32) / 2e-2 (bf16) of the plain lse's
    largest value; K6 and K7 against flash_self_attention_bwd_plain within
    1e-4 (fp32) / 3e-2 (bf16) of each gradient's largest value (bf16: the
    kernels round P and dS to bf16 for the second products)."""
    from gsgen_torch.ops import flash_attention as fa
    dt = getattr(torch, dtype)
    q, k, v, dout = _qkv_dout(cuda, (2, 256, 2, D), dt, D + 1)
    scale = 1.0 / np.sqrt(D)
    out, lse = fa.flash_self_attention_lse(q, k, v, scale)
    out_p, lse_p = fa.flash_self_attention_plain_lse(q, k, v, scale)
    ftol = 1e-4 if dt == torch.float32 else 3e-2
    ltol = 1e-5 if dt == torch.float32 else 2e-2
    assert float((lse - lse_p).abs().max()) <= ltol * float(
        lse_p.abs().max())
    delta = fa.attention_delta(out, dout)
    n6, n7 = fa.flash_bwd_dkv.launches, fa.flash_bwd_dq.launches
    dk, dv = fa.flash_bwd_dkv(q, k, v, dout, lse, delta, scale)
    dq = fa.flash_bwd_dq(q, k, v, dout, lse, delta, scale)
    assert (fa.flash_bwd_dkv.launches, fa.flash_bwd_dq.launches) == (
        n6 + 1, n7 + 1)
    want = fa.flash_self_attention_bwd_plain(q, k, v, out, lse, dout, scale)
    torch.cuda.synchronize()
    for name, got, ref in zip(("dq", "dk", "dv"), (dq, dk, dv), want):
        assert got.dtype == dt and got.shape == q.shape
        err = float((got.float() - ref.float()).abs().max())
        assert err <= ftol * float(ref.float().abs().max()), (name, err)
    with pytest.raises(ValueError):
        fa.flash_bwd_dq(q, k, v, dout, lse[:, :, :128], delta, scale)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_flash_long_sequence_matches_plain(cuda, dtype):
    """K5 and K6 at L = 4096, B = 1 (the wgmma kernels walk their whole
    TMA ring many times over on few CTAs): the gates above."""
    from gsgen_torch.ops import flash_attention as fa
    dt = getattr(torch, dtype)
    q, k, v, dout = _qkv_dout(cuda, (1, 4096, 2, 64), dt, 9)
    scale = 0.125
    out, lse = fa.flash_self_attention_lse(q, k, v, scale)
    want = fa.flash_self_attention_plain(q, k, v, scale)
    ftol = 1e-4 if dt == torch.float32 else 2e-2
    assert float((out.float() - want.float()).abs().max()) <= ftol * float(
        want.float().abs().max())
    delta = fa.attention_delta(out, dout)
    got = fa.flash_bwd_dkv(q, k, v, dout, lse, delta, scale)
    ref = fa.flash_bwd_dkv_plain(q, k, v, dout, lse, delta, scale)
    torch.cuda.synchronize()
    btol = 1e-4 if dt == torch.float32 else 3e-2
    for a, b in zip(got, ref):
        assert float((a.float() - b.float()).abs().max()) <= btol * float(
            b.float().abs().max())


@pytest.mark.parametrize("L", [128, 4096])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("D", [40, 64, 160])
def test_flash_dq_kernel_matches_plain(cuda, dtype, D, L):
    """K7 alone (bf16 D <= 64: wgmma + TMA, one tile at L = 128 and the
    whole K / V ring at L = 4096; bf16 D = 160: mma.sync; fp32: 3xTF32)
    against flash_bwd_dq_plain from the plain lse and Di: fp32 within 1e-5
    of max|dq| (3xTF32 is about fp32 summation order; the chip gate is
    1e-4), bf16 within 3e-2 (dS rounded to bf16).  One launch per call, and
    two runs on the same inputs are bitwise equal (no atomics)."""
    from gsgen_torch.ops import flash_attention as fa
    dt = getattr(torch, dtype)
    shape = (2, L, 3, D) if L == 128 else (1, L, 2, D)
    q, k, v, dout = _qkv_dout(cuda, shape, dt, 3 * D + L)
    scale = 1.0 / np.sqrt(D)
    out, lse = fa.flash_self_attention_plain_lse(q, k, v, scale)
    delta = fa.attention_delta(out, dout)
    n7 = fa.flash_bwd_dq.launches
    got = fa.flash_bwd_dq(q, k, v, dout, lse, delta, scale)
    again = fa.flash_bwd_dq(q, k, v, dout, lse, delta, scale)
    assert fa.flash_bwd_dq.launches == n7 + 2
    want = fa.flash_bwd_dq_plain(q, k, v, dout, lse, delta, scale)
    torch.cuda.synchronize()
    assert got.dtype == dt and got.shape == q.shape
    assert torch.equal(got, again)
    tol = (1e-5 if dt == torch.float32 else 3e-2) * float(
        want.float().abs().max())
    assert float((got.float() - want.float()).abs().max()) <= tol


def test_flash_attention_autograd_on_card(cuda):
    """The output stays attached to inputs that require grad, and the
    gradients of K5 + K6 + K7 match autograd through the plain path
    (fp32, 1e-4 of each gradient's largest value); under no_grad no lse
    is kept and the backward kernels do not launch."""
    from gsgen_torch.ops import flash_attention as fa
    q, k, v, dout = _qkv_dout(cuda, (2, 128, 3, 64), torch.float32, 5)
    ps = [x.clone().requires_grad_(True) for x in (q, k, v)]
    n = (fa.flash_self_attention.launches, fa.flash_bwd_dkv.launches,
         fa.flash_bwd_dq.launches)
    out = fa.flash_self_attention(*ps, 0.125)
    assert out.grad_fn is not None and out.requires_grad
    got = torch.autograd.grad(out, ps, dout)
    assert (fa.flash_self_attention.launches, fa.flash_bwd_dkv.launches,
            fa.flash_bwd_dq.launches) == (n[0] + 1, n[1] + 1, n[2] + 1)
    ref_ps = [x.clone().requires_grad_(True) for x in (q, k, v)]
    want = torch.autograd.grad(
        fa.flash_self_attention_plain(*ref_ps, 0.125), ref_ps, dout)
    for a, b in zip(got, want):
        assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max())
    with torch.no_grad():
        assert fa.flash_self_attention(*ps, 0.125).grad_fn is None
    assert fa.flash_bwd_dkv.launches == n[1] + 1


@pytest.mark.parametrize("F", [3, 5])
def test_compact_kernels_match_plain(cuda, F):
    """K8 and K9 against their plain versions on compact bins with empty
    tiles whose starts are unaligned and windows shared by two tiles: T,
    image and gradient gates as above, the window-count row exact; then
    the compact autograd Function on the card (output attached, one K8
    and one K9 launch) against the CPU."""
    mean2d, cov2d, alpha, feats, depth = scene2d(60, 5, spread=0.35, F=F)
    mean2d = mean2d - np.float32(0.45)      # top-left quadrant only
    args = (mean2d, conic_np(cov2d), alpha, feats)
    st = dict(n_tiles_w=4, tile_size=TILE, chunk=CHUNK, F=F,
              ch_out=cuda_raster.ch_out_for(F), T_thresh=1e-4)
    bins = binning.bin_gaussians(
        *(t(x).to(cuda) for x in (mean2d, cov2d, depth)),
        torch.ones(60, dtype=torch.bool, device=cuda), FX, FX, RES / 2.0,
        RES / 2.0, RES, RES, TILE, 4096, chunk=CHUNK, layout="compact")
    starts, ends = bins.starts, bins.ends
    assert bool(((starts == ends) & (starts % CHUNK != 0)).any())
    assert bool(((starts % CHUNK != 0) & (starts != ends)).any())
    dup = cuda_raster.pack_dup(*(t(x).to(cuda) for x in args), bins.gid_s,
                               torch.ones_like(bins.gid_s, dtype=torch.bool))
    wc = cuda_raster.window_counts(starts, ends, CHUNK)
    geom = torch.tensor([-1.0, -1.0, 1 / FX, 1 / FX], device=cuda)
    n8 = cuda_raster.raster_fwd_compact.launches
    out = cuda_raster.raster_fwd_compact(dup, starts, ends, wc, geom, **st)
    out_p = cuda_raster.raster_fwd_plain(dup, starts, ends, wc, geom,
                                                 **st)
    torch.cuda.synchronize()
    assert cuda_raster.raster_fwd_compact.launches == n8 + 1
    assert torch.equal(out[:, -1], out_p[:, -1])
    np.testing.assert_allclose(out[:, F].cpu().numpy(),
                               out_p[:, F].cpu().numpy(), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(out[:, :F].cpu().numpy(),
                               out_p[:, :F].cpu().numpy(), rtol=1e-4,
                               atol=1e-5)
    g = torch.randn(out.shape, generator=torch.Generator(cuda).manual_seed(1),
                    device=cuda)
    grad = cuda_raster.raster_bwd_compact(dup, out, g, starts, ends, wc, geom,
                                          **st)
    grad_p = cuda_raster.raster_bwd_plain(dup, out_p, g, starts, ends, wc,
                                          geom, **st)
    torch.cuda.synchronize()
    np.testing.assert_allclose(grad.cpu().numpy(), grad_p.cpu().numpy(),
                               rtol=2e-3, atol=2e-4)

    results = []
    for dev in ("cpu", cuda):
        b = binning.bin_gaussians(
            *(t(x).to(dev) for x in (mean2d, cov2d, depth)),
            torch.ones(60, dtype=torch.bool, device=dev), FX, FX, RES / 2.0,
            RES / 2.0, RES, RES, TILE, 4096, chunk=CHUNK, layout="compact")
        ps = [t(x).to(dev).requires_grad_(True) for x in args]
        n = (cuda_raster.raster_fwd_compact.launches,
             cuda_raster.raster_bwd_compact.launches)
        img, T = cuda_raster.rasterize_tiles_cuda(
            *ps, b, (-1.0, -1.0), (1 / FX, 1 / FX), w=RES, h=RES,
            tile_size=TILE, chunk=CHUNK)
        assert img.grad_fn is not None
        (img.square().sum() + T.sum()).backward()
        launched = (cuda_raster.raster_fwd_compact.launches - n[0],
                    cuda_raster.raster_bwd_compact.launches - n[1])
        assert launched == ((1, 1) if dev == cuda else (0, 0))
        results.append((img.detach().cpu(), [p.grad.cpu() for p in ps]))
    (img_c, g_c), (img_k, g_k) = results
    np.testing.assert_allclose(img_k.numpy(), img_c.numpy(), rtol=1e-4,
                               atol=1e-5)
    for a, b in zip(g_k, g_c):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-3,
                                   atol=2e-4)


def _deep_scene(cuda, F, K, alpha, layout="padded"):
    """3,000 wide Gaussians on the 4 x 4 tiles of the test image: tiles
    own 2-12 windows of K rows, most with a partial last chunk, so the
    stage ring wraps; alpha 0.05 keeps every tile alive through all of
    them, alpha 0.9 makes tiles leave after the first with the next
    window's copy in flight."""
    mean2d, cov2d, a, feats, depth = scene2d(3000, 11, cov_scale=0.1, F=F,
                                             alpha=alpha)
    bins = binning.bin_gaussians(
        *(t(x).to(cuda) for x in (mean2d, cov2d, depth)),
        torch.ones(3000, dtype=torch.bool, device=cuda), FX, FX, RES / 2.0,
        RES / 2.0, RES, RES, TILE, 1 << 15, chunk=K, layout=layout)
    compact = layout == "compact"
    gid = bins.gid_s if compact else bins.padded_gid
    valid = torch.ones_like(gid, dtype=torch.bool) if compact \
        else bins.row_valid
    dup = cuda_raster.pack_dup(*(t(x).to(cuda) for x in (
        mean2d, conic_np(cov2d), a, feats)), gid, valid)
    counts = cuda_raster.window_counts(bins.starts, bins.ends, K) \
        if compact else ((bins.ends - bins.starts + K - 1) // K).to(
            torch.int32)
    st = dict(n_tiles_w=4, tile_size=TILE, chunk=K, F=F,
              ch_out=cuda_raster.ch_out_for(F), T_thresh=1e-4)
    geom = torch.tensor([-1.0, -1.0, 1 / FX, 1 / FX], device=cuda)
    return dup, bins, counts, st, geom


def _grads_close(grad, grad_p, F):
    for r in range(6 + F):
        scale = max(float(grad_p[r].abs().max()), 1e-3)
        np.testing.assert_allclose(grad[r].cpu().numpy(),
                                   grad_p[r].cpu().numpy(), rtol=2e-3,
                                   atol=2e-4 * scale, err_msg=f"row {r}")


@pytest.mark.parametrize("alpha", [0.05, 0.9])
@pytest.mark.parametrize("K", [128, 256])
@pytest.mark.parametrize("F", [3, 5, 10])
def test_padded_kernels_deep_tiles(cuda, F, K, alpha):
    """K1 and K2 against their plain versions where tiles walk 2-12
    windows with partial last chunks (alpha 0.05) or leave early with a
    copy in flight (alpha 0.9); F = 10 at K = 256 takes K2 past 48 KB of
    shared memory.  Count row exact; two runs bitwise equal."""
    dup, bins, nck, st, geom = _deep_scene(cuda, F, K, alpha)
    lens = bins.ends - bins.starts
    assert int(nck.max()) >= 3 and bool((lens % K != 0).any())
    a = (bins.starts, bins.ends, nck, geom)
    n1, n2 = cuda_raster.raster_fwd.launches, cuda_raster.raster_bwd.launches
    out = cuda_raster.raster_fwd(dup, *a, **st)
    again = cuda_raster.raster_fwd(dup, *a, **st)
    out_p = cuda_raster.raster_fwd_plain(dup, *a, **st)
    torch.cuda.synchronize()
    assert torch.equal(out, again)
    assert torch.equal(out[:, -1], out_p[:, -1])
    cnt = out[:, -1, 0]
    if alpha < 0.5:
        assert float(cnt.max()) >= 3 and torch.equal(cnt, nck.float())
    else:
        assert bool((cnt < nck.float()).any())
    np.testing.assert_allclose(out[:, F].cpu().numpy(),
                               out_p[:, F].cpu().numpy(), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(out[:, :F].cpu().numpy(),
                               out_p[:, :F].cpu().numpy(), rtol=1e-4,
                               atol=1e-5)
    g = torch.randn(out.shape, generator=torch.Generator(cuda).manual_seed(2),
                    device=cuda)
    grad = cuda_raster.raster_bwd(dup, out, g, *a, **st)
    grad2 = cuda_raster.raster_bwd(dup, out, g, *a, **st)
    grad_p = cuda_raster.raster_bwd_plain(dup, out_p, g, *a, **st)
    torch.cuda.synchronize()
    assert (cuda_raster.raster_fwd.launches - n1,
            cuda_raster.raster_bwd.launches - n2) == (2, 2)
    assert torch.equal(grad, grad2)
    _grads_close(grad, grad_p, F)


def test_padded_kernels_skip_poisoned_padding(cuda):
    """The padding lanes past ends[t] of each tile's last chunk, poisoned
    with rows that would contribute (alpha 0.9, means inside the image):
    K1 and K2 give bitwise what they give on the clean table."""
    dup, bins, nck, st, geom = _deep_scene(cuda, 5, 128, 0.05)
    poisoned = poison_padding(dup, bins.row_valid, 8)
    a = (bins.starts, bins.ends, nck, geom)
    g = torch.randn((16, st["ch_out"], TILE * TILE),
                    generator=torch.Generator(cuda).manual_seed(3),
                    device=cuda)
    res = []
    for d in (dup, poisoned):
        out = cuda_raster.raster_fwd(d, *a, **st)
        res.append((out, cuda_raster.raster_bwd(d, out, g, *a, **st)))
    torch.cuda.synchronize()
    assert torch.equal(res[0][0], res[1][0])
    assert torch.equal(res[0][1], res[1][1])


@pytest.mark.parametrize("K", [128, 256])
def test_padded_forward_matches_compact_forward(cuda, K):
    """K1 on the padded layout and K8 on the compact one composite the
    same image and T (the gates above: the windows group the rows
    differently, so T's per-window products round differently)."""
    res = []
    for layout in ("padded", "compact"):
        dup, bins, counts, st, geom = _deep_scene(cuda, 5, K, 0.05, layout)
        fwd = cuda_raster.raster_fwd_compact if layout == "compact" \
            else cuda_raster.raster_fwd
        res.append(fwd(dup, bins.starts, bins.ends, counts, geom, **st))
    torch.cuda.synchronize()
    (out_p, out_c) = res
    np.testing.assert_allclose(out_c[:, 5].cpu().numpy(),
                               out_p[:, 5].cpu().numpy(), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(out_c[:, :5].cpu().numpy(),
                               out_p[:, :5].cpu().numpy(), rtol=1e-4,
                               atol=1e-5)
