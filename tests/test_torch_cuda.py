"""gsgen_torch's CUDA kernels against their plain versions, on the card.

These tests need a CUDA device and skip elsewhere.  The file imports
neither JAX nor the JAX package, so it also runs on a machine without
them; there, skip the JAX-importing conftest:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Render-path tests take F = 3, 5 and 8 feature channels (8: colour, depth,
z^2 and the normal of render_normal).  Tolerances as in test_pallas.py: T rtol 1e-5 / atol 1e-6, image rtol
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


@pytest.mark.parametrize("F", [3, 5, 8])
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


def test_eigh_batched_on_card(cuda):
    """The normals' batched 3x3 eigh past cuSOLVER's batch limit (40,000
    matrices, 32,768 or more fail in one call): R diag(1, 2, 3) s R^T with
    known eigenvalues (rtol 1e-5 of s) and eigenvectors (|dot| with R's
    columns within 1e-5 of 1); bitwise the same as batch by batch."""
    from gsgen_torch.utils.ops import EIGH_BATCH, eigh_batched
    g = torch.Generator().manual_seed(0)
    q = torch.linalg.qr(torch.randn(40000, 3, 3, generator=g))[0]
    s = torch.rand(40000, 1, generator=g) + 0.5
    lam = torch.tensor([1.0, 2.0, 3.0]) * s
    a = ((q * lam[:, None, :]) @ q.transpose(1, 2)).to(cuda)
    a = 0.5 * (a + a.transpose(1, 2))
    w, v = eigh_batched(a)
    assert EIGH_BATCH < 32768 < a.shape[0]
    np.testing.assert_allclose(w.cpu().numpy(), lam.numpy(), rtol=1e-5,
                               atol=1e-5)
    dots = (v.cpu() * q).sum(1).abs()
    assert float((dots - 1.0).abs().max()) < 1e-5
    w1, v1 = torch.linalg.eigh(a[:EIGH_BATCH])
    assert torch.equal(w[:EIGH_BATCH], w1) and torch.equal(v[:EIGH_BATCH], v1)


@pytest.mark.parametrize("layout", ["padded", "compact"])
def test_render_normal_pbr_on_card_matches_cpu(cuda, layout):
    """render_view with pbr (learned normals, a point light) and
    render_normal (F = 8: colour, depth, z^2, normal) on the card against
    the same call on the CPU: outputs rtol 1e-4 / atol 1e-5, gradients of
    every field (specular and normal included) rtol 2e-3 / atol 2e-4 of
    the largest; K1/K2 (padded) or K8/K9 (compact) launched once each."""
    from gsgen_torch.models.scene import scene_from_numpy
    raw = scene3d(150, seed=4, capacity=160)
    rng = np.random.default_rng(5)
    raw["specular"] = rng.normal(-2.0, 0.5, (160, 3)).astype(np.float32)
    raw["normal"] = rng.standard_normal((160, 3)).astype(np.float32)
    cfg = RenderConfig(tile_size=8, chunk=128, dup_cap=4096, pbr=True,
                       normal_type="learned", render_normal=True,
                       binning_layout=layout)
    c2w = np.array([[1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 1, -2.5]],
                   np.float32)
    light = dict(light_pos=np.float32([2.5, 1.0, -1.0]),
                 light_color=np.ones(3, np.float32))
    w = t(rng.standard_normal((RES, RES, 3)).astype(np.float32))
    fwd, bwd = ((cuda_raster.raster_fwd, cuda_raster.raster_bwd)
                if layout == "padded" else
                (cuda_raster.raster_fwd_compact,
                 cuda_raster.raster_bwd_compact))
    outs, grads = [], []
    for dev in ("cpu", cuda):
        sc = scene_from_numpy(raw, dev)
        ps = {k: v.requires_grad_(True) for k, v in sc.params.items()}
        n = (fwd.launches, bwd.launches)
        o = render_view(ps, sc.active, c2w, CameraIntrinsics.from_reso(RES),
                        cfg, np.ones(3, np.float32), **light)
        ((o["rgb"] * w.to(dev)).sum() + (o["normal"] * w.to(dev)).sum()
         + o["depth"].sum()).backward()
        assert (fwd.launches - n[0], bwd.launches - n[1]) == \
            ((1, 1) if dev == cuda else (0, 0))
        outs.append({k: v.detach().cpu() for k, v in o.items()})
        grads.append({k: v.grad.cpu() for k, v in ps.items()})
    assert tuple(outs[1]["normal"].shape) == (RES, RES, 3)
    for k in ("rgb", "T", "depth", "z_var", "normal"):
        np.testing.assert_allclose(outs[1][k].numpy(), outs[0][k].numpy(),
                                   rtol=1e-4, atol=1e-5, err_msg=k)
    for k, g in grads[0].items():
        scale = max(float(g.abs().max()), 1e-6)
        np.testing.assert_allclose(grads[1][k].numpy(), g.numpy(),
                                   rtol=2e-3, atol=2e-4 * scale, err_msg=k)
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


@pytest.mark.parametrize("L", [4096, 16384, 65536])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("D", [16, 32])
def test_flash_attention_if2_shapes_match_plain(cuda, dtype, D, L):
    """K5 at the head widths of the IF-II upsampler's attention levels (8
    heads on 128 and 256 channels: D = 16 at L = 16,384 and D = 32 at L =
    4,096 for a 256^2 target) and TINY_SR level 0's L = 65,536, both
    instances, B = 1, 2 heads.  fp32: within 1e-4 of max|plain|.  bf16:
    within 2e-2 of max|plain| and, since each output averages thousands
    of keys (typical |out| ~ max/20), each element within one bf16 step
    (2^-7 |plain|) plus 5% of the plain output's RMS.  At L = 65,536 the
    plain version takes the last 2,048 queries against all keys."""
    from gsgen_torch.ops import flash_attention as fa
    rng = np.random.default_rng(D + L)
    dt = getattr(torch, dtype)
    q, k, v = (t(rng.standard_normal((1, L, 2, D)).astype(np.float32))
               .to(cuda, dt) for _ in range(3))
    scale = 1.0 / np.sqrt(D)
    n0 = fa.flash_self_attention.launches
    got = fa.flash_self_attention(q, k, v, scale)
    assert fa.flash_self_attention.launches == n0 + 1
    assert got.dtype == dt and got.shape == q.shape
    rows = slice(L - 2048 if L > 16384 else 0, L)
    want = fa.flash_self_attention_plain(q[:, rows], k, v, scale).float()
    torch.cuda.synchronize()
    diff = (got[:, rows].float() - want).abs()
    err = float(diff.max())
    tol = (2e-2 if dt == torch.bfloat16 else 1e-4) * float(
        want.abs().max())
    assert err <= tol, (err, tol)
    if dt == torch.bfloat16:
        rms = float(want.square().mean().sqrt())
        past = float(((diff - 2 ** -7 * want.abs()) / rms).max())
        assert past <= 0.05, (past, err, rms)


def test_ddim_cfg_sample_on_card_matches_cpu(cuda):
    """One DDIM CFG sample (4 steps, scale 7.5) on the TINY UNet at latent
    64: on the card its level 0 runs K5 (fp32, [4, 4096, 2, 16]) three
    times a step; within 1e-4 of the CPU's largest value (TF32 off)."""
    import copy

    from gsgen_torch.guidance import samplers
    from gsgen_torch.guidance.diffusion import scaled_linear_schedule
    from gsgen_torch.guidance.sd_unet import TINY, SDUNetBackbone
    from gsgen_torch.ops import flash_attention as fa
    rng = np.random.default_rng(12)
    x = rng.standard_normal((2, 64, 64, 4)).astype(np.float32)
    text2 = rng.standard_normal((4, 77, 1024)).astype(np.float32)
    bb_cpu = SDUNetBackbone(TINY, latent_size=64, device="cpu")
    outs = {}
    for dev, bb in (("cpu", bb_cpu), ("cuda", copy.deepcopy(bb_cpu).to(
            cuda))):
        n0 = fa.flash_self_attention.launches
        outs[dev] = samplers.cfg_sample(
            samplers.SamplerConfig(num_steps=4), scaled_linear_schedule(),
            x.shape, 7.5,
            lambda lat2, t2, bb=bb, dev=dev: bb.predict_noise(
                lat2, t2, t(text2).to(dev)),
            device=dev, x=t(x).to(dev)).cpu()
        assert fa.flash_self_attention.launches - n0 == (
            12 if dev == "cuda" else 0)
    want = outs["cpu"].numpy()
    np.testing.assert_allclose(outs["cuda"].numpy(), want, rtol=0,
                               atol=1e-4 * np.abs(want).max())


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


@pytest.mark.parametrize("F", [3, 5, 8])
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


def test_fps_on_card_matches_cpu(cuda):
    """The aux guidance's FPS at its main-path shape: capacity 65,536,
    4,096 active rows, 1,024 samples; equal indices, or (a last-ulp tie
    reordered) the same min-distance profile within 1e-5 relative."""
    from chip_smoke import fps_profile
    from gsgen_torch.utils.ops import farthest_point_sampling
    rng = np.random.default_rng(30)
    pts = np.zeros((65536, 3), np.float32)
    pts[:4096] = rng.standard_normal((4096, 3)) * 0.8
    mask = np.arange(65536) < 4096
    got = farthest_point_sampling(t(pts).to(cuda), 1024,
                                  mask=t(mask).to(cuda)).cpu()
    want = farthest_point_sampling(t(pts), 1024, mask=t(mask))
    if not torch.equal(got, want):
        np.testing.assert_allclose(fps_profile(torch, t(pts), got).numpy(),
                                   fps_profile(torch, t(pts), want).numpy(),
                                   rtol=1e-5, atol=0)
    assert bool(t(mask)[got.long()].all())


def test_point_e_full_width_forward_on_card(cuda):
    """base40M-textvec at full width on [2, 6, 1024], random weights with
    output_proj filled: card against CPU within 1e-4 of the largest
    output (fp32, TF32 off, summation order)."""
    from gsgen_torch.guidance.point_e import BASE40M_TEXTVEC, PointEModel
    m_cpu = PointEModel(BASE40M_TEXTVEC, device="cpu", seed=3)
    g = torch.Generator().manual_seed(4)
    proj = m_cpu.module.output_proj
    with torch.no_grad():
        proj.weight.copy_(torch.randn(proj.weight.shape, generator=g) * 0.02)
        proj.bias.copy_(torch.randn(proj.bias.shape, generator=g) * 0.02)
    m_dev = PointEModel(BASE40M_TEXTVEC, device=cuda).load_weights(
        m_cpu.module.state_dict())
    x = torch.randn(2, 6, 1024, generator=g)
    tt = torch.tensor([10.0, 900.0])
    cond = torch.randn(2, 768, generator=g)
    want = m_cpu.apply(x, tt, cond)
    got = m_dev.apply(x.to(cuda), tt.to(cuda), cond.to(cuda)).cpu()
    assert float(want.abs().max()) > 0
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                               atol=1e-4 * float(want.abs().max()))


def test_point_e_aux_loss_on_card_matches_cpu(cuda):
    """The aux loss and its mean gradient on TINY (t and noise handed in):
    loss rtol 1e-4, gradient within 1e-4 of its largest value."""
    from gsgen_torch.guidance.point_e import TINY_POINT_E, PointEModel
    from gsgen_torch.guidance.point_e_aux import (PointEAuxConfig,
                                                  PointEAuxGuidance)
    g = torch.Generator().manual_seed(5)
    cfg = PointEAuxConfig(num_points=256, batch_size=4, base_name="tiny")
    m = PointEModel(TINY_POINT_E, device="cpu", seed=6)
    with torch.no_grad():
        m.module.output_proj.weight.normal_(0.0, 0.3, generator=g)
    mean = torch.randn(4096, 3, generator=g)
    color = torch.rand(4096, 3, generator=g)
    active = torch.arange(4096) < 3000
    tt = torch.randint(20, 1003, (4,), generator=g)
    noise = torch.randn(4, 6, 256, generator=g)
    text = torch.randn(77, 1024, generator=g)
    res = {}
    for dev in ("cpu", cuda):
        model = PointEModel(TINY_POINT_E, device=dev).load_weights(
            m.module.state_dict())
        guid = PointEAuxGuidance(cfg, model=model, device=dev)
        x = mean.to(dev).detach().requires_grad_(True)
        out = guid.loss(x, color.to(dev), active.to(dev), text.to(dev),
                        t=tt.to(dev), noise=noise.to(dev))
        out["loss_aux"].backward()
        res[str(dev)] = (float(out["loss_aux"].detach()), x.grad.cpu())
    (l_c, g_c), (l_d, g_d) = res["cpu"], res[str(cuda)]
    np.testing.assert_allclose(l_d, l_c, rtol=1e-4)
    assert float(g_c.abs().max()) > 0
    np.testing.assert_allclose(g_d.numpy(), g_c.numpy(), rtol=0,
                               atol=1e-4 * float(g_c.abs().max()))


def _seeded_state(module, seed):
    """A state dict of ``module``'s names: weights ~ N(0, 1/fan_in), norm
    scales 1 + N(0, 0.1²), biases and embeddings N(0, 0.1²) (transformers'
    ``position_ids`` buffers left out)."""
    import math
    g = torch.Generator().manual_seed(seed)
    sd = {}
    for k, v in module.state_dict().items():
        if "position_ids" in k:
            continue
        n = torch.randn(v.shape, generator=g)
        if v.dim() >= 2 and "embedding" not in k and \
                not k.endswith(("cls_token", "pos_embed")):
            sd[k] = n / math.sqrt(v[0].numel())
        elif "norm" in k and k.endswith("weight"):
            sd[k] = 1.0 + 0.1 * n
        else:
            sd[k] = 0.1 * n
    return sd


def test_dpt_full_width_forward_on_card(cuda):
    """DPT-hybrid (vitb_rn50_384) at 384², the card against the CPU from
    one state dict: within 1e-3 of the output's largest value (a 50-layer
    ResNet stem and 12 ViT blocks of fp32 sums in another order)."""
    from gsgen_torch.priors.dpt import DPTConfig, DPTHybrid, load_dpt
    sd = _seeded_state(DPTHybrid(DPTConfig()), 11)
    sd["scratch.output_conv.4.weight"] *= 0.1
    sd["scratch.output_conv.4.bias"] += 0.8
    x = torch.rand(1, 384, 384, 3, generator=torch.Generator().manual_seed(
        1)) * 2.0 - 1.0
    with torch.no_grad():
        want = load_dpt(sd, device="cpu")(x)
        got = load_dpt(sd, device=cuda)(x.to(cuda)).cpu()
    assert got.shape == (1, 384, 384, 1)
    assert float((want > 0).float().mean()) > 0.5
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                               atol=1e-3 * float(want.abs().max()))


def test_vit_l14_grid_on_card(cuda):
    """CLIP ViT-L/14's patch grid (Point-E's image conditioning) of a 378²
    image, the card against the CPU: within 1e-4 of the largest value."""
    from gsgen_torch.prompt.clip_vision import (VIT_L14, CLIPImageEncoder,
                                                CLIPVisionModelWithProjection)
    sd = _seeded_state(CLIPVisionModelWithProjection(VIT_L14, 768), 12)
    img = torch.rand(1, 378, 378, 3, generator=torch.Generator().manual_seed(
        2))
    with torch.no_grad():
        want = CLIPImageEncoder.from_state_dict(
            sd, VIT_L14, 768, device="cpu").encode_grid(img)
        got = CLIPImageEncoder.from_state_dict(
            sd, VIT_L14, 768, device=cuda).encode_grid(img.to(cuda)).cpu()
    assert got.shape == (1, 256, 1024)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                               atol=1e-4 * float(want.abs().max()))


@pytest.mark.parametrize("method", ["cubic", "bilinear"])
def test_jax_style_resize_on_card(cuda, method):
    """utils/resize.py (jax.image.resize's antialiased weights) on the
    card against the CPU: 378² -> 224² and 24x30 -> 50x17, within 1e-6."""
    from gsgen_torch.utils.resize import resize
    g = torch.Generator().manual_seed(3)
    for src, dst in (((2, 378, 378, 3), (2, 224, 224, 3)),
                     ((2, 24, 30, 3), (2, 50, 17, 3))):
        x = torch.rand(src, generator=g)
        want = resize(x, dst[1:3], method)
        got = resize(x.to(cuda), dst[1:3], method).cpu()
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                                   atol=1e-6)


def _write_safetensors(path, tensors):
    """A ``.safetensors`` file without the safetensors package (the card's
    machine lacks it): the header, padded to 8 bytes, then the bytes."""
    import json
    import struct
    codes = {torch.float32: "F32", torch.float16: "F16",
             torch.bfloat16: "BF16", torch.int64: "I64", torch.int32: "I32"}
    header, blobs, at = {}, [], 0
    for name, v in tensors.items():
        raw = v.detach().cpu().contiguous().view(torch.uint8).numpy()
        header[name] = {"dtype": codes[v.dtype], "shape": list(v.shape),
                        "data_offsets": [at, at + raw.nbytes]}
        blobs.append(raw)
        at += raw.nbytes
    head = json.dumps(header).encode()
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(head)) + head)
        for raw in blobs:
            f.write(raw.tobytes())


def test_safetensors_bf16_onto_card(cuda, tmp_path):
    """The port's reader: a bf16 / fp16 / fp32 file read and moved onto
    the card bitwise, and a bf16 module on the card filled from it."""
    from gsgen_torch.guidance import convert
    g = torch.Generator().manual_seed(0)
    want = {"lin.weight": torch.randn(48, 40, generator=g).bfloat16(),
            "lin.bias": torch.randn(48, generator=g).bfloat16(),
            "half": torch.randn(7, 3, generator=g).half(),
            "full": torch.randn(5, generator=g)}
    _write_safetensors(tmp_path / "w.safetensors", want)
    got = convert.load_safetensors(tmp_path / "w.safetensors")
    for k, v in want.items():
        on_card = got[k].to(cuda)
        assert on_card.dtype == v.dtype
        assert torch.equal(on_card.cpu().view(torch.int16 if v.itemsize == 2
                                              else torch.int32),
                           v.view(torch.int16 if v.itemsize == 2
                                  else torch.int32)), k
    mod = torch.nn.Module()
    mod.lin = torch.nn.Linear(40, 48, device=cuda, dtype=torch.bfloat16)
    convert.load_state(mod, {k: v for k, v in got.items() if "lin" in k})
    assert torch.equal(mod.lin.weight.cpu(), want["lin.weight"])


def test_t5_and_bert_on_card_match_cpu(cuda):
    """TINY_T5 (masked) and TINY_BERT on the card against the CPU, from one
    seeded state dict: within 1e-5 of the largest value (fp32, TF32 off)."""
    import math
    from gsgen_torch.prompt import bert, t5

    def seeded(module, seed):
        gen = torch.Generator().manual_seed(seed)
        return {k: (torch.randn(v.shape, generator=gen)
                    / math.sqrt(v[0].numel() if v.dim() > 1 else 10.0))
                for k, v in module.state_dict().items()}

    sd_t5 = seeded(t5.T5EncoderModel(t5.TINY_T5), 1)
    sd_bert = seeded(bert.BertForMaskedLM(bert.TINY_BERT), 2)
    gen = torch.Generator().manual_seed(3)
    ids = torch.randint(0, 128, (3, 20), generator=gen)
    mask = torch.arange(20)[None] < torch.tensor([[20], [11], [4]])
    out = {}
    for d in (torch.device("cpu"), cuda):
        m5 = t5.load_t5_encoder(sd_t5, t5.TINY_T5, device=d)
        mb = bert.load_bert_mlm(sd_bert, bert.TINY_BERT, device=d)
        with torch.no_grad():
            out[d.type] = (m5(ids.to(d), attention_mask=mask.to(d)).cpu(),
                           mb(ids.to(d), mask.to(d)).cpu())
    for got, want in zip(out["cuda"], out["cpu"]):
        assert torch.isfinite(got).all()
        err = float((got - want).abs().max())
        assert err <= 1e-5 * float(want.abs().max()), err


def test_demo_recon_gate_on_card(cuda, tmp_path):
    """The reconstruction demo's 400-step recipe on the card must reach the
    JAX package's chip bar, 29.0 dB orbit PSNR."""
    from gsgen_torch.tools import demo_recon
    psnr = demo_recon.main(str(tmp_path / "recon.png"), steps=400,
                           device="cuda")
    assert psnr >= 29.0, f"card recon gate: {psnr:.2f} dB < 29.0"


def test_lpips_on_card_matches_cpu(cuda):
    """Random LPIPS weights at 128^2, batch 2: the card within rel 1e-4 of
    the CPU (fp32, TF32 off); PSNR within 1e-4 dB, SSIM within 1e-5."""
    from gsgen_torch.utils import metrics
    params = metrics.init_lpips_params(torch.Generator().manual_seed(1))
    gen = torch.Generator().manual_seed(2)
    a = torch.rand(2, 128, 128, 3, generator=gen)
    b = torch.clamp(a + 0.1 * torch.randn(a.shape, generator=gen), 0, 1)
    want = metrics.lpips(a, b, params)
    got = metrics.lpips(a.to(cuda), b.to(cuda), params).cpu()
    assert torch.allclose(got, want, rtol=1e-4, atol=0)
    m_cpu = metrics.Metrics()(a[0], b[0])
    m_card = metrics.Metrics()(a[0].to(cuda), b[0].to(cuda))
    assert abs(float(m_card["psnr"]) - float(m_cpu["psnr"])) <= 1e-4
    assert abs(float(m_card["ssim"]) - float(m_cpu["ssim"])) <= 1e-5


@pytest.mark.parametrize("kind", ["rt", "fisheye"])
def test_undistort_on_card_matches_cpu(cuda, kind):
    """2^16 points: distortion within 1e-6, the Newton inverse within 1e-5
    of the CPU, and back to the input within 1e-4."""
    from gsgen_torch.tools import undistort as und
    uv = (torch.rand(1 << 16, 2, generator=torch.Generator().manual_seed(3))
          - 0.5) * 1.2
    if kind == "rt":
        fns = und.opencv_lens_distortion, und.opencv_lens_undistortion
        p = torch.tensor([0.1, -0.05, 0.01, -0.02, 0.01, 0.02, -0.01, 0.005])
    else:
        fns = (und.opencv_lens_distortion_fisheye,
               und.opencv_lens_undistortion_fisheye)
        p = torch.tensor([0.05, -0.01, 0.004, -0.001])
    d_cpu = fns[0](uv, p)
    u_cpu = fns[1](d_cpu, p)
    d = fns[0](uv.to(cuda), p.to(cuda))
    u = fns[1](d, p.to(cuda))
    assert float((d.cpu() - d_cpu).abs().max()) <= 1e-6
    assert float((u.cpu() - u_cpu).abs().max()) <= 1e-5
    assert float((u.cpu() - uv).abs().max()) <= 1e-4


def test_viewer_render_on_card(cuda, tmp_path, monkeypatch):
    """A viewer render on the card, PNG-encoded (as where PIL is missing):
    the bytes decode, and the pixels are within 1 of 255 of the CPU
    viewer's."""
    import sys
    from gsgen_torch.io.logging import read_png
    from gsgen_torch.io.viewer import SceneViewer
    from gsgen_torch.models.scene import scene_from_numpy

    monkeypatch.setitem(sys.modules, "PIL", None)
    s = scene3d(3000, seed=4, capacity=4096, mean_std=0.4, svec=0.03)
    rcfg = RenderConfig(dup_cap=1 << 16, chunk=128)
    imgs = {}
    for d in ("cpu", "cuda"):
        v = SceneViewer(scene_from_numpy(s, d), rcfg)
        assert v.content_type == "image/png"
        (tmp_path / f"{d}.png").write_bytes(v.render(
            azimuth=40, elevation=25, distance=2.5, reso=256, fov=50.0))
        imgs[d] = read_png(tmp_path / f"{d}.png")
    assert imgs["cuda"].shape == (256, 256, 3) and imgs["cuda"].max() > 60
    assert np.abs(imgs["cuda"].astype(int) - imgs["cpu"]).max() <= 1
