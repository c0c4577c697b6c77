"""The arithmetic of K5's bf16 instance (``csrc/flash_attn_fwd.cu``, the
wgmma + TMA kernel that serves every bf16 head width), walked on the CPU
and held to the JAX package's einsum attention (its ``Attention`` module,
``gsgen_tpu/guidance/unet2d.py:199-203``, in bf16 with fused attention
off) and to the plain fp32 functions of ``ops/flash_attention.py``.

The kernel walks key tiles of ``fwd_tiles(bfloat16, D)[0]`` keys (the
wrapper passes the same pair to the C entry, which refuses any other).  Per
tile: the scores s in fp32; m, the running max of s * sl2 with sl2 =
scale * log2(e) rounded to fp32; p = bf16(exp2(fma(s, sl2, -m))); l, rescaled
by exp2(m_old - m_new), sums the rounded p; acc, rescaled the same way,
takes p V in fp32.  At the end out = bf16(acc * (1 / l)) and lse = (m +
log2 l) ln 2.  Gates: out within 2e-2 of max|out| (the card's FLASH_TOL).
lse against the plain version's: within 2^-9 absolute, the bound that the
rounding of p sets (each p within 2^-9 of itself relatively, so l too, and
ln(1 + 2^-9) < 2^-9); with l summing p before its rounding (the control),
within 1e-5 of max|lse|, so everything but that rounding is fp32-exact.

The bf16 instances of K6 and K7 above D = 64 (``csrc/flash_attn_bwd.cu``,
64 rows a CTA at the widths of ``bwd_tiles``) are walked the same way:
K6 streams query tiles of 64, K7 key tiles of 64; per tile the scores in
fp32, P = exp2(fma(s, sl2, -lse log2(e))) in fp32, dS = P (dP - Di) from
that exact P, and P and dS rounded to bf16 only as the A operands of dV
+= P^T dO, dK += dS^T Q and dQ += dS K, whose fp32 sums take each tile in
turn.  Gates: each gradient within 3e-2 of its largest value (the card's
FLASH_BWD_TOL) of the plain fp32 formulas and of ``jax.vjp`` of the JAX
package's bf16 attention.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsgen_torch.ops import flash_attention as fa
from gsgen_tpu.guidance import unet2d as unet_j
from torch_fixtures import t

SHAPE = (2, 256, 2)      # [B, L, H]; D is the parameter
LOG2E = 1.4426950408889634
LN2 = 0.6931471805599453
OUT_TOL = 2e-2           # of max|out|: chip_smoke.FLASH_TOL["bfloat16"]
LSE_TOL = 2.0 ** -9      # absolute: the rounding of p to bf16 in l
LSE_FP32_TOL = 1e-5      # of max|lse|: l summing p before its rounding
GRAD_TOL = 3e-2          # of max|grad|: chip_smoke.FLASH_BWD_TOL["bfloat16"]


def heads(x):
    return x.permute(0, 2, 1, 3)          # [B, L, H, D] -> [B, H, L, D]


def fwd_model(q, k, v, scale, l_sums_rounded=True):
    """K5 bf16 on bf16 [B, L, H, D] inputs: (out bf16, lse fp32 [B, H, L]),
    with the kernel's key tiles and roundings.  ``l_sums_rounded=False``:
    l sums p before its rounding to bf16 (the control: not the kernel)."""
    tile, width = fa.fwd_tiles(torch.bfloat16, q.shape[-1])
    assert width >= q.shape[-1]
    qh, kh, vh = (heads(x).float() for x in (q, k, v))
    sl2 = torch.tensor(scale, dtype=torch.float32) * torch.tensor(
        LOG2E, dtype=torch.float32)
    m = torch.full(qh.shape[:3], -torch.inf)
    l = torch.zeros(qh.shape[:3])
    acc = torch.zeros(qh.shape)
    for j0 in range(0, kh.shape[2], tile):
        s = qh @ kh[:, :, j0:j0 + tile].transpose(-1, -2)
        mx = torch.maximum(m, (s * sl2).amax(-1))
        alpha = torch.exp2(m - mx)
        m, l, acc = mx, l * alpha, acc * alpha[..., None]
        # fma: the exact s * sl2 - m, rounded once to fp32
        x = (s.double() * sl2.double() - m[..., None].double()).float()
        p_exact = torch.exp2(x)
        p = p_exact.to(torch.bfloat16).float()
        l = l + (p if l_sums_rounded else p_exact).sum(-1)
        acc = acc + p @ vh[:, :, j0:j0 + tile]
    out = heads(acc * (1.0 / l)[..., None]).to(torch.bfloat16)
    return out, (m + torch.log2(l)) * torch.tensor(LN2, dtype=torch.float32)


def jax_attention_fn(B, L, H, D):
    """The JAX package's Attention as a function of its input x [B, L, 3 H
    D] (bf16): the projections select q, k and v from x and to_out is the
    identity, all exact in bf16, so the result is the einsum core's."""
    inner = H * D
    eye = np.eye(inner, dtype=np.float32)
    zero = np.zeros((inner, inner), np.float32)
    sel = [np.concatenate([eye if i == j else zero for i in range(3)])
           for j in range(3)]
    params = {"params": {
        name: {"kernel": jnp.asarray(w, jnp.bfloat16)}
        for name, w in zip(("to_q", "to_k", "to_v"), sel)}}
    params["params"]["to_out_0"] = {
        "kernel": jnp.asarray(eye, jnp.bfloat16),
        "bias": jnp.zeros((inner,), jnp.bfloat16)}
    attn = unet_j.Attention(heads=H, head_dim=D, out_dim=inner)
    return lambda x: attn.apply(params, x)


def jax_input(q, k, v):
    """q, k, v [B, L, H, D] (bf16 numpy arrays as fp32) as the Attention's
    input."""
    B, L = q.shape[:2]
    return jnp.concatenate([jnp.asarray(a.reshape(B, L, -1))
                            for a in (q, k, v)], axis=-1).astype(jnp.bfloat16)


def jax_attention(q, k, v):
    """The JAX package's Attention on q, k, v [B, L, H, D] (bf16 numpy
    arrays as fp32), fused attention off: the einsum core."""
    B, L, H, D = q.shape
    unet_j.set_fused_attention("off")
    try:
        y = jax_attention_fn(B, L, H, D)(jax_input(q, k, v))
    finally:
        unet_j.set_fused_attention("auto")
    return np.asarray(y.astype(jnp.float32)).reshape(B, L, H, D)


def jax_attention_vjp(q, k, v, dout):
    """(dq, dk, dv) of the JAX package's bf16 Attention (fused attention
    off) by ``jax.vjp`` with cotangent dout, all [B, L, H, D] numpy arrays
    (bf16 values as fp32): the input's gradient split back into q's, k's
    and v's parts (the selections transpose exactly)."""
    B, L, H, D = q.shape
    unet_j.set_fused_attention("off")
    try:
        _, vjp = jax.vjp(jax_attention_fn(B, L, H, D), jax_input(q, k, v))
        (dx,) = vjp(jnp.asarray(dout.reshape(B, L, H * D), jnp.bfloat16))
    finally:
        unet_j.set_fused_attention("auto")
    dx = np.asarray(dx.astype(jnp.float32)).reshape(B, L, 3, H, D)
    return dx[:, :, 0], dx[:, :, 1], dx[:, :, 2]


def bwd_model(q, k, v, dout, lse, delta, scale):
    """K6 and K7 bf16 above D = 64 on bf16 [B, L, H, D] inputs, lse and
    delta [B, H, L] fp32: (dq, dk, dv) in bf16, with the kernels' tiles
    and roundings (see the module docstring)."""
    rows, width = fa.bwd_tiles(torch.bfloat16, q.shape[-1])
    assert rows == 64 and width >= q.shape[-1]
    tile = rows                        # each streamed tile: 64 rows too
    qh, kh, vh, oh = (heads(x).float() for x in (q, k, v, dout))
    sl2 = torch.tensor(scale, dtype=torch.float32) * torch.tensor(
        LOG2E, dtype=torch.float32)
    l2 = lse * torch.tensor(LOG2E, dtype=torch.float32)

    def probs(s, l2_rows):
        # fma: the exact s * sl2 - lse log2(e), rounded once to fp32
        return torch.exp2((s.double() * sl2.double()
                           - l2_rows.double()).float())

    def bf16(x):
        return x.to(torch.bfloat16).float()

    L = qh.shape[2]
    dk, dv, dq = (torch.zeros(qh.shape) for _ in range(3))
    for i in range(0, L, tile):        # K6: streamed query tiles
        qt, ot = qh[:, :, i:i + tile], oh[:, :, i:i + tile]
        pt = probs(kh @ qt.transpose(-1, -2), l2[:, :, None, i:i + tile])
        dst = pt * (vh @ ot.transpose(-1, -2)
                    - delta[:, :, None, i:i + tile])
        dv = dv + bf16(pt) @ ot
        dk = dk + bf16(dst) @ qt
    for j in range(0, L, tile):        # K7: streamed key tiles
        kt, vt = kh[:, :, j:j + tile], vh[:, :, j:j + tile]
        p = probs(qh @ kt.transpose(-1, -2), l2[..., None])
        ds = p * (oh @ vt.transpose(-1, -2) - delta[..., None])
        dq = dq + bf16(ds) @ kt
    return tuple(heads(x).to(torch.bfloat16)
                 for x in (dq * scale, dk * scale, dv))


def inputs(D, seed, n=3):
    """n tensors (q, k, v and, n = 4, dout) in bf16 (as torch tensors) and
    the same values as fp32 numpy arrays."""
    rng = np.random.default_rng(seed)
    ts = tuple(t(rng.standard_normal((*SHAPE, D)).astype(np.float32))
               .to(torch.bfloat16) for _ in range(n))
    return ts, [x.float().numpy() for x in ts]


def max_err(a, b) -> tuple[float, float]:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max()), float(np.abs(b).max())


@pytest.mark.parametrize("D", [16, 40, 64, 80, 160])
def test_bf16_forward_model_matches_references(D):
    """The model at [2, 256, 2, D]: two key tiles of 128 (D <= 80) or four
    of 64 (D = 160), so the rescaling runs; against the JAX package's bf16
    attention and the plain version."""
    (tq, tk, tv), arrays = inputs(D, 50 + D)
    scale = 1.0 / np.sqrt(D)
    out, lse = fwd_model(tq, tk, tv, scale)
    assert out.dtype == torch.bfloat16 and out.shape == tq.shape
    out_p, lse_p = fa.flash_self_attention_plain_lse(tq, tk, tv, scale)
    out_j = jax_attention(*arrays)
    for ref in (out_j, out_p.float().numpy()):
        err, top = max_err(out.float().numpy(), ref)
        assert err <= OUT_TOL * top, (err, top)
    err, top = max_err(lse.numpy(), lse_p.numpy())
    assert err <= LSE_TOL, (err, top)
    _, lse_c = fwd_model(tq, tk, tv, scale, l_sums_rounded=False)
    err, top = max_err(lse_c.numpy(), lse_p.numpy())
    assert err <= LSE_FP32_TOL * top, (err, top)
    # the plain version is the JAX package's core: the same bf16 rounding
    # of the normalised weights
    err, top = max_err(out_p.float().numpy(), out_j)
    assert err <= 2 ** -7 * top, (err, top)


@pytest.mark.parametrize("D, tiles", [
    (8, (128, 40)), (16, (128, 40)), (24, (128, 40)), (40, (128, 40)),
    (48, (128, 64)), (64, (128, 64)), (72, (128, 80)), (80, (128, 80)),
    (88, (64, 160)), (96, (64, 160)), (128, (64, 160)), (136, (64, 160)),
    (160, (64, 160))])
def test_fwd_tiles_instances(D, tiles):
    """The bf16 instance each head width launches: D rounded up to a built
    P V width, 128 keys a tile up to width 80 and 64 above; fp32: the wgmma
    instance, 64 keys a tile at width 16, 32 or 64 (D rounded up), or the
    mma.sync instance, 32 keys at width 160, above 64."""
    assert fa.fwd_tiles(torch.bfloat16, D) == tiles
    width = next((w for w in (16, 32, 64) if w >= D), 160)
    assert fa.fwd_tiles(torch.float32, D) == (
        (64, width) if width <= 64 else (32, 160))


@pytest.mark.parametrize("D", [72, 80, 120, 160])
def test_bf16_backward_model_matches_references(D):
    """The K6 / K7 model at [2, 256, 2, D]: four query tiles and four key
    tiles of 64, widths 80 (D = 72, 80) and 160 (D = 120, 160); each
    gradient against the plain fp32 formulas (the same lse and Di) and
    against jax.vjp of the JAX package's bf16 attention."""
    (tq, tk, tv, tdo), arrays = inputs(D, 90 + D, n=4)
    scale = 1.0 / np.sqrt(D)
    out_p, lse_p = fa.flash_self_attention_plain_lse(tq, tk, tv, scale)
    delta = fa.attention_delta(out_p, tdo)
    got = bwd_model(tq, tk, tv, tdo, lse_p, delta, scale)
    want = fa.flash_self_attention_bwd_plain(tq, tk, tv, out_p, lse_p, tdo,
                                             scale)
    want_j = jax_attention_vjp(*arrays)
    for name, g, w, wj in zip(("dq", "dk", "dv"), got, want, want_j):
        assert g.dtype == torch.bfloat16 and g.shape == tq.shape
        for ref in (w.float().numpy(), wj):
            err, top = max_err(g.float().numpy(), ref)
            assert err <= GRAD_TOL * top, (name, err, top)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("D", [8, 40, 64, 72, 80, 88, 120, 160])
def test_bwd_tiles_instances(dtype, D):
    """The K6 / K7 instance each head width launches, (rows a CTA, width):
    bf16 (128, 64) up to D = 64, then 64 rows at width 80 (D = 72, 80) or
    160 (D = 88-160); fp32 (64, 64) up to D = 64 (3xTF32 wgmma), then the
    mma.sync instance (64, 160)."""
    dt = getattr(torch, dtype)
    if D <= 64:
        want = (128 if dt == torch.bfloat16 else 64, 64)
    elif dt == torch.bfloat16:
        want = (64, 80 if D <= 80 else 160)
    else:
        want = (64, 160)
    assert fa.bwd_tiles(dt, D) == want


@pytest.mark.parametrize("D", [0, 168, 256])
def test_bwd_tiles_refuses_widths_past_160(D):
    """No instance past D = 160 (nor at 0) in either type."""
    for dt in (torch.bfloat16, torch.float32):
        with pytest.raises(ValueError):
            fa.bwd_tiles(dt, D)
