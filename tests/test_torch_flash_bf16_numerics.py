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
"""

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


def jax_attention(q, k, v):
    """The JAX package's Attention on q, k, v [B, L, H, D] (bf16 numpy
    arrays as fp32): the projections select q, k and v from one
    concatenated input and to_out is the identity, all exact in bf16, so
    the result is the einsum core's."""
    B, L, H, D = q.shape
    inner = H * D
    x = jnp.concatenate([jnp.asarray(a.reshape(B, L, inner))
                         for a in (q, k, v)], axis=-1).astype(jnp.bfloat16)
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
    unet_j.set_fused_attention("off")
    try:
        y = attn.apply(params, x)
    finally:
        unet_j.set_fused_attention("auto")
    return np.asarray(y.astype(jnp.float32)).reshape(B, L, H, D)


def inputs(D, seed):
    """q, k, v in bf16 (as torch tensors) and the same values as fp32
    numpy arrays."""
    rng = np.random.default_rng(seed)
    tq, tk, tv = (t(rng.standard_normal((*SHAPE, D)).astype(np.float32))
                  .to(torch.bfloat16) for _ in range(3))
    return (tq, tk, tv), [x.float().numpy() for x in (tq, tk, tv)]


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
