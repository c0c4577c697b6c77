"""The 3xTF32 arithmetic of K5's, K6's and K7's fp32 instances, emulated on
the CPU and held to the plain fp32 functions and the JAX package's fp32
einsum attention (``gsgen_tpu/guidance/unet2d.py:199-203``, fused attention
off).

The kernels split each fp32 operand x into hi = tf32(x) and lo = tf32(x -
hi) (``cvt.rna``: round to nearest, ties away, to a 10-bit mantissa) and
compute each product as lo_a hi_b + hi_a lo_b + hi_a hi_b with fp32
accumulation.  Here the split is done by bit arithmetic and the products
by fp32 matmuls; K5's online softmax walks key tiles of 32 as the kernel
does, K7 key tiles of 32 whose K is split into hi and lo planes (the
values are the same whether the kernel splits a tile once or each fragment
as it loads), with dS fed to dQ += dS K in the order of its register
fragment.  Gate: 1e-5 of each output's largest value, a tenth of the kernels'
1e-4 gate on the card; a single TF32 product (hi only) is held to be at
least ten times worse, so the split is what buys the accuracy.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsgen_torch.ops import flash_attention as fa
from torch_fixtures import t

SHAPE = (2, 256, 2)      # [B, L, H]; D is the parameter
KEY_TILE = 32            # keys per tile of K5's fp32 instance
DQ_KEY_TILE = 32         # keys per tile of K7's fp32 instance
# K7's dS fragment as the A operand of dQ += dS K: in each step of 8 keys,
# lane t's keys 2t and 2t + 1 stand at k = t and k = t + 4
FRAG_K = torch.tensor([0, 2, 4, 6, 1, 3, 5, 7])
LOG2E = 1.4426950408889634
TOL = 1e-5


def tf32(x: torch.Tensor) -> torch.Tensor:
    """Round fp32 to the nearest TF32 value, ties away from zero."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def mm3(a, b):
    """a @ b as the kernels compute it: three TF32 products."""
    ah, bh = tf32(a), tf32(b)
    al, bl = tf32(a - ah), tf32(b - bh)
    return al @ bh + ah @ bl + ah @ bh


def mm1(a, b):
    """a @ b as one TF32 product (the control)."""
    return tf32(a) @ tf32(b)


def heads(x):
    return x.permute(0, 2, 1, 3)          # [B, L, H, D] -> [B, H, L, D]


def fwd_emulated(q, k, v, scale, mm):
    """K5 fp32: online softmax over key tiles, log2 units, exp2."""
    qh, kh, vh = heads(q), heads(k), heads(v)
    sl2 = torch.tensor(scale * LOG2E, dtype=torch.float32)
    m = torch.full(qh.shape[:3], -torch.inf)
    l = torch.zeros(qh.shape[:3])
    acc = torch.zeros(qh.shape)
    for j0 in range(0, kh.shape[2], KEY_TILE):
        s = mm(qh, kh[:, :, j0:j0 + KEY_TILE].transpose(-1, -2))
        mx = torch.maximum(m, (s * sl2).amax(-1))
        alpha = torch.exp2(m - mx)
        m, l, acc = mx, l * alpha, acc * alpha[..., None]
        p = torch.exp2(s * sl2 - m[..., None])
        l = l + p.sum(-1)
        acc = acc + mm(p, vh[:, :, j0:j0 + KEY_TILE])
    lse = (m + torch.log2(l)) * np.float32(np.log(2.0))
    return heads(acc / l[..., None]), lse


def dkv_emulated(q, k, v, dout, lse, delta, scale, mm):
    """K6 fp32: P^T, dS^T and the two sums, every product split."""
    qh, kh, vh, doh = heads(q), heads(k), heads(v), heads(dout)
    sl2 = torch.tensor(scale * LOG2E, dtype=torch.float32)
    pt = torch.exp2(mm(kh, qh.transpose(-1, -2)) * sl2
                    - (lse * LOG2E)[:, :, None, :])
    dst = pt * (mm(vh, doh.transpose(-1, -2)) - delta[:, :, None, :])
    return heads(mm(dst, qh) * scale), heads(mm(pt, doh))


def dq_emulated(q, k, v, dout, lse, delta, scale, mm, b_order=FRAG_K):
    """K7 fp32: per key tile, S and dP as three TF32 products, dS in fp32,
    then this tile's dS K from K's hi / lo planes with dS's
    columns in fragment order and K's rows in ``b_order`` (the kernel's:
    the same order), folded into dQ by an fp32 add."""
    qh, kh, vh, doh = heads(q), heads(k), heads(v), heads(dout)
    sl2 = torch.tensor(scale * LOG2E, dtype=torch.float32)
    a_idx = torch.cat([FRAG_K + 8 * i for i in range(DQ_KEY_TILE // 8)])
    b_idx = torch.cat([b_order + 8 * i for i in range(DQ_KEY_TILE // 8)])
    acc = torch.zeros(qh.shape)
    for j0 in range(0, kh.shape[2], DQ_KEY_TILE):
        kt = kh[:, :, j0:j0 + DQ_KEY_TILE]
        k_hi = tf32(kt)
        k_lo = tf32(kt - k_hi)
        s = mm(qh, kt.transpose(-1, -2))
        dp = mm(doh, vh[:, :, j0:j0 + DQ_KEY_TILE].transpose(-1, -2))
        ds = torch.exp2(s * sl2 - (lse * LOG2E)[..., None]) * (
            dp - delta[..., None])
        if mm is mm1:
            part = tf32(ds[..., a_idx]) @ k_hi[:, :, b_idx]
        else:
            a = ds[..., a_idx]
            a_hi = tf32(a)
            a_lo = tf32(a - a_hi)
            part = (a_lo @ k_hi[:, :, b_idx] + a_hi @ k_lo[:, :, b_idx]
                    + a_hi @ k_hi[:, :, b_idx])
        acc = acc + part
    return heads(acc * scale)


def jax_core(scale):
    """The JAX package's einsum attention (unet2d.py:199-203)."""
    def core(q_, k_, v_):
        attn = jnp.einsum("blhd,bshd->bhls", q_, k_,
                          preferred_element_type=jnp.float32) * scale
        attn = jax.nn.softmax(attn.astype(jnp.float32), axis=-1)
        return jnp.einsum("bhls,bshd->blhd", attn.astype(v_.dtype), v_)
    return core


def inputs(D, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((*SHAPE, D)).astype(np.float32)
            for _ in range(4)]


def rel_err(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.mark.parametrize("D", [40, 64])
def test_3xtf32_forward_matches_fp32(D):
    q, k, v, _ = inputs(D, 10 + D)
    scale = 1.0 / np.sqrt(D)
    tq, tk, tv = (t(x) for x in (q, k, v))
    out, lse = fwd_emulated(tq, tk, tv, scale, mm3)
    out_p, lse_p = fa.flash_self_attention_plain_lse(tq, tk, tv, scale)
    out_j = jax_core(scale)(*(jnp.asarray(x) for x in (q, k, v)))
    assert rel_err(out, out_p) <= TOL
    assert rel_err(out, out_j) <= TOL
    assert rel_err(lse, lse_p) <= TOL
    out_1, _ = fwd_emulated(tq, tk, tv, scale, mm1)
    assert rel_err(out_1, out_p) >= 10 * rel_err(out, out_p)


@pytest.mark.parametrize("D", [40, 64])
def test_3xtf32_dkv_matches_fp32(D):
    q, k, v, dout = inputs(D, 20 + D)
    scale = 1.0 / np.sqrt(D)
    tq, tk, tv, tdo = (t(x) for x in (q, k, v, dout))
    out, lse = fa.flash_self_attention_plain_lse(tq, tk, tv, scale)
    delta = fa.attention_delta(out, tdo)
    dk, dv = dkv_emulated(tq, tk, tv, tdo, lse, delta, scale, mm3)
    dk_p, dv_p = fa.flash_bwd_dkv_plain(tq, tk, tv, tdo, lse, delta, scale)
    _, vjp = jax.vjp(jax_core(scale), *(jnp.asarray(x) for x in (q, k, v)))
    _, dk_j, dv_j = vjp(jnp.asarray(dout))
    for got, plain, ref in ((dk, dk_p, dk_j), (dv, dv_p, dv_j)):
        assert rel_err(got, plain) <= TOL
        assert rel_err(got, ref) <= TOL
    dk_1, dv_1 = dkv_emulated(tq, tk, tv, tdo, lse, delta, scale, mm1)
    assert rel_err(dk_1, dk_p) >= 10 * rel_err(dk, dk_p)
    assert rel_err(dv_1, dv_p) >= 10 * rel_err(dv, dv_p)


@pytest.mark.parametrize("D", [40, 64])
def test_3xtf32_dq_matches_fp32(D):
    q, k, v, dout = inputs(D, 30 + D)
    scale = 1.0 / np.sqrt(D)
    tq, tk, tv, tdo = (t(x) for x in (q, k, v, dout))
    out, lse = fa.flash_self_attention_plain_lse(tq, tk, tv, scale)
    delta = fa.attention_delta(out, tdo)
    dq = dq_emulated(tq, tk, tv, tdo, lse, delta, scale, mm3)
    dq_p = fa.flash_bwd_dq_plain(tq, tk, tv, tdo, lse, delta, scale)
    _, vjp = jax.vjp(jax_core(scale), *(jnp.asarray(x) for x in (q, k, v)))
    dq_j = vjp(jnp.asarray(dout))[0]
    assert rel_err(dq, dq_p) <= TOL
    assert rel_err(dq, dq_j) <= TOL
    dq_1 = dq_emulated(tq, tk, tv, tdo, lse, delta, scale, mm1)
    assert rel_err(dq_1, dq_p) >= 10 * rel_err(dq, dq_p)
    # K's rows left in key order while dS's columns are in fragment order:
    # the permutation must be applied to both operands
    dq_x = dq_emulated(tq, tk, tv, tdo, lse, delta, scale, mm3,
                       b_order=torch.arange(8))
    assert rel_err(dq_x, dq_p) > 0.1
