"""The 3xTF32 arithmetic of K5's, K6's and K7's fp32 instances, emulated on
the CPU and held to the plain fp32 functions and the JAX package's fp32
einsum attention (``gsgen_tpu/guidance/unet2d.py:199-203``, fused attention
off).

The kernels split each fp32 operand x into hi = tf32(x) and lo = tf32(x -
hi) (``cvt.rna``: round to nearest, ties away, to a 10-bit mantissa) and
compute each product as lo_a hi_b + hi_a lo_b + hi_a hi_b with fp32
accumulation.  Here the split is done by bit arithmetic and the products
by fp32 matmuls.  Each kernel has two walks (``walk``).  K5's online
softmax:

* ``wgmma`` (D <= 64): key tiles of 64; each tile's P, split into hi and
  lo A fragments, times V's hi / lo planes into partial sums, folded into
  O by one rounded FMA that takes the rescale alpha.
* ``mma_sync`` (the instance kept for D = 72-160): key tiles of 32, O
  rescaled and the tile's P V added into it.

K6 and K7:

* ``wgmma`` (D <= 64): K6 walks query tiles of 64.  Per tile it forms S
  and dP, and writes P as hi and lo planes.  dS takes P back as hi + lo.
  dV^T = dO^T P and dK^T = Q^T dS go to partial sums, which are folded
  into the totals by fp32 adds.  K7 walks key tiles of 64 the same way:
  S^T, dP^T, dS^T from the exact P^T, then dQ^T = K^T dS^T folded in.
* ``mma_sync`` (the instance kept for D = 72-160): K6 in whole products.
  K7 walks key tiles of 32 whose K is split into hi and lo planes, with dS
  fed to dQ += dS K in the order of its register fragment.

Gate: 1e-5 of each output's largest value, a tenth of the kernels' 1e-4
gate on the card.  A single TF32 product (hi only) is held to be at least
ten times worse, so the split is what buys the accuracy.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsgen_torch.ops import flash_attention as fa
from torch_fixtures import t

SHAPE = (2, 256, 2)      # [B, L, H]; D is the parameter
KEY_TILE = 32            # keys per tile of K5's fp32 mma.sync instance
WG_TILE = 64             # keys (K5, K7) / queries (K6) a tile of the wgmma
                         # walk
DQ_KEY_TILE = 32         # keys per tile of K7's mma.sync instance
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


def fwd_emulated(q, k, v, scale, mm, walk="wgmma"):
    """K5 fp32: online softmax over key tiles, log2 units, exp2.
    ``wgmma``: tiles of 64 keys, each tile's P V (both split) a partial
    sum folded into O as fma(O, alpha, part), one rounding (fp64 holds
    the product exactly).  ``mma_sync``: tiles of 32 keys, O rescaled,
    then the tile's P V added."""
    qh, kh, vh = heads(q), heads(k), heads(v)
    sl2 = torch.tensor(scale * LOG2E, dtype=torch.float32)
    m = torch.full(qh.shape[:3], -torch.inf)
    l = torch.zeros(qh.shape[:3])
    acc = torch.zeros(qh.shape)
    tile = WG_TILE if walk == "wgmma" else KEY_TILE
    for j0 in range(0, kh.shape[2], tile):
        s = mm(qh, kh[:, :, j0:j0 + tile].transpose(-1, -2))
        mx = torch.maximum(m, s.amax(-1) * sl2)
        alpha = torch.exp2(m - mx)
        m, l = mx, l * alpha
        p = torch.exp2(s * sl2 - m[..., None])
        l = l + p.sum(-1)
        part = mm(p, vh[:, :, j0:j0 + tile])
        if walk == "wgmma":
            acc = (acc.double() * alpha[..., None].double()
                   + part.double()).float()
        else:
            acc = acc * alpha[..., None] + part
    lse = (m + torch.log2(l)) * np.float32(np.log(2.0))
    return heads(acc / l[..., None]), lse


def dkv_emulated(q, k, v, dout, lse, delta, scale, mm, walk="wgmma",
                 p_planes=2):
    """K6 fp32, every product split.  ``wgmma``: per tile of 64 queries, S
    = Q K^T and dP = dO V^T; P to hi and lo planes, dS = (hi + lo) (dP -
    Di) (``p_planes`` 1: hi alone, the control); the tile's dO^T P and Q^T
    dS folded into dV^T and dK^T by fp32 adds.  ``mma_sync``: P^T, dS^T and
    the two sums over all queries at once."""
    qh, kh, vh, doh = heads(q), heads(k), heads(v), heads(dout)
    sl2 = torch.tensor(scale * LOG2E, dtype=torch.float32)
    if walk == "mma_sync":
        pt = torch.exp2(mm(kh, qh.transpose(-1, -2)) * sl2
                        - (lse * LOG2E)[:, :, None, :])
        dst = pt * (mm(vh, doh.transpose(-1, -2)) - delta[:, :, None, :])
        return heads(mm(dst, qh) * scale), heads(mm(pt, doh))
    acc_v = torch.zeros(kh.transpose(-1, -2).shape)
    acc_k = torch.zeros(acc_v.shape)
    for i0 in range(0, qh.shape[2], WG_TILE):
        rows = slice(i0, i0 + WG_TILE)
        qt, ot = qh[:, :, rows], doh[:, :, rows]
        p = torch.exp2(mm(qt, kh.transpose(-1, -2)) * sl2
                       - (lse[:, :, rows] * LOG2E)[..., None])
        p_hi = tf32(p)
        p_back = p_hi + tf32(p - p_hi) if p_planes == 2 else p_hi
        ds = p_back * (mm(ot, vh.transpose(-1, -2))
                       - delta[:, :, rows, None])
        acc_v = acc_v + mm(ot.transpose(-1, -2), p)
        acc_k = acc_k + mm(qt.transpose(-1, -2), ds)
    return (heads(acc_k.transpose(-1, -2) * scale),
            heads(acc_v.transpose(-1, -2)))


def dq_emulated(q, k, v, dout, lse, delta, scale, mm, walk="wgmma",
                b_order=FRAG_K):
    """K7 fp32.  ``wgmma``: per tile of 64 keys, S^T = K Q^T and dP^T = V
    dO^T as three TF32 products each, dS^T = P^T (dP^T - Di) in fp32, and
    the tile's K^T dS^T folded into dQ^T by an fp32 add.  ``mma_sync``:
    per tile of 32 keys, S and dP as three TF32 products, dS in fp32, then
    this tile's dS K from K's hi / lo planes with dS's columns in fragment
    order and K's rows in ``b_order`` (the kernel's: the same order),
    folded into dQ by an fp32 add."""
    qh, kh, vh, doh = heads(q), heads(k), heads(v), heads(dout)
    sl2 = torch.tensor(scale * LOG2E, dtype=torch.float32)
    if walk == "wgmma":
        acc = torch.zeros(qh.transpose(-1, -2).shape)
        for j0 in range(0, kh.shape[2], WG_TILE):
            kt = kh[:, :, j0:j0 + WG_TILE]
            pt = torch.exp2(mm(kt, qh.transpose(-1, -2)) * sl2
                            - (lse * LOG2E)[:, :, None, :])
            dst = pt * (mm(vh[:, :, j0:j0 + WG_TILE], doh.transpose(-1, -2))
                        - delta[:, :, None, :])
            acc = acc + mm(kt.transpose(-1, -2), dst)
        return heads(acc.transpose(-1, -2) * scale)
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


# K5: the wgmma walk at each built P V width (16, 32, 64) and at SD 1.5's
# 40 (zero-filled to 64); the mma.sync walk of the D <= 160 instance
FWD_WALKS = [("wgmma", 16), ("wgmma", 32), ("wgmma", 40), ("wgmma", 64),
             ("mma_sync", 160)]


@pytest.mark.parametrize("walk, D", FWD_WALKS)
def test_3xtf32_forward_matches_fp32(walk, D):
    q, k, v, _ = inputs(D, 10 + D)
    scale = 1.0 / np.sqrt(D)
    tq, tk, tv = (t(x) for x in (q, k, v))
    assert fa.fwd_tiles(torch.float32, D)[0] == (
        WG_TILE if walk == "wgmma" else KEY_TILE)
    out, lse = fwd_emulated(tq, tk, tv, scale, mm3, walk)
    out_p, lse_p = fa.flash_self_attention_plain_lse(tq, tk, tv, scale)
    out_j = jax_core(scale)(*(jnp.asarray(x) for x in (q, k, v)))
    assert rel_err(out, out_p) <= TOL
    assert rel_err(out, out_j) <= TOL
    assert rel_err(lse, lse_p) <= TOL
    out_1, _ = fwd_emulated(tq, tk, tv, scale, mm1, walk)
    assert rel_err(out_1, out_p) >= 10 * rel_err(out, out_p)


# the wgmma walk at one k-step of head dims, at SD 1.5's and SD 2.1's
# widths; the mma.sync walk of the D <= 160 instance
WALKS = [("wgmma", 8), ("wgmma", 40), ("wgmma", 64), ("mma_sync", 160)]


@pytest.mark.parametrize("walk, D", WALKS)
def test_3xtf32_dkv_matches_fp32(walk, D):
    q, k, v, dout = inputs(D, 20 + D)
    scale = 1.0 / np.sqrt(D)
    tq, tk, tv, tdo = (t(x) for x in (q, k, v, dout))
    out, lse = fa.flash_self_attention_plain_lse(tq, tk, tv, scale)
    delta = fa.attention_delta(out, tdo)
    dk, dv = dkv_emulated(tq, tk, tv, tdo, lse, delta, scale, mm3, walk)
    dk_p, dv_p = fa.flash_bwd_dkv_plain(tq, tk, tv, tdo, lse, delta, scale)
    _, vjp = jax.vjp(jax_core(scale), *(jnp.asarray(x) for x in (q, k, v)))
    _, dk_j, dv_j = vjp(jnp.asarray(dout))
    for got, plain, ref in ((dk, dk_p, dk_j), (dv, dv_p, dv_j)):
        assert rel_err(got, plain) <= TOL
        assert rel_err(got, ref) <= TOL
    dk_1, dv_1 = dkv_emulated(tq, tk, tv, tdo, lse, delta, scale, mm1, walk)
    assert rel_err(dk_1, dk_p) >= 10 * rel_err(dk, dk_p)
    assert rel_err(dv_1, dv_p) >= 10 * rel_err(dv, dv_p)
    if walk == "wgmma":
        # dS from P's hi plane alone: the lo plane must be read back too
        dk_x, _ = dkv_emulated(tq, tk, tv, tdo, lse, delta, scale, mm3,
                               walk, p_planes=1)
        assert rel_err(dk_x, dk_p) >= 10 * TOL


@pytest.mark.parametrize("walk, D", WALKS)
def test_3xtf32_dq_matches_fp32(walk, D):
    q, k, v, dout = inputs(D, 30 + D)
    scale = 1.0 / np.sqrt(D)
    tq, tk, tv, tdo = (t(x) for x in (q, k, v, dout))
    out, lse = fa.flash_self_attention_plain_lse(tq, tk, tv, scale)
    delta = fa.attention_delta(out, tdo)
    dq = dq_emulated(tq, tk, tv, tdo, lse, delta, scale, mm3, walk)
    dq_p = fa.flash_bwd_dq_plain(tq, tk, tv, tdo, lse, delta, scale)
    _, vjp = jax.vjp(jax_core(scale), *(jnp.asarray(x) for x in (q, k, v)))
    dq_j = vjp(jnp.asarray(dout))[0]
    assert rel_err(dq, dq_p) <= TOL
    assert rel_err(dq, dq_j) <= TOL
    dq_1 = dq_emulated(tq, tk, tv, tdo, lse, delta, scale, mm1, walk)
    assert rel_err(dq_1, dq_p) >= 10 * rel_err(dq, dq_p)
    if walk == "mma_sync":
        # K's rows left in key order while dS's columns are in fragment
        # order: the permutation must be applied to both operands
        dq_x = dq_emulated(tq, tk, tv, tdo, lse, delta, scale, mm3, walk,
                           b_order=torch.arange(8))
        assert rel_err(dq_x, dq_p) > 0.1
