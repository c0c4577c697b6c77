"""The 3xTF32 arithmetic of the fp32 convolution kernel
(``csrc/conv_3xtf32.cu``), emulated on the CPU and held to the plain fp32
``F.conv2d`` and the JAX package's convolution (``lax.conv_general_dilated``
at ``Precision.HIGHEST``, what ``nn.Conv`` computes in fp32).

The kernel is an implicit GEMM: M output pixels by Cout channels over K =
Cin R R in the weight's own (ci, r, s) order, in chunks of 32.  The
activations split into hi = tf32(x) (round to nearest, ties away) and lo =
tf32(x - hi); the weights' hi is the raw value, which the tensor cores read
truncated to TF32, and lo = tf32(w - trunc(w)).  Each product is lo_a hi_b
+ hi_a lo_b + hi_a hi_b.  Each
pair of chunks goes to partial sums that an fp32 add folds into the totals;
with K split into ranges, each range's totals are summed in order and the
bias added last.  Here the split is bit arithmetic, the partial sums fp32
matmuls.

Gate: 1e-5 of the output's largest value.  A single TF32 product (hi
only) is held to be at least ten times worse.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from gsgen_torch.ops import conv

TOL = 1e-5
FOLD = 2 * conv.BK          # k a partial sum holds


def tf32(x: torch.Tensor) -> torch.Tensor:
    """Round fp32 to the nearest TF32 value, ties away from zero."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def trunc(x: torch.Tensor) -> torch.Tensor:
    """fp32 truncated to TF32: the top 19 bits, what the tensor cores read
    of a raw fp32 operand."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def mm3(a, b):
    """a @ b as the kernel computes it, a the activations and b the
    weights: three TF32 products."""
    ah, bh = tf32(a), trunc(b)
    al, bl = tf32(a - ah), tf32(b - bh)
    return al @ bh + ah @ bl + ah @ bh


def mm1(a, b):
    """a @ b as one TF32 product of the same hi (the control)."""
    return tf32(a) @ trunc(b)


def conv_emulated(x, w, b, stride, pad, mm, splits=1):
    """The kernel's walk: im2col rows [M, K] in (ci, r, s) order, each
    split's K range in partial sums of :data:`FOLD` k folded by fp32
    adds, the splits' totals added in order, then the bias."""
    N, _, H, W = x.shape
    Cout, _, R, _ = w.shape
    Ho, Wo = conv.out_size(H, R, stride, pad), conv.out_size(W, R, stride,
                                                              pad)
    a = F.unfold(x, R, padding=pad, stride=stride).transpose(1, 2)
    a = a.reshape(-1, a.shape[-1])
    bt = w.reshape(Cout, -1).t()
    K = a.shape[1]
    chunks = -(-K // conv.BK)
    cps = -(-chunks // splits)
    out = None
    for z in range(splits):
        k0, k1 = z * cps * conv.BK, min((z + 1) * cps * conv.BK, K)
        acc = torch.zeros(a.shape[0], Cout)
        for g in range(k0, k1, FOLD):
            g1 = min(g + FOLD, k1)
            acc = acc + mm(a[:, g:g1], bt[g:g1])
        out = acc if out is None else out + acc
    out = out + b
    return out.reshape(N, Ho, Wo, Cout).permute(0, 3, 1, 2)


def jax_conv(x, w, b, stride, pad):
    y = jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(w), (stride, stride),
        [(pad, pad), (pad, pad)], dimension_numbers=("NCHW", "OIHW", "NCHW"),
        precision=jax.lax.Precision.HIGHEST)
    return y + jnp.asarray(b)[None, :, None, None]


def rel_err(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


# (label, Cin, R, stride, pad, asym, splits): 3x3 at stride 1 (whole and in
# 3 K ranges), 3x3 at stride 2 with symmetric padding and with the VAE's
# (0, 1) x (0, 1) padding before a pad-0 call, 1x1; K >= 2,304 throughout
CASES = [("3x3 s1", 256, 3, 1, 1, False, 1),
         ("3x3 s1 split 3", 256, 3, 1, 1, False, 3),
         ("3x3 s2", 256, 3, 2, 1, False, 1),
         ("3x3 s2 asym", 256, 3, 2, 0, True, 1),
         ("1x1", 2304, 1, 1, 0, False, 1)]


@pytest.mark.parametrize("label, Cin, R, stride, pad, asym, splits", CASES)
def test_3xtf32_conv_matches_fp32(label, Cin, R, stride, pad, asym, splits):
    rng = np.random.default_rng(Cin + 10 * R + stride + splits)
    x = rng.standard_normal((2, Cin, 8, 8)).astype(np.float32)
    if asym:
        x = np.pad(x, ((0, 0), (0, 0), (0, 1), (0, 1)))
    w = (rng.standard_normal((32, Cin, R, R))
         / np.sqrt(Cin * R * R)).astype(np.float32)
    b = rng.standard_normal(32).astype(np.float32)
    tx, tw, tb = (torch.from_numpy(v) for v in (x, w, b))
    got = conv_emulated(tx, tw, tb, stride, pad, mm3, splits)
    plain = conv.conv2d_3xtf32(tx, tw, tb, stride, pad)
    ref = jax_conv(x, w, b, stride, pad)
    assert got.shape == plain.shape == ref.shape
    assert rel_err(got, plain) <= TOL
    assert rel_err(got, ref) <= TOL
    one = conv_emulated(tx, tw, tb, stride, pad, mm1, splits)
    assert rel_err(one, plain) >= 10 * rel_err(got, plain)


# (M, Cout, K) -> splits on 132 SMs: SD 2.1's 3x3 levels at CFG batch 8
# and the LoRA pass's batch 4 (64^2 and 32^2 fill the card alone; 16^2
# at batch 4 and 8^2 split K)
SPLITS = [((32768, 320, 2880), 1), ((8192, 640, 5760), 1),
          ((2048, 1280, 11520), 1), ((1024, 1280, 11520), 2),
          ((512, 1280, 23040), 4), ((256, 1280, 11520), 8),
          ((256, 1280, 2560), 8), ((128, 32, 36), 1)]


@pytest.mark.parametrize("shape, want", SPLITS)
def test_split_k_fills_the_card(shape, want):
    M, Cout, K = shape
    s = conv.split_k(M, Cout, K, 132)
    assert s == want
    chunks = -(-K // conv.BK)
    cps = -(-chunks // s)
    assert (s - 1) * cps < chunks          # no empty range
    assert s * M * Cout * 4 <= conv.WORKSPACE_BYTES
