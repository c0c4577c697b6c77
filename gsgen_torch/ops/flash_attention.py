"""Self-attention core of the UNet through the hand-written kernels K5-K7.

Counterpart of the JAX package's ``guidance/unet2d.py::_flash_self_attention``
(the library Pallas TPU ``flash_attention`` and, when VSD differentiates
the UNet, its VJP).  Every function here takes and returns the JAX
function's layout, q, k, v, out and their gradients ``[B, L, H, D]``;
``lse`` and ``delta`` are ``[B, H, L]`` fp32.

* :func:`flash_self_attention` is the entry point: the forward K5
  (``csrc/flash_attn_fwd.cu``) and, when an input requires grad, a
  ``torch.autograd.Function`` whose forward also saves K5's log-sum-exp and
  whose backward runs K6 (dK, dV) and K7 (dQ) from
  ``csrc/flash_attn_bwd.cu``.  Its output is never detached from inputs
  that require grad.
* Each kernel wrapper (:func:`flash_self_attention_lse`,
  :func:`flash_bwd_dkv`, :func:`flash_bwd_dq`) launches its kernel on CUDA
  tensors, counting the launch, and raises on shapes or types the kernel
  does not take; on CPU tensors it runs its plain version.  K5 in bf16
  is one wgmma + TMA kernel for every D, built at the P V widths of
  :data:`BF16_WIDTHS`; in fp32 (3xTF32) K5 is, for D <= 64, a split pass
  (K's and V^T's hi and lo planes, into scratch allocated here) and a
  wgmma + TMA kernel built at the P V widths of :data:`FP32_WIDTHS`, and
  an mma.sync kernel for D = 72-160.  :func:`fwd_tiles` picks the instance
  (keys a tile, width), which the C entry checks.  K6 and K7 run wgmma +
  TMA in bf16 at every D: up to 64 one instance of 128 rows a CTA, above
  it instances of 64 rows at the widths of :data:`BF16_BWD_WIDTHS`, whose
  two consumer warpgroups split the work (one forms the scores and P and
  hands P to the other in fp32; each holds at most one gradient
  accumulator); in fp32 (3xTF32) wgmma + TMA up to D = 64 and mma.sync
  above.  :func:`bwd_tiles` picks the instance (rows a CTA, width), which
  the C entries check.  There is no
  fallback: a CUDA tensor launches its kernel or raises.
* The plain versions: :func:`flash_self_attention_plain` is the einsum
  path of the JAX ``Attention`` (``unet2d.py:199-203``: fp32 scores and
  softmax, the normalised weights cast to v's type, the second einsum);
  :func:`flash_self_attention_plain_lse` adds the log-sum-exp;
  :func:`flash_bwd_dkv_plain` and :func:`flash_bwd_dq_plain` (together
  :func:`flash_self_attention_bwd_plain`) apply the backward's explicit
  formulas in fp32.  K5 keeps the softmax unnormalised in fp32 and divides
  once at the end (exact online softmax), where the plain path rounds the
  normalised weights to v's type first; the two agree to the rounding of
  that type.
"""

from __future__ import annotations

import torch

from . import cuda_lib

MAX_D = 160
BLOCK_L = 128   # the wgmma kernels' tile; the JAX eligibility gate's too
_DTYPES = {torch.bfloat16: 1, torch.float32: 0}
# P V widths K5's bf16 instance is built for (csrc/flash_attn_fwd.cu): the
# head widths of SD 1.5 and SD 2.1
BF16_WIDTHS = (40, 64, 80, 160)
# P V widths of K5's fp32 wgmma instance (64 keys a tile): IF-II's D = 16
# and 32, SD 2.1's 64; D = 72-160 run the mma.sync instance (32 keys)
FP32_WIDTHS = (16, 32, 64)
FP32_KEY_TILE = 64
FP32_WIDE_KEY_TILE = 32
# widths of K6's and K7's bf16 instances above D = 64 (64 rows a CTA): SD
# 1.5's D = 80 and 160 (bwd_tiles)
BF16_BWD_WIDTHS = (80, 160)


def fwd_tiles(dtype: torch.dtype, D: int) -> tuple[int, int]:
    """K5's instance for this type and head width: (keys a tile, the P V
    width it is built for).  D rounds up to the next built width, TMA
    zero-filling the head dims past D.  bf16: the next of
    :data:`BF16_WIDTHS`, 128 keys a tile up to width 80 and 64 above (a
    128-key tile's scores beside the wider accumulators would spill);
    fp32: the next of :data:`FP32_WIDTHS` at 64 keys a tile, or the
    mma.sync instance (32 keys, width 160) above 64."""
    if dtype == torch.bfloat16:
        width = next(w for w in BF16_WIDTHS if w >= D)
        return (128 if width <= 80 else 64), width
    if D <= FP32_WIDTHS[-1]:
        return FP32_KEY_TILE, next(w for w in FP32_WIDTHS if w >= D)
    return FP32_WIDE_KEY_TILE, MAX_D


def bwd_tiles(dtype: torch.dtype, D: int) -> tuple[int, int]:
    """K6's and K7's instance for this type and head width: (the rows a
    CTA owns, keys in K6 and queries in K7; the width it is built for).
    bf16: (128, 64) up to D = 64 (the k-steps read at run time), else 64
    rows at the next of :data:`BF16_BWD_WIDTHS`, streaming tiles of 64
    (TMA zero-fills the head dims past D); fp32: (64, 64) up to D = 64
    (3xTF32 on wgmma), else the mma.sync instance (64, 160).  Raises past
    :data:`MAX_D`."""
    if not 0 < D <= MAX_D:
        raise ValueError(f"K6 / K7 take 0 < D <= {MAX_D}, got {D}")
    if D <= 64:
        return (128 if dtype == torch.bfloat16 else 64), 64
    if dtype == torch.bfloat16:
        return 64, next(w for w in BF16_BWD_WIDTHS if w >= D)
    return 64, MAX_D


def flash_self_attention_plain(q, k, v, scale: float) -> torch.Tensor:
    """softmax(q k^T * scale) v over [B, L, H, D], fp32 scores and softmax."""
    attn = torch.einsum("blhd,bshd->bhls", q.float(), k.float()) * scale
    attn = torch.softmax(attn, dim=-1).to(v.dtype)
    return torch.einsum("bhls,bshd->blhd", attn, v)


def flash_self_attention_plain_lse(q, k, v, scale: float):
    """(out, lse): the plain forward and the fp32 log-sum-exp of each
    query's scaled scores, [B, H, L]."""
    s = torch.einsum("blhd,bshd->bhls", q.float(), k.float()) * scale
    attn = torch.softmax(s, dim=-1).to(v.dtype)
    return (torch.einsum("bhls,bshd->blhd", attn, v),
            torch.logsumexp(s, dim=-1))


def attention_delta(out, dout) -> torch.Tensor:
    """Di = sum_d out * dout in fp32, [B, H, L] (the library's ``di``)."""
    d = torch.einsum("blhd,blhd->bhl", out.float(), dout.float())
    return d.contiguous()


def _probs(q, k, lse, scale: float):
    """P = exp(q k^T * scale - lse) in fp32, [B, H, L, L]."""
    s = torch.einsum("blhd,bshd->bhls", q.float(), k.float()) * scale
    return torch.exp(s - lse[..., None])


def _dscores(p, v, dout, delta):
    """dS = P * (dO V^T - Di) in fp32."""
    dp = torch.einsum("blhd,bshd->bhls", dout.float(), v.float())
    return p * (dp - delta[..., None])


def flash_bwd_dkv_plain(q, k, v, dout, lse, delta, scale: float):
    """K6's plain version: (dk, dv) in q's type, fp32 inside."""
    p = _probs(q, k, lse, scale)
    dv = torch.einsum("bhls,blhd->bshd", p, dout.float())
    dk = torch.einsum("bhls,blhd->bshd", _dscores(p, v, dout, delta),
                      q.float()) * scale
    return dk.to(q.dtype), dv.to(q.dtype)


def flash_bwd_dq_plain(q, k, v, dout, lse, delta, scale: float):
    """K7's plain version: dq in q's type, fp32 inside."""
    ds = _dscores(_probs(q, k, lse, scale), v, dout, delta)
    return (torch.einsum("bhls,bshd->blhd", ds, k.float()) * scale).to(
        q.dtype)


def flash_self_attention_bwd_plain(q, k, v, out, lse, dout, scale: float):
    """The backward's explicit formulas: P = exp(q k^T * scale - lse),
    dV = P^T dO, dP = dO V^T, Di = sum(O * dO), dS = P * (dP - Di),
    dQ = dS K * scale, dK = dS^T Q * scale.  Returns (dq, dk, dv)."""
    delta = attention_delta(out, dout)
    dk, dv = flash_bwd_dkv_plain(q, k, v, dout, lse, delta, scale)
    return flash_bwd_dq_plain(q, k, v, dout, lse, delta, scale), dk, dv


def supported(q: torch.Tensor) -> bool:
    """Whether K5-K7 take this shape and type."""
    _, L, _, D = q.shape
    return (q.dtype in _DTYPES and L % BLOCK_L == 0 and D % 8 == 0
            and 0 < D <= MAX_D)


def _check(q, named):
    """Validate kernel arguments: ``named`` maps names to tensors of q's
    shape and type; raises on what the kernels do not take."""
    for name, x in named.items():
        cuda_lib.check(x, name, q.dtype, 4)
        if x.shape != q.shape:
            raise ValueError(f"{name} must have q's shape {tuple(q.shape)}, "
                             f"got {tuple(x.shape)}")
        if x.data_ptr() % 16 != 0:
            raise ValueError(f"{name} must be 16-byte aligned")
    if not supported(q):
        raise ValueError(
            f"flash attention takes bf16/fp32 [B, L, H, D] with L % "
            f"{BLOCK_L} == 0 and D % 8 == 0, D <= {MAX_D}; got "
            f"{q.dtype} {tuple(q.shape)}")


def _check_rows(q, named):
    """``lse`` / ``delta``: fp32 [B, H, L], contiguous, on q's device."""
    B, L, H, _ = q.shape
    for name, x in named.items():
        cuda_lib.check(x, name, torch.float32, 3)
        if tuple(x.shape) != (B, H, L):
            raise ValueError(f"{name} must be [B, H, L] = {(B, H, L)}, got "
                             f"{tuple(x.shape)}")


def _launch_fwd(q, k, v, scale: float, with_lse: bool):
    _check(q, {"q": q, "k": k, "v": v})
    B, L, H, D = q.shape
    out = torch.empty_like(q)
    lse = (torch.empty(B, H, L, dtype=torch.float32, device=q.device)
           if with_lse else None)
    tiles = fwd_tiles(q.dtype, D)
    # the fp32 wgmma instance's split pass writes K's and V^T's hi and lo
    # planes here
    scratch = (torch.empty(4 * q.numel(), dtype=torch.float32,
                           device=q.device)
               if tiles[0] == FP32_KEY_TILE and q.dtype == torch.float32
               else None)
    cuda_lib.launch("gsgen_flash_attn_fwd", q.data_ptr(), k.data_ptr(),
                    v.data_ptr(), out.data_ptr(),
                    None if lse is None else lse.data_ptr(), B, L, H, D,
                    float(scale), _DTYPES[q.dtype], *tiles,
                    None if scratch is None else scratch.data_ptr())
    flash_self_attention.launches += 1
    return out, lse


def flash_self_attention_lse(q, k, v, scale: float):
    """K5 with its log-sum-exp output: (out [B, L, H, D], lse [B, H, L])."""
    if q.device.type == "cpu":
        return flash_self_attention_plain_lse(q, k, v, scale)
    return _launch_fwd(q, k, v, scale, True)


def flash_bwd_dkv(q, k, v, dout, lse, delta, scale: float):
    """K6: (dk, dv) in q's type from q, k, v, dout, lse and delta."""
    if q.device.type == "cpu":
        return flash_bwd_dkv_plain(q, k, v, dout, lse, delta, scale)
    _check(q, {"q": q, "k": k, "v": v, "dout": dout})
    _check_rows(q, {"lse": lse, "delta": delta})
    B, L, H, D = q.shape
    dk, dv = torch.empty_like(q), torch.empty_like(q)
    cuda_lib.launch("gsgen_flash_attn_bwd_dkv", q.data_ptr(), k.data_ptr(),
                    v.data_ptr(), dout.data_ptr(), lse.data_ptr(),
                    delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), B, L, H,
                    D, float(scale), _DTYPES[q.dtype], *bwd_tiles(q.dtype, D))
    flash_bwd_dkv.launches += 1
    return dk, dv


def flash_bwd_dq(q, k, v, dout, lse, delta, scale: float):
    """K7: dq in q's type from q, k, v, dout, lse and delta."""
    if q.device.type == "cpu":
        return flash_bwd_dq_plain(q, k, v, dout, lse, delta, scale)
    _check(q, {"q": q, "k": k, "v": v, "dout": dout})
    _check_rows(q, {"lse": lse, "delta": delta})
    B, L, H, D = q.shape
    dq = torch.empty_like(q)
    cuda_lib.launch("gsgen_flash_attn_bwd_dq", q.data_ptr(), k.data_ptr(),
                    v.data_ptr(), dout.data_ptr(), lse.data_ptr(),
                    delta.data_ptr(), dq.data_ptr(), B, L, H, D,
                    float(scale), _DTYPES[q.dtype], *bwd_tiles(q.dtype, D))
    flash_bwd_dq.launches += 1
    return dq


class _FlashAttention(torch.autograd.Function):
    """K5 forward saving lse; K6 + K7 backward (``flash_attention.py:
    254-316`` of the library: dkv, then dq, from the same Di)."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        out, lse = flash_self_attention_lse(q, k, v, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dout = dout.contiguous()
        delta = attention_delta(out, dout)
        dk, dv = flash_bwd_dkv(q, k, v, dout, lse, delta, ctx.scale)
        dq = flash_bwd_dq(q, k, v, dout, lse, delta, ctx.scale)
        return dq, dk, dv, None


def flash_self_attention(q, k, v, scale: float) -> torch.Tensor:
    """softmax(q k^T * scale) v: q, k, v [B, L, H, D] -> out in q's type.
    Differentiable: when grad mode is on and an input requires grad, the
    forward saves lse and the backward runs K6 and K7."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _FlashAttention.apply(q, k, v, scale)
    if q.device.type == "cpu":
        return flash_self_attention_plain(q, k, v, scale)
    return _launch_fwd(q, k, v, scale, False)[0]


flash_self_attention.launches = 0
flash_bwd_dkv.launches = 0
flash_bwd_dq.launches = 0
