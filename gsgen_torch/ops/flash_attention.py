"""Self-attention core of the UNet through the hand-written kernel K5.

Counterpart of the JAX package's ``guidance/unet2d.py::_flash_self_attention``
(the library Pallas TPU ``flash_attention``, forward only: SDS never
differentiates through the UNet).  Both functions here take and return
the JAX function's layout, q, k, v and out ``[B, L, H, D]``:

* :func:`flash_self_attention_plain` is the einsum path of the JAX
  ``Attention`` (``unet2d.py:199-203``): scores in fp32, an fp32 softmax,
  the normalised weights cast to v's type, then the second einsum.  It is
  the CPU path and K5's oracle.
* :func:`flash_self_attention` launches K5 (``csrc/flash_attn_fwd.cu``) on
  CUDA tensors and raises on shapes or types it does not take.  K5 keeps
  the softmax unnormalised in fp32 and divides once at the end (exact
  online softmax), where the plain path rounds the normalised weights to
  v's type first; the two agree to the rounding of that type.
"""

from __future__ import annotations

import torch

from . import cuda_lib

MAX_D = 160
BLOCK_L = 64
_DTYPES = {torch.bfloat16: 1, torch.float32: 0}


def flash_self_attention_plain(q, k, v, scale: float) -> torch.Tensor:
    """softmax(q k^T * scale) v over [B, L, H, D], fp32 scores and softmax."""
    attn = torch.einsum("blhd,bshd->bhls", q.float(), k.float()) * scale
    attn = torch.softmax(attn, dim=-1).to(v.dtype)
    return torch.einsum("bhls,bshd->blhd", attn, v)


def supported(q: torch.Tensor) -> bool:
    """Whether K5 takes this shape and type."""
    _, L, _, D = q.shape
    return (q.dtype in _DTYPES and L % BLOCK_L == 0 and D % 8 == 0
            and 0 < D <= MAX_D)


def flash_self_attention(q, k, v, scale: float) -> torch.Tensor:
    """K5: q, k, v [B, L, H, D] -> out [B, L, H, D] in q's type."""
    if q.device.type == "cpu":
        return flash_self_attention_plain(q, k, v, scale)
    for name, x in (("q", q), ("k", k), ("v", v)):
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
    B, L, H, D = q.shape
    out = torch.empty_like(q)
    cuda_lib.launch("gsgen_flash_attn_fwd", q.data_ptr(), k.data_ptr(),
                    v.data_ptr(), out.data_ptr(), B, L, H, D, float(scale),
                    _DTYPES[q.dtype])
    flash_self_attention.launches += 1
    return out


flash_self_attention.launches = 0
