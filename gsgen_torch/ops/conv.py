"""The fp32 UNet's convolutions through the hand-written 3xTF32 kernel.

No kernel of the JAX package stands behind this one: there XLA computes
the UNet's convolutions (``guidance/unet2d.py``'s ``nn.Conv``), and the
port ran them on cuDNN, whose IEEE fp32 kernels use the CUDA cores (the
port keeps TF32 off, ``utils/precision.py``).  ``csrc/conv_3xtf32.cu`` is
an implicit-GEMM convolution on the tensor cores in 3xTF32 (each product
lo_a hi_b + hi_a lo_b + hi_a hi_b, about 2^-21 relative), NCHW in and out
as ``nn.Conv2d``.

* :func:`supported` inspects a call: the kernel takes fp32 CUDA NCHW
  input, a 1x1 or 3x3 kernel, equal strides and paddings, no dilation or
  groups, Cin R R a multiple of 4 and Cout a multiple of 8.  The callers
  (``guidance/unet2d.py::Conv2d``) route by it; nothing tries the kernel
  and falls back.
* :func:`conv2d_3xtf32` launches the kernel on CUDA tensors, counting the
  launch, and raises on a call :func:`supported` refuses; on CPU tensors
  it runs :func:`conv2d_plain`, ``F.conv2d`` in fp32.
* :func:`split_k` picks how many ranges of K the kernel splits into, from
  the tiles the call makes and the card's SMs: the 8^2 and 16^2 levels
  would fill a quarter of the card or less.  The partial sums go to
  scratch (at most :data:`WORKSPACE_BYTES`) that a second kernel adds in
  a fixed order.
* :func:`conv2d` is the entry: a ``torch.autograd.Function`` that saves
  the input and the weight (what ``nn.Conv2d`` saves) and whose backward
  is cuDNN's (``aten.convolution_backward``), as before.
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch.nn.modules.utils import _pair

from . import cuda_lib

BM = 128            # output pixels a CTA
BN = 160            # output channels a CTA
BK = 32             # k a chunk
KERNEL_SIZES = (1, 3)
MAX_SPLITS = 16
MIN_SPLIT_CHUNKS = 8  # chunks of K a split walks at least
WORKSPACE_BYTES = 64 << 20
_INT_MAX = 2 ** 31 - 1


def out_size(size: int, k: int, stride: int, pad: int) -> int:
    return (size + 2 * pad - k) // stride + 1


def supported(x: torch.Tensor, weight: torch.Tensor,
              bias: Optional[torch.Tensor], stride, padding,
              dilation=1, groups: int = 1) -> bool:
    """Whether the kernel takes ``F.conv2d(x, weight, bias, stride,
    padding, dilation, groups)``."""
    if not (x.is_cuda and x.dtype == torch.float32 and x.dim() == 4
            and weight.dtype == torch.float32 and weight.dim() == 4
            and weight.device == x.device and groups == 1
            and not isinstance(padding, str)
            and (bias is None or bias.dtype == torch.float32)):
        return False
    (sh, sw), (ph, pw), dil = _pair(stride), _pair(padding), _pair(dilation)
    Cout, Cin, R, S = weight.shape
    N, C, H, W = x.shape
    if not (R == S and R in KERNEL_SIZES and sh == sw >= 1 and ph == pw >= 0
            and dil == (1, 1) and C == Cin and (Cin * R * R) % 4 == 0
            and Cout % 8 == 0 and N > 0):
        return False
    Ho, Wo = out_size(H, R, sh, ph), out_size(W, R, sh, ph)
    return (Ho > 0 and Wo > 0 and x.numel() < _INT_MAX
            and N * Cout * Ho * Wo < _INT_MAX)


def split_k(M: int, Cout: int, K: int, sms: int) -> int:
    """How many ranges of whole chunks K splits into: the count whose
    waves of CTAs (tiles x splits over ``sms``, one CTA an SM) take the
    least time a split, each split at least :data:`MIN_SPLIT_CHUNKS`
    chunks and none empty, the partial sums within
    :data:`WORKSPACE_BYTES`; a split is taken only for a tenth less
    time."""
    tiles = math.ceil(M / BM) * math.ceil(Cout / BN)
    chunks = math.ceil(K / BK)
    best, best_cost = 1, float(math.ceil(tiles / sms))
    for s in range(2, MAX_SPLITS + 1):
        cps = math.ceil(chunks / s)
        if cps < MIN_SPLIT_CHUNKS or s * M * Cout * 4 > WORKSPACE_BYTES:
            break
        if (s - 1) * cps >= chunks:
            continue
        cost = math.ceil(tiles * s / sms) / s
        if cost < 0.9 * best_cost:
            best, best_cost = s, cost
    return best


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def conv2d_plain(x, weight, bias=None, stride=1, padding=0) -> torch.Tensor:
    """The plain version: ``F.conv2d`` in the inputs' type."""
    return F.conv2d(x, weight, bias, _pair(stride), _pair(padding))


def conv2d_3xtf32(x, weight, bias=None, stride=1, padding=0
                  ) -> torch.Tensor:
    """conv2d(x, weight) + bias, [N, Cin, H, W] -> [N, Cout, Ho, Wo], on
    the kernel for CUDA tensors (raises on what :func:`supported`
    refuses), :func:`conv2d_plain` for CPU ones."""
    if x.device.type == "cpu":
        return conv2d_plain(x, weight, bias, stride, padding)
    (s, _), (p, _) = _pair(stride), _pair(padding)
    if not supported(x, weight, bias, stride, padding):
        raise ValueError(
            f"the 3xTF32 convolution takes fp32 CUDA NCHW input, 1x1 or "
            f"3x3 kernels, equal strides and paddings, Cin R R % 4 == 0 and "
            f"Cout % 8 == 0; got x {x.dtype} {tuple(x.shape)} on "
            f"{x.device}, weight {weight.dtype} {tuple(weight.shape)}, "
            f"stride {stride}, padding {padding}")
    x, weight = x.contiguous(), weight.contiguous()
    if weight.data_ptr() % 16:
        # the weight's TMA map needs a 16-byte aligned address (x and the
        # bias are read a float at a time); a fresh copy has one
        weight = weight.clone()
    if bias is not None:
        bias = bias.contiguous()
    N, Cin, H, W = x.shape
    Cout, _, R, _ = weight.shape
    Ho, Wo = out_size(H, R, s, p), out_size(W, R, s, p)
    out = torch.empty(N, Cout, Ho, Wo, dtype=x.dtype, device=x.device)
    splits = split_k(N * Ho * Wo, Cout, Cin * R * R, _sms(x.device.index))
    ws = (torch.empty(splits * out.numel(), dtype=x.dtype, device=x.device)
          if splits > 1 else None)
    cuda_lib.launch("gsgen_conv2d_3xtf32", x.data_ptr(), weight.data_ptr(),
                    None if bias is None else bias.data_ptr(),
                    out.data_ptr(), None if ws is None else ws.data_ptr(),
                    N, Cin, H, W, Cout, R, s, p, splits)
    conv2d_3xtf32.launches += 1
    return out


class _Conv2d3xTF32(torch.autograd.Function):
    """The kernel forward; cuDNN's IEEE fp32 backward from the input and
    the weight, for the inputs that need a gradient."""

    @staticmethod
    def forward(ctx, x, weight, bias, stride, padding):
        ctx.save_for_backward(x, weight)
        ctx.conv = (_pair(stride), _pair(padding), bias is not None)
        return conv2d_3xtf32(x, weight, bias, stride, padding)

    @staticmethod
    def backward(ctx, grad):
        x, weight = ctx.saved_tensors
        stride, padding, has_bias = ctx.conv
        need = ctx.needs_input_grad
        gx, gw, gb = torch.ops.aten.convolution_backward(
            grad, x, weight, [weight.shape[0]] if has_bias else None,
            list(stride), list(padding), [1, 1], False, [0, 0], 1,
            [need[0], need[1], has_bias and need[2]])
        return gx, gw, gb, None, None


def conv2d(x, weight, bias=None, stride=1, padding=0) -> torch.Tensor:
    """conv2d(x, weight) + bias through the kernel, differentiable (under
    ``no_grad``, or with no input that requires grad, ``apply`` records
    no graph and keeps nothing saved)."""
    return _Conv2d3xTF32.apply(x, weight, bias, stride, padding)


conv2d_3xtf32.launches = 0
