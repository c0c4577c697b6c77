"""Tile compositing through the hand-written CUDA kernels K1 and K2.

Counterpart of the JAX package's ``ops/pallas_raster.py`` (padded layout).  One
``torch.autograd.Function`` carries the contract of
``rasterize_tiles_pallas``: its forward is kernel K1 (``raster_fwd``,
``csrc/raster_fwd.cu``, replacing ``_fwd_kernel``), its backward kernel
K2 (``raster_bwd``, ``csrc/raster_bwd.cu``, replacing both
``_bwd_kernel_v2`` and ``_bwd_kernel``).  Kernel layouts are kept:

  dup  [16, cap]             rows: mx my ca cb cc alpha f0..f9
  out  [n_tiles, ch_out, P]  F features, T, processed-chunk count
  grad [16, cap]             same rows as dup

Design decisions against the TPU kernels:

* both kernels composite each pixel by the exact sequential scan;
  ``fast_fwd_cumprod`` and ``mxu_scans`` (matrix-unit approximations of
  the cumprod/cumsum) are accepted and ignored;
* one backward kernel serves both TPU call conditions: the resident
  budget that picks between them is a VMEM limit with no Hopper meaning;
* per-Gaussian gradients aggregate through the duplicate gather's own
  backward, an accumulating index add (``index_select``'s gradient),
  instead of the sort + cumsum aggregation (``_pack_seg_bwd``) that
  works around the TPU's serial scatter.

Each wrapper takes its plain version (:mod:`.rasterize`) only for CPU
tensors; for CUDA tensors it launches its kernel or raises.
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import cuda_lib
from .binning import BinnedTiles
from .oracle import DEFAULT_T_THRESH
from .rasterize import ch_out_for, composite_tiles, make_geom, unpack_tiles

D_ROWS = 16
MAX_F = D_ROWS - 6
_SMEM_LIMIT = 48 * 1024     # default dynamic shared memory per block


def pack_dup(mean2d, conic, alpha, feats, gid, valid) -> torch.Tensor:
    """Gather per-duplicate rows into the [16, cap] kernel layout.

    One [N + 8, 16] table (the 8 zero rows are the sentinel block: padding
    slots carry id N and gather zeros, alpha 0 = no contribution) and one
    row gather.  Differentiable: the gather's backward is an accumulating
    index add onto the table rows.
    """
    F = feats.shape[-1]
    if F > MAX_F:
        raise ValueError(f"at most {MAX_F} feature channels, got {F}")
    n = mean2d.shape[0]
    dev = mean2d.device
    table = torch.cat([mean2d, conic, alpha[:, None], feats,
                       torch.zeros(n, D_ROWS - 6 - F, device=dev)], dim=1)
    table = torch.cat([table, torch.zeros(8, D_ROWS, device=dev)], dim=0)
    gid = torch.where(valid, torch.clamp(gid, max=n),
                      torch.full_like(gid, n))
    return table.index_select(0, gid.long()).T.contiguous()


def raster_fwd_plain(dup, starts, nchunks, geom, *, n_tiles_w, tile_size,
                     chunk, F, ch_out, T_thresh):
    """Plain version of K1 (no autograd)."""
    with torch.no_grad():
        return composite_tiles(dup, starts, nchunks, geom,
                               n_tiles_w=n_tiles_w, tile_size=tile_size,
                               chunk=chunk, F=F, ch_out=ch_out,
                               T_thresh=T_thresh)


def raster_bwd_plain(dup, out, g, starts, nchunks, geom, *, n_tiles_w,
                     tile_size, chunk, F, ch_out, T_thresh):
    """Plain version of K2: autograd of the plain forward, recomputed.
    (``out`` is unused: the recomputation reproduces it.)"""
    with torch.enable_grad():
        d = dup.detach().requires_grad_(True)
        o = composite_tiles(d, starts, nchunks, geom, n_tiles_w=n_tiles_w,
                            tile_size=tile_size, chunk=chunk, F=F,
                            ch_out=ch_out, T_thresh=T_thresh)
        (grad,) = torch.autograd.grad(o, d, g, allow_unused=True)
    return torch.zeros_like(dup) if grad is None else grad


def _check_launch(dup, starts, nchunks, geom, tile_size, chunk, F, ch_out):
    cuda_lib.check(dup, "dup", torch.float32, 2)
    cuda_lib.check(starts, "starts", torch.int32, 1)
    cuda_lib.check(nchunks, "nchunks", torch.int32, 1)
    cuda_lib.check(geom, "geom", torch.float32, 1)
    P = tile_size * tile_size
    if dup.shape[0] != D_ROWS or dup.shape[1] % chunk != 0:
        raise ValueError(f"dup must be [16, k*{chunk}], got "
                         f"{tuple(dup.shape)}")
    if P % 32 != 0 or P > 1024:
        raise ValueError(f"tile_size {tile_size}: P must be a multiple of "
                         "32 and at most 1024")
    if F > MAX_F or ch_out != ch_out_for(F):
        raise ValueError(f"F={F}, ch_out={ch_out} unsupported")
    if 4 * (6 + F) * (chunk + P) > _SMEM_LIMIT:
        raise ValueError(f"chunk {chunk} needs more shared memory than a "
                         "block has by default")


def raster_fwd(dup, starts, nchunks, geom, *, n_tiles_w, tile_size, chunk,
               F, ch_out, T_thresh):
    """K1: dup [16, cap] -> out [n_tiles, ch_out, P]."""
    kw = dict(n_tiles_w=n_tiles_w, tile_size=tile_size, chunk=chunk, F=F,
              ch_out=ch_out, T_thresh=T_thresh)
    if dup.device.type == "cpu":
        return raster_fwd_plain(dup, starts, nchunks, geom, **kw)
    _check_launch(dup, starts, nchunks, geom, tile_size, chunk, F, ch_out)
    n_tiles = starts.shape[0]
    P = tile_size * tile_size
    out = torch.empty(n_tiles, ch_out, P, dtype=torch.float32,
                      device=dup.device)
    cuda_lib.launch("gsgen_raster_fwd", dup.data_ptr(), dup.shape[1],
                    starts.data_ptr(), nchunks.data_ptr(),
                    geom.data_ptr(), out.data_ptr(), n_tiles,
                    n_tiles_w, tile_size, chunk, F, ch_out, float(T_thresh))
    raster_fwd.launches += 1
    return out


def raster_bwd(dup, out, g, starts, nchunks, geom, *, n_tiles_w, tile_size,
               chunk, F, ch_out, T_thresh):
    """K2: (dup, forward out, its cotangent g) -> grad [16, cap]."""
    kw = dict(n_tiles_w=n_tiles_w, tile_size=tile_size, chunk=chunk, F=F,
              ch_out=ch_out, T_thresh=T_thresh)
    if dup.device.type == "cpu":
        return raster_bwd_plain(dup, out, g, starts, nchunks, geom, **kw)
    _check_launch(dup, starts, nchunks, geom, tile_size, chunk, F, ch_out)
    cuda_lib.check(out, "out", torch.float32, 3)
    cuda_lib.check(g, "g", torch.float32, 3)
    if g.shape != out.shape:
        raise ValueError("g must have the shape of out")
    # chunks the forward skipped and slots no tile owns stay exactly zero
    grad = torch.zeros_like(dup)
    cuda_lib.launch("gsgen_raster_bwd", dup.data_ptr(), dup.shape[1],
                    out.data_ptr(), g.data_ptr(), starts.data_ptr(),
                    nchunks.data_ptr(), geom.data_ptr(),
                    grad.data_ptr(), starts.shape[0], n_tiles_w,
                    tile_size, chunk, F, ch_out, float(T_thresh))
    raster_bwd.launches += 1
    return grad


raster_fwd.launches = 0
raster_bwd.launches = 0


class RasterCore(torch.autograd.Function):
    """dup -> out through K1; the gradient through K2."""

    @staticmethod
    def forward(ctx, dup, starts, nchunks, geom, statics):
        out = raster_fwd(dup, starts, nchunks, geom, **statics)
        ctx.save_for_backward(dup, starts, nchunks, geom, out)
        ctx.statics = statics
        return out

    @staticmethod
    def backward(ctx, g):
        dup, starts, nchunks, geom, out = ctx.saved_tensors
        dgrad = raster_bwd(dup, out, g.contiguous(), starts, nchunks, geom,
                           **ctx.statics)
        return dgrad, None, None, None, None


def rasterize_tiles_cuda(mean2d, conic, alpha, feats, bins: BinnedTiles,
                         topleft, pixel_size, *, w: int, h: int,
                         tile_size: int, chunk: int,
                         T_thresh: float = DEFAULT_T_THRESH,
                         mxu_scans: bool = False,
                         fast_fwd_cumprod: bool = False
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Counterpart of ``rasterize_tiles_pallas`` (padded layout).  Returns
    (img [H, W, F], T [H, W]).  ``mxu_scans`` / ``fast_fwd_cumprod`` are
    accepted and ignored: the kernels run the exact scans."""
    del mxu_scans, fast_fwd_cumprod
    F = feats.shape[-1]
    cap = bins.padded_gid.shape[0]
    if cap % chunk != 0:
        raise ValueError("binner capacity must be chunk-aligned")
    dup = pack_dup(mean2d, conic, alpha, feats, bins.padded_gid,
                   bins.row_valid)
    nchunks = ((bins.ends - bins.starts + chunk - 1) // chunk).to(
        torch.int32)
    statics = dict(n_tiles_w=-(-w // tile_size), tile_size=tile_size,
                   chunk=chunk, F=F, ch_out=ch_out_for(F),
                   T_thresh=float(T_thresh))
    geom = make_geom(topleft, pixel_size, mean2d.device)
    out = RasterCore.apply(dup, bins.starts.contiguous(), nchunks, geom,
                           statics)
    return unpack_tiles(out, F, w, h, tile_size)
