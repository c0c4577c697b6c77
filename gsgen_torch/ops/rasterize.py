"""Tile compositing in plain PyTorch — the CPU path and the kernels' oracle.

The per-pixel front-to-back recurrence ``T *= (1 - aG)`` is evaluated a
chunk of K depth-sorted duplicate rows at a time, for all live tiles at
once, with an exclusive ``cumprod`` along the chunk:

* ``G = exp(-0.5 max(radial, 0))``, ``aG = min(alpha, 0.99) G``, zeroed
  below 1/255 (reference vol_render.h:100-166 in gsgen3d/gsgen);
* ``T_run = T * cp_excl``; a lane counts while ``T_run >= T_thresh``
  ("check before, update after");
* ``T *= min(1, min over counted lanes of cp_excl * om)`` — the product
  through the last counted lane (the TPU kernel's ``_update_T``);
* a tile stops after the chunk that leaves every pixel below
  ``T_thresh``; the number of chunks it processed goes to the last
  output row, as in the TPU kernel.

Tile t walks ``counts[t]`` ``chunk``-aligned windows from
``floor(starts[t] / chunk) * chunk``, and lanes whose row lies outside
``[starts[t], ends[t])`` get ``aG = 0``, as the TPU kernel's
``lane_valid`` mask: in the compact layout a neighbouring tile's rows in
a shared boundary window, in the padded layout (chunk-aligned starts,
``counts`` the chunk counts) the sentinel rows past ``ends[t]``.

:func:`composite_tiles` works on the ``[16, cap]`` duplicate table of the
kernels and is differentiable under torch autograd: it is the plain
version of kernels K1 (padded) and K8 (compact), and its autograd is the
plain version of K2 and K9 (:mod:`.cuda_raster`).  A row of a window
shared by two tiles then receives the sum of both tiles' gradients, and
each tile contributes exactly zero on the lanes it masks.  Padding rows of
the table are the zero sentinel row (alpha 0) as well, so masking them
changes no value, and no lane reads an inactive slot's possibly
non-finite features.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .oracle import ALPHA_CLAMP, DEFAULT_T_THRESH, MIN_RENDER_ALPHA


def tile_pixels(tiles: torch.Tensor, geom: torch.Tensor, n_tiles_w: int,
                tile_size: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Camera-plane pixel positions [n, P, 1] of ``tiles`` (same rounding
    order as the kernels: topleft + float(global_pixel) * pixel_size)."""
    P = tile_size * tile_size
    pid = torch.arange(P, dtype=torch.int32, device=tiles.device)
    ty = tiles // n_tiles_w
    tx = tiles - ty * n_tiles_w
    px = (pid % tile_size)[None, :] + (tx * tile_size)[:, None]
    py = (pid // tile_size)[None, :] + (ty * tile_size)[:, None]
    pixx = geom[0] + px.to(torch.float32) * geom[2]
    pixy = geom[1] + py.to(torch.float32) * geom[3]
    return pixx[..., None], pixy[..., None]


def chunk_weights(d, pixx, pixy, T_col, T_thresh, lane_valid=None):
    """Shared chunk math.  d: [n, rows, K]; pixx/pixy/T_col: [n, P, 1];
    ``lane_valid`` [n, 1, K] zeroes aG outside a tile's rows.
    Returns (om, cp_excl, processed, w), all [n, P, K]."""
    mx, my = d[:, 0:1, :], d[:, 1:2, :]
    ca, cb, cc = d[:, 2:3, :], d[:, 3:4, :], d[:, 4:5, :]
    al = d[:, 5:6, :]
    dx = pixx - mx
    dy = pixy - my
    radial = ca * dx * dx + 2.0 * cb * dx * dy + cc * dy * dy
    G = torch.exp(-0.5 * torch.clamp(radial, min=0.0))
    aG = torch.clamp(al, max=ALPHA_CLAMP) * G
    aG = torch.where(aG < MIN_RENDER_ALPHA, torch.zeros_like(aG), aG)
    if lane_valid is not None:
        aG = torch.where(lane_valid, aG, torch.zeros_like(aG))
    om = 1.0 - aG
    cp = torch.cumprod(om, dim=2)
    cp_excl = torch.cat([torch.ones_like(cp[..., :1]), cp[..., :-1]], dim=2)
    T_run = T_col * cp_excl
    processed = T_run >= T_thresh
    w = torch.where(processed, aG * T_run, torch.zeros_like(aG))
    return om, cp_excl, processed, w


def update_T(T_col, om, cp_excl, processed):
    """T' = T * min(1, min over processed lanes of cp_excl * om)."""
    q = torch.where(processed, cp_excl * om,
                    torch.full_like(om, float("inf")))
    return T_col * torch.clamp(torch.amin(q, dim=2, keepdim=True), max=1.0)


def composite_tiles(dup: torch.Tensor, starts: torch.Tensor,
                    ends: torch.Tensor, counts: torch.Tensor,
                    geom: torch.Tensor, *, n_tiles_w: int, tile_size: int,
                    chunk: int, F: int, ch_out: int,
                    T_thresh: float = DEFAULT_T_THRESH) -> torch.Tensor:
    """[rows >= 6+F, cap] duplicate table -> out [n_tiles, ch_out, P]
    (F feature rows, T at row F, processed-chunk count at row ch_out-1).

    ``counts`` is each tile's chunk (padded) or window (compact) count."""
    dev = dup.device
    n_tiles = starts.shape[0]
    P = tile_size * tile_size
    K = chunk
    tiles = torch.arange(n_tiles, dtype=torch.int32, device=dev)
    pixx, pixy = tile_pixels(tiles, geom, n_tiles_w, tile_size)
    lanes = torch.arange(K, dtype=torch.int64, device=dev)
    T = torch.ones(n_tiles, P, 1, dtype=torch.float32, device=dev)
    acc = torch.zeros(n_tiles, F, P, dtype=torch.float32, device=dev)
    i_fin = torch.zeros(n_tiles, dtype=torch.int32, device=dev)
    table = dup[:6 + F]
    base = starts.long() // K * K
    alive = counts > 0
    i = 0
    while bool(alive.any()):
        idx = alive.nonzero()[:, 0]
        cols = base[idx][:, None] + i * K + lanes[None, :]
        d = table[:, cols].permute(1, 0, 2)              # [n_a, 6+F, K]
        valid = ((cols >= starts[idx].long()[:, None])
                 & (cols < ends[idx].long()[:, None]))[:, None, :]
        om, cp_excl, processed, w = chunk_weights(
            d, pixx[idx], pixy[idx], T[idx], T_thresh, valid)
        fe = d[:, 6:6 + F, :]
        acc = acc.index_copy(0, idx, acc[idx] + fe @ w.transpose(1, 2))
        T = T.index_copy(0, idx, update_T(T[idx], om, cp_excl, processed))
        i_fin = i_fin + alive.to(torch.int32)
        i += 1
        alive = (alive & (i < counts)
                 & (torch.amax(T, dim=(1, 2)) >= T_thresh))
    pad = torch.zeros(n_tiles, ch_out - F - 2, P, dtype=torch.float32,
                      device=dev)
    count = i_fin.to(torch.float32)[:, None, None].expand(n_tiles, 1, P)
    return torch.cat([acc, T.transpose(1, 2), pad, count], dim=1)


def unpack_tiles(out: torch.Tensor, F: int, w: int, h: int, tile_size: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """out [n_tiles, ch_out, P] -> (img [H, W, F], T [H, W])."""
    nw = -(-w // tile_size)
    nh = -(-h // tile_size)
    ts = tile_size
    img = out[:, :F, :].reshape(nh, nw, F, ts, ts).permute(0, 3, 1, 4, 2)
    img = img.reshape(nh * ts, nw * ts, F)[:h, :w]
    T = out[:, F, :].reshape(nh, nw, ts, ts).permute(0, 2, 1, 3)
    T = T.reshape(nh * ts, nw * ts)[:h, :w]
    return img, T


def make_geom(topleft, pixel_size, device) -> torch.Tensor:
    """[4] float32 (topleft x, y, pixel size x, y) on ``device``."""
    vals = [topleft[0], topleft[1], pixel_size[0], pixel_size[1]]
    return torch.stack([torch.as_tensor(v, dtype=torch.float32,
                                        device=device).reshape(())
                        for v in vals])


def ch_out_for(F: int) -> int:
    """Output rows: F features + T + count, 8 when F <= 6 else 16."""
    return 8 if F + 2 <= 8 else 16
