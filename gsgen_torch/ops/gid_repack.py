"""``padded_gid``: place the compact depth-sorted ids into the chunk-aligned
padded layout.

Padded slot ``s`` of tile ``t`` copies the contiguous compact rows
starting at ``s*K - offset_t`` (``offset_t = aligned_start - start_c``
is constant per tile); rows at or past the tile's segment end get the
sentinel id ``N``.

Kernel K4 (``csrc/gid_repack.cu``) replaces the JAX package's TPU kernel
``ops/gid_repack.py::_kernel``: one thread per padded row, one
coalesced int32 gather, no 8-row broadcast.  It is bound by bytes
(``cap_padded`` int32 read and written).  The plain version below is a
gather plus a ``where``.
"""

from __future__ import annotations

import torch

from . import cuda_lib


def repack_gid_plain(gid_s: torch.Tensor, chunk_tile: torch.Tensor,
                     offset_t: torch.Tensor, ends: torch.Tensor,
                     cap_padded: int, K: int, sentinel: int) -> torch.Tensor:
    cap = gid_s.shape[0]
    n_slots = cap_padded // K
    dev = gid_s.device
    gid_ext = torch.cat([gid_s, torch.full((K,), sentinel, dtype=torch.int32,
                                           device=dev)])
    slot = torch.arange(n_slots, dtype=torch.int32, device=dev)
    lane = torch.arange(K, dtype=torch.int32, device=dev)
    tile = chunk_tile.long()
    src0 = torch.clamp(slot * K - offset_t[tile], 0, cap - 1)
    src = (src0[:, None] + lane[None, :]).long()
    row = slot[:, None] * K + lane[None, :]
    valid = row < ends[tile][:, None]
    out = torch.where(valid, gid_ext[src],
                      torch.full_like(row, sentinel))
    return out.reshape(n_slots * K)


def repack_gid(gid_s: torch.Tensor, chunk_tile: torch.Tensor,
               offset_t: torch.Tensor, ends: torch.Tensor, cap_padded: int,
               K: int, sentinel: int) -> torch.Tensor:
    """[cap] sorted ids -> [cap_padded] chunk-aligned layout.

    gid_s: compact sorted ids; chunk_tile: owning tile per padded slot;
    offset_t: aligned_start - start_c per tile; ends: padded segment ends.
    CPU tensors take :func:`repack_gid_plain`; CUDA tensors launch K4.
    """
    if cap_padded % K != 0:
        raise ValueError(f"cap_padded {cap_padded} must be a multiple of "
                         f"the chunk {K}")
    if gid_s.device.type == "cpu":
        return repack_gid_plain(gid_s, chunk_tile, offset_t, ends,
                                cap_padded, K, sentinel)
    for t, name in ((gid_s, "gid_s"), (chunk_tile, "chunk_tile"),
                    (offset_t, "offset_t"), (ends, "ends")):
        cuda_lib.check(t, name, torch.int32, 1)
    if chunk_tile.shape[0] != cap_padded // K:
        raise ValueError("chunk_tile must hold one tile per padded slot")
    out = torch.empty(cap_padded, dtype=torch.int32, device=gid_s.device)
    cuda_lib.launch("gsgen_gid_repack", gid_s.data_ptr(), gid_s.shape[0],
                    chunk_tile.data_ptr(), offset_t.data_ptr(),
                    ends.data_ptr(), out.data_ptr(), cap_padded, K,
                    sentinel)
    repack_gid.launches += 1
    return out


repack_gid.launches = 0
