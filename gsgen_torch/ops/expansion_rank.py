"""Duplicate-expansion gid: for every duplicate slot ``d < cap``,

    gid[d] = #{g : cum[g] <= d}      (= searchsorted(cum, d, side='right'))

where ``cum`` is the inclusive cumsum of per-Gaussian duplicate counts
(non-decreasing, non-negative).  It is the vectorized repeat-interleave
of Gaussian ids that the binner sorts.

Kernel K3 (``csrc/expansion_rank.cu``) replaces the JAX package's TPU kernel
``ops/expansion_rank.py::_kernel``.  It merges the ``cum`` values with the
slots (merge path): each block takes an equal share of the ``N + cap``
merged items, finds its start by one search over ``cum`` that the whole
block runs together, and merges its share out of shared memory; blocks
past ``cum[N-1]`` only store ``N``.  Its yardstick is the byte bound
(``N`` int32 read, ``cap`` int32 written), but what holds it on the H100
is latency: the head blocks' two dependent trips to L2 and their barriers
(``csrc/expansion_rank.cu``).  No window can overflow, so it needs no
fallback branch, unlike the TPU's block merge.  The plain version is the
scatter + cumsum form the TPU kernel must equal.
"""

from __future__ import annotations

import torch

from . import cuda_lib


def expansion_gid_plain(cum: torch.Tensor, cap: int) -> torch.Tensor:
    """``cumsum(zeros(cap).at[cum].add(1, mode='drop'))``: marks outside
    ``[0, cap)`` are dropped."""
    keep = (cum >= 0) & (cum < cap)
    marks = torch.bincount(cum[keep].long(), minlength=cap)
    return torch.cumsum(marks, 0, dtype=torch.int32)


def expansion_gid(cum: torch.Tensor, cap: int) -> torch.Tensor:
    """[N] int32 inclusive count cumsum -> [cap] int32 Gaussian ids.

    CPU tensors take :func:`expansion_gid_plain`; CUDA tensors launch K3.
    """
    if cum.device.type == "cpu":
        return expansion_gid_plain(cum, cap)
    cuda_lib.check(cum, "cum", torch.int32, 1)
    gid = torch.empty(cap, dtype=torch.int32, device=cum.device)
    cuda_lib.launch("gsgen_expansion_rank", cum.data_ptr(), cum.shape[0],
                    gid.data_ptr(), cap)
    expansion_gid.launches += 1
    return gid


expansion_gid.launches = 0
