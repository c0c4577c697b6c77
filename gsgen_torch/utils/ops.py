"""Point-set ops: brute-force KNN, farthest point sampling, normal
estimation and the Gaussian surface distance.

Port of the JAX package's ``utils/ops.py`` (``pairwise_sqdist``, ``knn``,
``knn_self``, ``mean_knn_sqdist``, ``farthest_point_sampling``, ``estimate_pointcloud_normals``,
``distance_to_gaussian_surface``), what the compactness densify, the
penalties, the normals and the Point-E auxiliary guidance need.  Three
differences of form, none of result:

* ``knn`` works in row blocks, so ``knn_self`` over a full capacity
  (65,536 in ``configs/base.yaml``) never holds the [M, M] distance
  matrix (16 GiB in fp32) at once; rows are independent, so the answer
  is the same.  The search runs without autograd and the picked pairs'
  distances are recomputed, so a penalty's backward keeps [N, k];
* ties: ``jax.lax.top_k`` returns the lower index first among equal
  values, which ``torch.topk`` does not promise.  A clone sits exactly on
  its source, so that order decides which column ``knn_self`` drops as
  "self".  The port ranks each row by one int64 key, the distance's
  float bits (order-preserving for non-negative floats) above the column
  index, so equal distances come out by ascending index;
* the normals' batched 3x3 ``eigh`` runs in batches of
  :data:`EIGH_BATCH` matrices (:func:`eigh_batched`).

``a·bᵀ`` is summed per coordinate (no matrix product), so no TF32 setting
reaches it and the same rows give bitwise the same distances.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..ops.transforms import quat_to_rotmat

KNN_ROWS = 1024     # query rows per block
# cuSOLVER's batched symmetric eigensolver, as torch 2.11 + CUDA 12.8 call
# it on the H100, rejects batches of 32,768 or more 3x3 matrices
# (CUSOLVER_STATUS_INVALID_VALUE from cusolverDnXsyevBatched_bufferSize);
# 16,384 run
EIGH_BATCH = 16384


def pairwise_sqdist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[N, D], [M, D] -> squared euclidean distances [N, M] by the
    |a|^2 - 2ab + |b|^2 expansion, clamped at 0."""
    a2 = torch.sum(a * a, dim=-1, keepdim=True)
    b2 = torch.sum(b * b, dim=-1)
    ab = a[:, 0:1] * b[None, :, 0]
    for j in range(1, a.shape[1]):
        ab = ab + a[:, j:j + 1] * b[None, :, j]
    # + 0.0 turns a -0.0 into +0.0, whose bits the keys below need
    return torch.clamp(a2 - 2.0 * ab + b2[None, :], min=0.0) + 0.0


def knn(query: torch.Tensor, points: torch.Tensor, k: int,
        mask: Optional[torch.Tensor] = None
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """k nearest neighbours of each query point: (sqdists [N, k], idx
    [N, k] int32), ascending, lower index first among equal distances;
    ``mask`` excludes points (distance +inf).

    The search runs without autograd; the distances of the picked pairs
    are then recomputed by the same elementwise steps as
    :func:`pairwise_sqdist` (so bitwise the same values), which keeps the
    autograd graph at [N, k] instead of [N, M]."""
    m = points.shape[0]
    col = torch.arange(m, dtype=torch.int64, device=points.device)
    idxs = []
    with torch.no_grad():
        for r0 in range(0, query.shape[0], KNN_ROWS):
            d = pairwise_sqdist(query[r0:r0 + KNN_ROWS], points)
            if mask is not None:
                d = torch.where(mask[None, :], d,
                                torch.full_like(d, float("inf")))
            key = (d.view(torch.int32).to(torch.int64) << 32) | col[None, :]
            top = torch.topk(key, k, dim=1, largest=False, sorted=True).values
            idxs.append(top & 0xFFFFFFFF)
    idx = torch.cat(idxs)
    nbr = points[idx]                                   # [N, k, D]
    a2 = torch.sum(query * query, dim=-1, keepdim=True)
    b2 = torch.sum(points * points, dim=-1)[idx]
    ab = query[:, None, 0] * nbr[..., 0]
    for j in range(1, query.shape[1]):
        ab = ab + query[:, None, j] * nbr[..., j]
    d = torch.clamp(a2 - 2.0 * ab + b2, min=0.0) + 0.0
    if mask is not None:
        d = torch.where(mask[idx], d, torch.full_like(d, float("inf")))
    return d, idx.to(torch.int32)


def knn_self(points: torch.Tensor, k: int,
             mask: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """KNN without the first match (the point itself, or its tie)."""
    d, i = knn(points, points, k + 1, mask)
    return d[:, 1:], i[:, 1:]


def mean_knn_sqdist(points: torch.Tensor, k: int = 3,
                    mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean squared distance to the ``k`` nearest neighbours [N] (the
    reference's ``cov_init``, gs/initialize.py:5-22, which feeds faiss's
    squared distances in as scales)."""
    d, _ = knn_self(points, k, mask)
    return torch.mean(d, dim=-1)


def farthest_point_sampling(points: torch.Tensor, n_samples: int,
                            mask: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
    """Indices [n_samples] (int32) of a farthest-point subset of ``points``
    [N, 3]: the start is index 0, or the first row of ``mask`` that is
    set; masked-out rows get -inf and are never picked.  Each step takes
    the row farthest from the picked set (the first among equal
    distances, as ``jnp.argmax``).  A loop of ``n_samples`` steps of a few
    launches each on the tensor's device; nothing waits for the device."""
    n = points.shape[0]
    mind = torch.full((n,), float("inf"), dtype=points.dtype,
                      device=points.device)
    if mask is None:
        last = torch.zeros((1,), dtype=torch.int64, device=points.device)
    else:
        last = torch.argmax(mask.to(torch.int32)).view(1)
        mind = torch.where(mask, mind, -mind)
    picked = [last]
    for _ in range(n_samples - 1):
        d = torch.sum((points - points.index_select(0, last)) ** 2, dim=-1)
        mind = torch.minimum(mind, d)
        last = torch.argmax(mind).view(1)
        picked.append(last)
    return torch.cat(picked).to(torch.int32)


def eigh_batched(a: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``torch.linalg.eigh`` of [N, n, n] symmetric matrices (ascending
    eigenvalues), in batches of :data:`EIGH_BATCH` matrices: the same
    result for any N (matrices are independent)."""
    if a.shape[0] <= EIGH_BATCH:
        return torch.linalg.eigh(a)
    parts = [torch.linalg.eigh(a[i:i + EIGH_BATCH])
             for i in range(0, a.shape[0], EIGH_BATCH)]
    return (torch.cat([w for w, _ in parts]),
            torch.cat([v for _, v in parts]))


def estimate_pointcloud_normals(points: torch.Tensor, k: int = 16,
                                mask: Optional[torch.Tensor] = None
                                ) -> torch.Tensor:
    """Per-point unit normals [N, 3] by local plane fitting: the ``k``
    nearest neighbours (:func:`knn_self` over ``mask``), their 3x3
    covariance about their centroid, and its eigenvector of the smallest
    eigenvalue (``torch.linalg.eigh``, ascending), turned to point away
    from the centroid.  Only that last step fixes the sign, which
    ``eigh`` leaves to the implementation."""
    _, idx = knn_self(points, k, mask)
    nbr = points[idx.long()]                       # [N, k, 3]
    ctr = torch.mean(nbr, dim=1, keepdim=True)     # [N, 1, 3]
    d = nbr - ctr
    cov = torch.einsum("nki,nkj->nij", d, d) / k   # [N, 3, 3]
    n = eigh_batched(cov)[1][..., 0]
    out = points - ctr[:, 0]
    sign = torch.where(torch.sum(n * out, dim=-1, keepdim=True) < 0.0,
                       -1.0, 1.0)
    n = n * sign
    return n / torch.clamp(torch.linalg.norm(n, dim=-1, keepdim=True),
                           min=1e-8)


def distance_to_gaussian_surface(mean: torch.Tensor, svec: torch.Tensor,
                                 qvec: torch.Tensor, query: torch.Tensor
                                 ) -> torch.Tensor:
    """Ellipsoid "surface radius" of each Gaussian toward ``query`` [N]:
    ``r^2 = s_z^2 cos^2(theta) + (s_x^2 cos^2(phi) + s_y^2 sin^2(phi))^2
    sin^2(theta)``, the squared inner term kept from the reference."""
    R = quat_to_rotmat(qvec)
    xyz = torch.einsum("nji,nj->ni", R, query - mean)
    xyz = xyz / torch.clamp(torch.linalg.norm(xyz, dim=-1, keepdim=True),
                            min=1e-12)
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    r_xy = torch.sqrt(x * x + y * y + 1e-10)
    cos_theta, sin_theta = z, r_xy
    cos_phi, sin_phi = x / r_xy, y / r_xy
    d2 = svec[..., 0] ** 2 * cos_phi ** 2 + svec[..., 1] ** 2 * sin_phi ** 2
    r2 = svec[..., 2] ** 2 * cos_theta ** 2 + d2 ** 2 * sin_theta ** 2
    return torch.sqrt(r2 + 1e-10)
