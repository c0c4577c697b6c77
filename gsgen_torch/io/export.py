"""Asset export: .ply (3DGS vertex layout), .splat (antimatter15), mesh.

Port of the JAX package's ``io/export.py``.  ``to_ply`` and ``to_splat``
write the same bytes as the JAX exporter for the same params:

* ``.ply``: raw (pre-activation) fields, color x 255, binary little
  endian;
* ``.splat``: one 32-byte record a Gaussian (position and scale float32,
  rgba and the quaternion as bytes), sorted by volume x opacity
  descending; written as one numpy structured array.  Its activations run
  on the host in float32 as the JAX exporter computes them on the CPU:
  ``exp`` is XLA's Cephes polynomial with fused multiply-adds and
  subnormals flushed to zero, ``sigmoid`` is ``1 / (1 + exp(-x))`` on it
  (:func:`exp_f32`, :func:`sigmoid_f32`), so that scales and the rounding
  to bytes agree bit for bit.  Other activations take the port's torch
  functions on the CPU.

``density_grid`` evaluates the opacity-weighted Gaussian density on a
regular grid on the device of the params, with the port's KNN
(``utils/ops.py``); ``to_mesh`` extracts its iso-surface with the port's
marching tetrahedra (``native/mcubes.cpp``) and writes an OBJ.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from ..models.scene import RenderConfig, activate
from ..ops.transforms import quat_scale_to_cov3d
from ..utils.activations import act
from ..utils.ops import knn

PLY_FIELDS = ["x", "y", "z", "nx", "ny", "nz", "red", "green", "blue",
              "opacity", "scale_0", "scale_1", "scale_2",
              "rot_0", "rot_1", "rot_2", "rot_3"]
SPLAT_RECORD = np.dtype([("pos", "<f4", 3), ("scale", "<f4", 3),
                         ("rgba", "u1", 4), ("rot", "u1", 4)])

_F32 = np.float32
_F64 = np.float64


def _gather_active(params: Dict[str, torch.Tensor], active) -> dict:
    idx = torch.nonzero(active)[:, 0]
    return {f: params[f][idx].detach().cpu().numpy()
            for f in ("mean", "qvec", "svec", "color", "alpha")}


def to_ply(params: Dict[str, torch.Tensor], active, path) -> str:
    """The official 3DGS vertex layout; raw svec / alpha / qvec, color
    scaled by 255."""
    p = _gather_active(params, active)
    n = p["mean"].shape[0]
    attrs = np.concatenate([
        p["mean"], np.zeros_like(p["mean"]),
        p["color"] * 255.0, p["alpha"][:, None],
        p["svec"], p["qvec"]], axis=1).astype("<f4")
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    header = ["ply", "format binary_little_endian 1.0",
              f"element vertex {n}"]
    header += [f"property float {f}" for f in PLY_FIELDS]
    header += ["end_header"]
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode("ascii"))
        f.write(attrs.tobytes())
    return str(path)


def _fma_f32(a, b, c) -> np.ndarray:
    """float32 a * b + c rounded once: the product is exact in float64, the
    sum is rounded to odd there (TwoSum), so its rounding to float32 is
    the fused one."""
    a, b, c = (np.asarray(v, _F32).astype(_F64) for v in (a, b, c))
    p = a * b
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    fix = (err != 0) & ((s.view(np.int64) & 1) == 0)
    s = np.where(fix, np.nextafter(s, np.where(err > 0, np.inf, -np.inf)), s)
    return s.astype(_F32)


def _flush(x: np.ndarray) -> np.ndarray:
    return np.where(np.abs(x) < np.finfo(_F32).tiny, _F32(0.0),
                    x).astype(_F32)


def exp_f32(x) -> np.ndarray:
    """float32 exp as XLA computes it on the CPU: x clamped to [-87.8,
    88.8], n = floor(x log2(e) + 1/2) clamped to [-127, 127], the Cephes
    degree-5 polynomial of the remainder, times 2^n, subnormals to 0."""
    x = np.clip(np.asarray(x, _F32), _F32(-87.8), _F32(88.8))
    n = np.clip(np.floor(_fma_f32(x, 1.44269504088896341, 0.5)), -127, 127)
    r = _fma_f32(n, -0.693359375, x)
    r = _fma_f32(n, 2.12194440e-4, r)
    y = _fma_f32(r, 1.9875691500e-4, 1.3981999507e-3)
    for c in (8.3334519073e-3, 4.1665795894e-2, 1.6666665459e-1,
              5.0000001201e-1):
        y = _fma_f32(y, r, c)
    y = _fma_f32(y, r * r, r) + _F32(1.0)
    with np.errstate(over="ignore"):
        return _flush(np.ldexp(y.astype(_F64), n.astype(np.int32))
                      .astype(_F32))


def sigmoid_f32(x) -> np.ndarray:
    """float32 ``1 / (1 + exp(-x))`` on :func:`exp_f32`, subnormals to 0."""
    with np.errstate(over="ignore"):
        return _flush(_F32(1.0) / (_F32(1.0) + exp_f32(-np.asarray(x, _F32))))


def _host_act(name: str, x: np.ndarray) -> np.ndarray:
    if name == "exp":
        return exp_f32(x)
    if name == "sigmoid":
        return sigmoid_f32(x)
    return act(name)(torch.from_numpy(x)).numpy()


def to_splat(params: Dict[str, torch.Tensor], active, path,
             cfg: Optional[RenderConfig] = None) -> str:
    """antimatter15 .splat: position and scale float32, rgba and the
    normalised quaternion as bytes, sorted by volume x opacity
    descending."""
    cfg = cfg or RenderConfig()
    p = _gather_active(params, active)
    rgb = _host_act(cfg.color_act, p["color"])
    rgb = np.clip(rgb * 255.0, 0, 255).astype(np.uint8)
    opacity = _host_act(cfg.alpha_act, p["alpha"])
    op_u8 = np.clip(opacity * 255.0, 0, 255).astype(np.uint8)
    svec = _host_act(cfg.svec_act, p["svec"])
    qvec = p["qvec"] / np.linalg.norm(p["qvec"], axis=1, keepdims=True)
    qvec = np.clip(qvec * 128 + 128, 0, 255).astype(np.uint8)

    order = np.argsort(-(np.prod(svec, axis=1) * opacity))
    rec = np.empty(order.shape[0], SPLAT_RECORD)
    rec["pos"] = p["mean"][order]
    rec["scale"] = svec[order]
    rec["rgba"] = np.concatenate([rgb, op_u8[:, None]], axis=1)[order]
    rec["rot"] = qvec[order]
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_bytes(rec.tobytes())
    return str(path)


@torch.no_grad()
def density_grid(params: Dict[str, torch.Tensor], active,
                 cfg: RenderConfig, reso: int = 128, K: int = 3,
                 L: float = -1.0, batch: int = 4096):
    """Opacity-weighted density of each grid point's K nearest Gaussians,
    on a [reso]^3 grid over [-L, L]^3 (L: 1.1 x the largest |mean| when
    negative).  Returns (numpy grid [reso, reso, reso], L)."""
    mean, qvec, svec, _, alpha = activate(params, cfg)
    idx = torch.nonzero(active)[:, 0]
    mean = mean[idx]
    cov = quat_scale_to_cov3d(qvec[idx], svec[idx])
    eye = torch.eye(3, dtype=cov.dtype, device=cov.device)
    cov_inv = torch.linalg.inv(cov + 1e-8 * eye)
    alpha = alpha[idx]
    if L < 0.0:
        L = float(mean.abs().max()) * 1.1
    xs = torch.linspace(-L, L, reso, device=mean.device)
    gx, gy, gz = torch.meshgrid(xs, xs, xs, indexing="ij")
    grid = torch.stack([gx.reshape(-1), gy.reshape(-1), gz.reshape(-1)], -1)
    out = []
    for s in range(0, grid.shape[0], batch):
        pos = grid[s:s + batch]
        nn = knn(pos, mean, K)[1].long()                 # [B, K]
        d = pos[:, None, :] - mean[nn]                    # [B, K, 3]
        m = torch.einsum("bki,bkij,bkj->bk", d, cov_inv[nn], d)
        out.append(torch.sum(alpha[nn] * torch.exp(-0.5 * m), dim=-1))
    return torch.cat(out).reshape(reso, reso, reso).cpu().numpy(), L


def to_mesh(params: Dict[str, torch.Tensor], active, cfg: RenderConfig,
            path, reso: int = 128, K: int = 3, thresh: float = 0.5) -> str:
    """Density grid -> marching tetrahedra -> OBJ in world coordinates."""
    grid, L = density_grid(params, active, cfg, reso=reso, K=K)
    from ..native.mcubes import marching_cubes
    verts, faces = marching_cubes(grid, thresh)
    verts = verts / (reso - 1) * 2.0 * L - L
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w") as f:
        for v in verts:
            f.write(f"v {v[0]:.6f} {v[1]:.6f} {v[2]:.6f}\n")
        for t in faces + 1:
            f.write(f"f {t[0]} {t[1]} {t[2]}\n")
    return str(path)
