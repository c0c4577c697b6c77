"""COLMAP sparse-reconstruction loading (real-scene experiments).

The port's own copy of the JAX package's ``data/colmap.py`` (numpy on
both sides), with the port's ``CameraIntrinsics`` and ``quat_to_rotmat``
(on float32 CPU tensors, as the JAX package rotates in float32).  A port
of the reference's loaders (utils/camera.py:380-465 +
utils/colmap/ in gsgen3d/gsgen), supporting both the binary and text
sparse formats without external dependencies.  Returns world-to-camera
inverted into OpenCV-convention [N, 3, 4] c2ws (R^T | -R^T t), the
pinhole intrinsics and the seed point cloud — everything a
reconstruction run needs to initialize a scene and iterate over real
views.
"""

from __future__ import annotations

import struct
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

from ..ops.camera import CameraIntrinsics
from ..ops.transforms import quat_to_rotmat


class ColmapScene(NamedTuple):
    c2ws: np.ndarray        # [N, 3, 4]
    intr: CameraIntrinsics
    image_names: list
    points: np.ndarray      # [P, 3]
    colors: np.ndarray      # [P, 3] in [0, 1]


def _qvec2rot(q: np.ndarray) -> np.ndarray:
    return quat_to_rotmat(torch.as_tensor(q, dtype=torch.float32)).numpy()


# ---- binary readers (COLMAP sparse model format) ----

def _read_cameras_bin(path: Path):
    with open(path, "rb") as f:
        n = struct.unpack("<Q", f.read(8))[0]
        cams = {}
        model_names = {0: "SIMPLE_PINHOLE", 1: "PINHOLE", 2: "SIMPLE_RADIAL",
                       4: "OPENCV"}
        n_params = {0: 3, 1: 4, 2: 4, 4: 8}
        for _ in range(n):
            cid, model, w, h = struct.unpack("<iiQQ", f.read(24))
            params = struct.unpack(f"<{n_params[model]}d",
                                   f.read(8 * n_params[model]))
            cams[cid] = (model_names.get(model, str(model)), w, h,
                         np.array(params))
        return cams


def _read_images_bin(path: Path):
    with open(path, "rb") as f:
        n = struct.unpack("<Q", f.read(8))[0]
        out = []
        for _ in range(n):
            iid = struct.unpack("<i", f.read(4))[0]
            q = np.array(struct.unpack("<4d", f.read(32)))
            t = np.array(struct.unpack("<3d", f.read(24)))
            cam_id = struct.unpack("<i", f.read(4))[0]
            name = b""
            while True:
                c = f.read(1)
                if c == b"\x00":
                    break
                name += c
            n2d = struct.unpack("<Q", f.read(8))[0]
            f.read(24 * n2d)
            out.append((name.decode(), q, t, cam_id))
        return out


def _read_points_bin(path: Path):
    with open(path, "rb") as f:
        n = struct.unpack("<Q", f.read(8))[0]
        pts = np.empty((n, 3))
        rgb = np.empty((n, 3))
        for i in range(n):
            f.read(8)  # id
            pts[i] = struct.unpack("<3d", f.read(24))
            rgb[i] = struct.unpack("<3B", f.read(3))
            f.read(8)  # error
            track_len = struct.unpack("<Q", f.read(8))[0]
            f.read(8 * track_len)
        return pts, rgb / 255.0


# ---- text readers ----

def _read_cameras_txt(path: Path):
    cams = {}
    for line in path.read_text().splitlines():
        if line.startswith("#") or not line.strip():
            continue
        parts = line.split()
        cams[int(parts[0])] = (parts[1], int(parts[2]), int(parts[3]),
                               np.array([float(x) for x in parts[4:]]))
    return cams


def _read_images_txt(path: Path):
    out = []
    lines = [l for l in path.read_text().splitlines()
             if not l.startswith("#")]
    for i in range(0, len(lines) - 1, 2):
        p = lines[i].split()
        if len(p) < 10:
            continue
        q = np.array([float(x) for x in p[1:5]])
        t = np.array([float(x) for x in p[5:8]])
        out.append((p[9], q, t, int(p[8])))
    return out


def _read_points_txt(path: Path):
    pts, rgb = [], []
    for line in path.read_text().splitlines():
        if line.startswith("#") or not line.strip():
            continue
        p = line.split()
        pts.append([float(x) for x in p[1:4]])
        rgb.append([float(x) for x in p[4:7]])
    return np.array(pts), np.array(rgb) / 255.0


def load_colmap(sparse_dir, near: float = 0.01, far: float = 100.0,
                downsample: int = 1) -> ColmapScene:
    """Load a COLMAP sparse model dir (cameras/images/points3D .bin|.txt)."""
    d = Path(sparse_dir)
    if (d / "cameras.bin").exists():
        cams = _read_cameras_bin(d / "cameras.bin")
        images = _read_images_bin(d / "images.bin")
        pts, rgb = _read_points_bin(d / "points3D.bin")
    else:
        cams = _read_cameras_txt(d / "cameras.txt")
        images = _read_images_txt(d / "images.txt")
        pts, rgb = _read_points_txt(d / "points3D.txt")

    model, w, h, params = next(iter(cams.values()))
    if model == "PINHOLE" or model == "OPENCV":
        fx, fy, cx, cy = params[:4]
    elif model == "SIMPLE_PINHOLE" or model == "SIMPLE_RADIAL":
        fx = fy = params[0]
        cx, cy = params[1], params[2]
    else:
        raise NotImplementedError(f"camera model {model}")
    s = downsample
    intr = CameraIntrinsics(fx=float(fx) / s, fy=float(fy) / s,
                            cx=float(cx) / s, cy=float(cy) / s,
                            w=int(w) // s, h=int(h) // s, near=near, far=far)

    # world-to-cam (q, t) -> c2w = [R^T | -R^T t] (utils/camera.py:409-411)
    names, c2ws = [], []
    for name, q, t, _ in sorted(images, key=lambda x: x[0]):
        R = _qvec2rot(q[None])[0]
        Rt = R.T
        c2ws.append(np.concatenate([Rt, (-Rt @ t)[:, None]], axis=1))
        names.append(name)
    return ColmapScene(c2ws=np.stack(c2ws).astype(np.float32), intr=intr,
                       image_names=names, points=pts.astype(np.float32),
                       colors=rgb.astype(np.float32))
