"""3D priors and assets: point clouds, meshes, Point-E and Shap-E inits.

Port of the JAX package's ``priors/__init__.py`` (reference
utils/initialize.py:110-333 and 410-439, utils/point_e_helper.py,
utils/shap_e_helper.py).  :func:`load_point_cloud` (``init.type:
point_cloud`` from ``init_asset``: ``.npy`` / ``.npz`` / ``.ply``),
:func:`load_mesh` (``.ply`` / ``.obj``) and :func:`mesh_init_arrays`
(``init.type: mesh``: area-weighted, poisson-thinned surface samples) are
the JAX package's numpy code, copied.  A cloud is produced once and kept
as an asset: ``point_e_generate`` reads
``$GSGEN_ASSET_DIR/point_e_<md5(prompt)[:16]>.npz`` (keys ``xyz``,
``rgb``; the same file name and format as the JAX package's, so either
package reads the other's cache), else samples it in process from Point-E
checkpoints and writes it there, else raises.
``point_e_image_generate`` does the same for an image (cache
``point_e_image_<md5(key)[:16]>.npz``, the key ``file:<resolved path>``
for a path and ``arr:<md5 of the float32 bytes>`` for an array, as the
JAX package keys it), sampling the image-grid base model and the
grid-conditioned upsampler at CFG 3.0 on the CLIP ViT-L/14 grid.
``shap_e_generate`` reads ``shap_e_<md5(prompt)[:16]>.npz``, else decodes
a Shap-E latent (given as a ``.npy``, or sampled from text300M on the
prompt's CLIP text vector) into a mesh whose vertices and colours are the
cloud (:mod:`.shap_e`).
"""

from __future__ import annotations

import hashlib
import os
from pathlib import Path
from typing import Optional, Tuple

import numpy as np


def load_point_cloud(path) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Load (xyz [N,3], rgb [N,3] or None) from .npy/.npz/.ply.

    .npy: [N, 6] (xyz+rgb) or [N, 3] (utils/initialize.py:311-334).
    """
    path = Path(path)
    if path.suffix == ".npy":
        a = np.load(path)
        return a[:, :3], (a[:, 3:6] if a.shape[1] >= 6 else None)
    if path.suffix == ".npz":
        z = np.load(path)
        return z["xyz"], (z["rgb"] if "rgb" in z else None)
    if path.suffix == ".ply":
        return _load_ply_points(path)
    raise ValueError(f"unknown point cloud format {path.suffix}")


def _load_ply_points(path) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Minimal binary/ascii PLY vertex reader (x y z [red green blue])."""
    with open(path, "rb") as f:
        header = []
        while True:
            line = f.readline().decode("ascii").strip()
            header.append(line)
            if line == "end_header":
                break
        n = next(int(l.split()[-1]) for l in header
                 if l.startswith("element vertex"))
        props = [l.split()[1:] for l in header if l.startswith("property")]
        fmt = next(l.split()[1] for l in header if l.startswith("format"))
        names = [p[1] for p in props]
        if fmt == "ascii":
            data = np.loadtxt(f, max_rows=n)
        else:
            dt = np.dtype([(p[1], {"float": "<f4", "uchar": "u1",
                                   "double": "<f8", "int": "<i4"}[p[0]])
                           for p in props])
            data = np.frombuffer(f.read(n * dt.itemsize), dtype=dt, count=n)
            data = np.stack([data[nm].astype(np.float64) for nm in names], 1)
        xyz = data[:, [names.index("x"), names.index("y"), names.index("z")]]
        rgb = None
        if "red" in names:
            rgb = data[:, [names.index("red"), names.index("green"),
                           names.index("blue")]]
            if rgb.max() > 1.5:
                rgb = rgb / 255.0
        return xyz.astype(np.float32), rgb


def load_mesh(path) -> Tuple[np.ndarray, np.ndarray]:
    """Load (vertices [V,3], faces [F,3] int) from .ply or .obj.

    Replaces the reference's trimesh loader (utils/mesh.py
    ``load_mesh_as_pcd_trimesh``) for the two formats the init path
    needs; polygon faces are fan-triangulated like trimesh does.
    """
    path = Path(path)
    if path.suffix == ".obj":
        verts, faces = [], []
        with open(path) as f:
            for line in f:
                t = line.split()
                if not t:
                    continue
                if t[0] == "v":
                    verts.append([float(x) for x in t[1:4]])
                elif t[0] == "f":
                    idx = [int(x.split("/")[0]) for x in t[1:]]
                    idx = [i - 1 if i > 0 else len(verts) + i for i in idx]
                    for k in range(1, len(idx) - 1):   # fan triangulation
                        faces.append([idx[0], idx[k], idx[k + 1]])
        return (np.asarray(verts, np.float32),
                np.asarray(faces, np.int64).reshape(-1, 3))
    if path.suffix == ".ply":
        return _load_ply_mesh(path)
    raise ValueError(f"unknown mesh format {path.suffix}")


def _load_ply_mesh(path) -> Tuple[np.ndarray, np.ndarray]:
    """PLY reader that also parses the face element (list property)."""
    with open(path, "rb") as f:
        header = []
        while True:
            line = f.readline().decode("ascii").strip()
            header.append(line)
            if line == "end_header":
                break
        fmt = next(l.split()[1] for l in header if l.startswith("format"))
        counts = {}
        order = []
        props = {}
        cur = None
        for l in header:
            t = l.split()
            if t[0] == "element":
                cur = t[1]
                counts[cur] = int(t[2])
                order.append(cur)
                props[cur] = []
            elif t[0] == "property" and cur is not None:
                props[cur].append(t[1:])
        np_t = {"float": "f4", "float32": "f4", "double": "f8",
                "uchar": "u1", "uint8": "u1", "char": "i1",
                "short": "i2", "ushort": "u2", "int": "i4",
                "int32": "i4", "uint": "u4", "uint32": "u4"}
        verts = faces = None
        for el in order:
            n = counts[el]
            if el == "vertex":
                names = [p[-1] for p in props[el]]
                if fmt == "ascii":
                    data = np.loadtxt(f, max_rows=n).reshape(n, -1)
                else:
                    dt = np.dtype([(p[-1], "<" + np_t[p[0]])
                                   for p in props[el]])
                    data = np.frombuffer(f.read(n * dt.itemsize),
                                         dtype=dt, count=n)
                    data = np.stack([data[nm].astype(np.float64)
                                     for nm in names], 1)
                verts = data[:, [names.index("x"), names.index("y"),
                                 names.index("z")]].astype(np.float32)
            elif el == "face":
                cnt_t, idx_t = props[el][0][1], props[el][0][2]
                if fmt == "ascii":
                    rows = [f.readline().split() for _ in range(n)]
                    faces = np.asarray(
                        [[int(r[1]), int(r[2]), int(r[3])] for r in rows],
                        np.int64)
                else:
                    out = []
                    csz = np.dtype(np_t[cnt_t]).itemsize
                    isz = np.dtype(np_t[idx_t]).itemsize
                    for _ in range(n):
                        k = int(np.frombuffer(f.read(csz),
                                              "<" + np_t[cnt_t])[0])
                        idx = np.frombuffer(f.read(k * isz),
                                            "<" + np_t[idx_t])
                        for j in range(1, k - 1):
                            out.append([idx[0], idx[j], idx[j + 1]])
                    faces = np.asarray(out, np.int64)
            else:   # skip unknown elements (binary only if fixed-size)
                if fmt == "ascii":
                    for _ in range(n):
                        f.readline()
                else:
                    dt = np.dtype([(p[-1], "<" + np_t[p[0]])
                                   for p in props[el]])
                    f.read(n * dt.itemsize)
    assert verts is not None and faces is not None, \
        f"{path} has no vertex+face elements (use init.type=point_cloud " \
        "for vertex-only PLYs)"
    return verts, faces


def sample_mesh_surface(verts: np.ndarray, faces: np.ndarray, n: int,
                        rng=None, even: bool = True) -> np.ndarray:
    """Area-weighted (optionally blue-noise 'even') surface samples.

    Matches the reference's ``trimesh.sample.sample_surface_even`` use
    (utils/mesh.py:53-69): faces are drawn with probability
    proportional to their AREA (not one-per-vertex — the round-3 repo
    read PLY vertices, which biases density toward tessellation), points
    are uniform in each triangle via the sqrt-barycentric map, and with
    ``even=True`` a poisson-disk rejection pass (radius derived from
    total area / n, grid-hashed) evens out clusters, topping up with
    fresh area-weighted draws like trimesh's retry loop.
    """
    rng = rng or np.random.default_rng(0)
    v0, v1, v2 = (verts[faces[:, 0]], verts[faces[:, 1]],
                  verts[faces[:, 2]])
    area = 0.5 * np.linalg.norm(np.cross(v1 - v0, v2 - v0), axis=1)
    total = area.sum()
    assert total > 0, "degenerate mesh (zero surface area)"
    p = area / total

    def draw(k):
        fi = rng.choice(len(faces), size=k, p=p)
        r1 = np.sqrt(rng.random(k, dtype=np.float64))
        r2 = rng.random(k, dtype=np.float64)
        a, b, c = 1.0 - r1, r1 * (1.0 - r2), r1 * r2
        return (a[:, None] * v0[fi] + b[:, None] * v1[fi]
                + c[:, None] * v2[fi]).astype(np.float32)

    if not even:
        return draw(n)
    # poisson-disk thinning: radius such that n disks tile ~total area
    radius = np.sqrt(total / (np.pi * n)) * 0.8
    cell = radius / np.sqrt(3.0)
    kept: list = []
    occupied = set()
    attempts = 0
    while len(kept) < n and attempts < 8:
        batch = draw(max(2 * (n - len(kept)), 64))
        cells = np.floor(batch / cell).astype(np.int64)
        for pt, cc in zip(batch, cells):
            key = tuple(cc)
            if key in occupied:
                continue
            occupied.add(key)
            kept.append(pt)
            if len(kept) == n:
                break
        attempts += 1
    if len(kept) < n:       # dense meshes: top up area-weighted
        kept.extend(draw(n - len(kept)))
    return np.stack(kept[:n], axis=0)


def mesh_init_arrays(mesh_path, num_points: int = 4096,
                     mean_std: float = 0.6, flip_yz: bool = False,
                     flip_xy: bool = False, seed: int = 0,
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """``init.type=mesh`` arrays, matching the reference's
    mesh_initlization (utils/initialize.py:285-333): even area-weighted
    surface samples, centered, unit-max-norm scaled to ``mean_std``,
    optional axis flips.  Colors are RANDOM draws exactly like the
    reference (``load_mesh_as_pcd_trimesh`` returns ``torch.rand_like``
    — and ``random_color`` defaults True there anyway)."""
    rng = np.random.default_rng(seed)
    verts, faces = load_mesh(mesh_path)
    xyz = sample_mesh_surface(verts, faces, num_points, rng)
    xyz = xyz - xyz.mean(axis=0, keepdims=True)
    xyz = xyz / (np.linalg.norm(xyz, axis=-1).max() + 1e-5) * mean_std
    if flip_yz:
        xyz = xyz[:, [0, 2, 1]]
    if flip_xy:
        xyz = xyz[:, [1, 0, 2]]
    rgb = rng.random((num_points, 3)).astype(np.float32)
    return xyz.astype(np.float32), rgb


def _asset_path(prompt: str, kind: str = "point_e") -> Path:
    """``$GSGEN_ASSET_DIR`` (default ``assets/point_clouds``, read at call
    time) / ``<kind>_<md5(prompt)[:16]>.npz``."""
    key = hashlib.md5(prompt.encode()).hexdigest()[:16]
    root = os.environ.get("GSGEN_ASSET_DIR", "assets/point_clouds")
    return Path(root) / f"{kind}_{key}.npz"


def point_e_generate(prompt: str, num_points: int = 4096,
                     base_weights: Optional[str] = None,
                     upsample_weights: Optional[str] = None,
                     clip_model_dir: Optional[str] = None,
                     karras_steps: Tuple[int, int] = (64, 64),
                     base_cfg=None, up_cfg=None, device="cuda",
                     seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Text -> coloured point cloud (xyz [N, 3], rgb [N, 3] in [0, 1]).

    Resolution order, as in the JAX package:

    1. the asset cache (:func:`_asset_path`);
    2. the in-process two-stage sampler on ``device``
       (:mod:`.point_e_sampler`) when a base checkpoint is given, here or
       by ``GSGEN_POINT_E_BASE`` (the upsampler's by
       ``GSGEN_POINT_E_UPSAMPLE``), drawing from a generator seeded
       ``seed``; the cloud is written to the cache;
    3. otherwise ``FileNotFoundError``.

    ``clip_model_dir`` (or ``GSGEN_CLIP_DIR``), a local CLIP directory,
    conditions the base stage on the prompt's projected text vector
    (:func:`..prompt.encoders.build_clip_textvec_fn`).  ``base_cfg`` /
    ``up_cfg`` replace the full-width configs (the tests' TINY ones).
    """
    p = _asset_path(prompt)
    if p.exists():
        z = np.load(p)
        return z["xyz"][:num_points], z["rgb"][:num_points]

    base_weights = base_weights or os.environ.get("GSGEN_POINT_E_BASE")
    upsample_weights = (upsample_weights
                        or os.environ.get("GSGEN_POINT_E_UPSAMPLE"))
    clip_model_dir = clip_model_dir or os.environ.get("GSGEN_CLIP_DIR")
    if base_weights is not None:
        xyz, rgb = _point_e_sample_in_process(
            prompt, base_weights, upsample_weights, clip_model_dir,
            karras_steps, base_cfg, up_cfg, device, seed)
        p.parent.mkdir(parents=True, exist_ok=True)
        np.savez(p, xyz=xyz, rgb=rgb)
        return xyz[:num_points], rgb[:num_points]

    raise FileNotFoundError(
        f"No Point-E asset for prompt {prompt!r} at {p} and no "
        "checkpoints configured. Either precompute the cloud and save "
        "np.savez(path, xyz=..., rgb=...), or point GSGEN_POINT_E_BASE/"
        "GSGEN_POINT_E_UPSAMPLE (+GSGEN_CLIP_DIR for text conditioning) "
        "at point-e checkpoints (init.point_e_base/init.point_e_upsample "
        "config keys work too); or use init.type=base/unisphere/"
        "semisphere/box.")


def _point_e_sample_in_process(prompt, base_weights, upsample_weights,
                               clip_model_dir, karras_steps, base_cfg, up_cfg,
                               device, seed=0):
    """The two-stage sampler on checkpoints, on the prompt's CLIP text
    vector (a zero one without ``clip_model_dir``), with its draws from a
    generator seeded ``seed``."""
    import torch

    from ..guidance.point_e import (BASE40M_TEXTVEC, UPSAMPLE_CFG,
                                    PointEModel, PointEUpsamplerModel)
    from .point_e_sampler import PointESampler, PointESamplerConfig

    base = PointEModel(base_cfg or BASE40M_TEXTVEC, device=device
                       ).load_weights(base_weights)
    up = None
    if upsample_weights is not None:
        up = PointEUpsamplerModel(up_cfg or UPSAMPLE_CFG, device=device
                                  ).load_weights(upsample_weights)
    textvec = None
    if clip_model_dir:
        textvec = _clip_textvec(clip_model_dir, prompt, device)[None]
    sampler = PointESampler(base, up, PointESamplerConfig(
        karras_steps=tuple(karras_steps)))
    gen = torch.Generator(device=device).manual_seed(seed)
    return sampler.sample_to_cloud(textvec, generator=gen)


def _clip_textvec(clip_model_dir, prompt: str, device):
    """The prompt's projected CLIP text vector [F] on ``device``."""
    import torch

    from ..prompt.encoders import build_clip_textvec_fn
    return torch.as_tensor(build_clip_textvec_fn(
        clip_model_dir, device=device)([prompt])[0], device=device)


def _image_key(image) -> str:
    if isinstance(image, (str, Path)):
        return f"file:{Path(image).resolve()}"
    return "arr:" + hashlib.md5(
        np.ascontiguousarray(image, np.float32).tobytes()).hexdigest()


def point_e_image_generate(image, num_points: int = 4096,
                           base_weights: Optional[str] = None,
                           upsample_weights: Optional[str] = None,
                           clip_model_dir: Optional[str] = None,
                           base_cfg=None, up_cfg=None, clip_cfg=None,
                           karras_steps: Tuple[int, int] = (64, 64),
                           seed: int = 0, cache: bool = True, device="cuda",
                           ) -> Tuple[np.ndarray, np.ndarray]:
    """Image -> coloured point cloud (reference point_e_generate_pcd_from
    _image, utils/point_e_helper.py:64-122).  ``image``: a PNG path or an
    [H, W, 3] float array in [0, 1].

    The asset cache first (:func:`_image_key`); else, with a base
    checkpoint (here or ``GSGEN_POINT_E_IMAGE_BASE``; the upsampler's
    ``GSGEN_POINT_E_UPSAMPLE``) and the ViT-L/14 vision tower's state dict
    (``clip_model_dir``, ``GSGEN_CLIP_VISION_DIR`` or ``GSGEN_CLIP_DIR``: a
    ``.pt`` file in the transformers layout),
    the two stages on ``device`` at CFG 3.0 on the image's CLIP grid
    (the upsampler conditioned on it too), drawing from a generator seeded
    ``seed``; the cloud is cached.  ``base_cfg`` / ``up_cfg`` /
    ``clip_cfg`` replace the full-width configs."""
    p = _asset_path(_image_key(image), "point_e_image")
    if p.exists():
        z = np.load(p)
        return z["xyz"][:num_points], z["rgb"][:num_points]
    base_weights = base_weights or os.environ.get("GSGEN_POINT_E_IMAGE_BASE")
    upsample_weights = (upsample_weights
                        or os.environ.get("GSGEN_POINT_E_UPSAMPLE"))
    clip_model_dir = (clip_model_dir
                      or os.environ.get("GSGEN_CLIP_VISION_DIR")
                      or os.environ.get("GSGEN_CLIP_DIR"))
    if base_weights is None:
        raise FileNotFoundError(
            f"No Point-E image asset at {p} and no image-conditioned "
            "checkpoint configured.  Precompute np.savez(path, xyz=..., "
            "rgb=...), or point GSGEN_POINT_E_IMAGE_BASE at a base40M/"
            "base300M/base1B checkpoint (+GSGEN_POINT_E_UPSAMPLE, "
            "+GSGEN_CLIP_VISION_DIR for the ViT-L/14 tower); "
            "init.point_e_image_base etc. work too.")
    if not clip_model_dir:
        raise FileNotFoundError(
            "the image-grid Point-E init conditions on the CLIP ViT-L/14 "
            "grid: set init.clip_vision_dir or GSGEN_CLIP_VISION_DIR")
    import torch

    from ..guidance.point_e import (BASE40M_IMAGE, UPSAMPLE_CFG,
                                    PointEImageGridModel,
                                    PointEUpsamplerModel)
    from ..prompt.clip_vision import VIT_L14, CLIPImageEncoder
    from .point_e_sampler import PointESampler, PointESamplerConfig

    if isinstance(image, (str, Path)):
        from ..io.logging import read_png
        arr = read_png(image).astype(np.float32) / 255.0
    else:
        arr = np.asarray(image, np.float32)
    if arr.ndim == 2:
        arr = np.repeat(arr[..., None], 3, axis=-1)
    arr = np.ascontiguousarray(arr[..., :3])
    clip_cfg = clip_cfg or VIT_L14
    enc = CLIPImageEncoder.from_state_dict(
        clip_model_dir, clip_cfg, projection_dim=768, device=device)
    base_cfg = base_cfg or BASE40M_IMAGE
    grid_tokens = (clip_cfg.image_size // clip_cfg.patch_size) ** 2
    base = PointEImageGridModel(base_cfg, device=device,
                                grid_tokens=grid_tokens
                                ).load_weights(base_weights)
    up = None
    if upsample_weights is not None:
        up = PointEUpsamplerModel(up_cfg or UPSAMPLE_CFG, device=device
                                  ).load_weights(upsample_weights)
    with torch.no_grad():
        cond = enc.encode_grid(torch.as_tensor(arr, device=device)[None])
    del enc
    sampler = PointESampler(base, up, PointESamplerConfig(
        karras_steps=tuple(karras_steps),
        up_guidance_scale=3.0 if up is not None else 0.0,
        up_cond=up is not None))
    gen = torch.Generator(device=device).manual_seed(seed)
    xyz, rgb = sampler.sample_to_cloud(cond, generator=gen)
    if cache:
        p.parent.mkdir(parents=True, exist_ok=True)
        np.savez(p, xyz=xyz, rgb=rgb)
    return xyz[:num_points], rgb[:num_points]


def point_e_image_init_arrays(image, num_points: int = 4096,
                              mean_std: float = 0.6, facex: bool = False,
                              seed: int = 0, **generate_kw
                              ) -> Tuple[np.ndarray, np.ndarray]:
    """``init.type=point_e_image`` arrays (reference point_e_image_
    initialize, utils/initialize.py:410-439): the cloud, padded to
    ``num_points`` by resampling, scaled to a largest norm of
    ``mean_std`` (no centring: the reference skips it on this path) and
    turned by ``facex``."""
    xyz, rgb = point_e_image_generate(image, num_points=num_points,
                                      seed=seed, **generate_kw)
    xyz = np.asarray(xyz, np.float32)
    rgb = np.asarray(rgb, np.float32)
    rng = np.random.default_rng(seed)
    if xyz.shape[0] < num_points:
        idx = rng.integers(0, xyz.shape[0], num_points - xyz.shape[0])
        xyz = np.concatenate([xyz, xyz[idx]], 0)
        rgb = np.concatenate([rgb, rgb[idx]], 0)
    xyz = xyz / (np.linalg.norm(xyz, axis=-1).max() + 1e-5) * mean_std
    if facex:
        x, y, z = xyz[:, 0], xyz[:, 1], xyz[:, 2]
        xyz = np.stack([-y, x, z], axis=1)
    return xyz, rgb


def point_e_init_arrays(prompt: str, num_points: int = 4096,
                        mean_std: float = 0.6, z_scale: float = 1.0,
                        random_exceed: bool = False, seed: int = 0,
                        **generate_kw) -> Tuple[np.ndarray, np.ndarray]:
    """A Point-E cloud normalised for scene init (reference
    utils/initialize.py:110-167): padded to ``num_points`` (resampled with
    ``random_exceed``, else normal extras and random colours), centred,
    scaled to a largest norm of ``mean_std``, z scaled by ``z_scale``; the
    facex rotation is ``init.facex``'s, downstream."""
    xyz, rgb = point_e_generate(prompt, num_points=4096, **generate_kw)
    xyz = np.asarray(xyz, np.float32)
    rgb = np.asarray(rgb, np.float32)
    rng = np.random.default_rng(seed)
    if num_points > xyz.shape[0]:
        if random_exceed:
            idx = rng.integers(0, xyz.shape[0], num_points)
            xyz, rgb = xyz[idx], rgb[idx]
        else:
            extra = num_points - xyz.shape[0]
            xyz = np.concatenate(
                [xyz, rng.normal(size=(extra, 3)).astype(np.float32)
                 * mean_std], 0)
            rgb = np.concatenate(
                [rgb, rng.random((extra, 3), dtype=np.float32)], 0)
    else:
        xyz, rgb = xyz[:num_points], rgb[:num_points]
    xyz = xyz - xyz.mean(axis=0, keepdims=True)
    xyz = xyz / (np.linalg.norm(xyz, axis=-1).max() + 1e-5) * mean_std
    xyz[..., 2] *= z_scale
    return xyz, rgb


def shap_e_generate(prompt: str, num_points: int = 4096,
                    decoder_weights=None, text_model_weights=None,
                    clip_model_dir: Optional[str] = None,
                    latent_path: Optional[str] = None,
                    grid_size: int = 128, karras_steps: int = 64,
                    guidance_scale: float = 15.0, seed: int = 0,
                    cache: bool = True, device="cuda"
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """Text -> mesh-vertex cloud (reference utils/shap_e_helper.py:17-49).

    Resolution order, as in the JAX package:

    1. the asset cache ``shap_e_<md5(prompt)[:16]>.npz``;
    2. a latent ``.npy`` (``latent_path`` / ``GSGEN_SHAP_E_LATENT``, a
       [1024 * 1024] array) decoded on ``device`` by the transmitter /
       vector-decoder checkpoint (``decoder_weights`` /
       ``GSGEN_SHAP_E_DECODER``: a state dict, or a ``.safetensors`` /
       ``.pt`` file of one): SDF grid, marching cubes, vertex colours
       (:mod:`.shap_e`);
    3. text -> latent by the text300M checkpoint (``text_model_weights`` /
       ``GSGEN_SHAP_E_TEXT300M``; 64 Karras steps at CFG 15, drawing from a
       generator seeded ``seed``) on the prompt's CLIP text vector
       (``clip_model_dir`` / ``GSGEN_CLIP_DIR``; zeros without one), then
       decoded as in 2;
    4. otherwise ``FileNotFoundError``.

    An empty mesh raises.  The cloud is written to the cache."""
    p = _asset_path(prompt, "shap_e")
    if p.exists():
        z = np.load(p)
        return z["xyz"][:num_points], z["rgb"][:num_points]

    decoder_weights = decoder_weights or os.environ.get(
        "GSGEN_SHAP_E_DECODER")
    text_model_weights = (text_model_weights
                          or os.environ.get("GSGEN_SHAP_E_TEXT300M"))
    latent_path = latent_path or os.environ.get("GSGEN_SHAP_E_LATENT")
    clip_model_dir = clip_model_dir or os.environ.get("GSGEN_CLIP_DIR")

    if decoder_weights is not None and (latent_path
                                        or text_model_weights is not None):
        import torch

        from ..guidance.convert import read_state_dict
        from .shap_e import ShapEDecoder, sample_shap_e_latent

        if latent_path:
            latent = np.load(latent_path).reshape(-1)
        else:
            textvec = None
            if clip_model_dir:
                textvec = _clip_textvec(clip_model_dir, prompt, device)
            gen = torch.Generator(device=device).manual_seed(seed)
            latent = sample_shap_e_latent(
                text_model_weights, textvec, gen, karras_steps=karras_steps,
                guidance_scale=guidance_scale, device=device)
        dec = ShapEDecoder.from_state_dict(read_state_dict(decoder_weights),
                                           device=device)
        xyz, rgb = dec.decode_mesh(latent, grid_size=grid_size)
        if xyz.shape[0] == 0:
            raise RuntimeError(
                f"shap-e decode produced an empty mesh for {prompt!r}")
        if cache:
            p.parent.mkdir(parents=True, exist_ok=True)
            np.savez(p, xyz=xyz, rgb=rgb)
        return xyz, rgb

    raise FileNotFoundError(
        f"No Shap-E asset for prompt {prompt!r} at {p} and no decode "
        "inputs configured.  Precompute np.savez(path, xyz=..., rgb=...), "
        "or set GSGEN_SHAP_E_DECODER (+ GSGEN_SHAP_E_LATENT for a "
        "provisioned latent, or GSGEN_SHAP_E_TEXT300M + GSGEN_CLIP_DIR "
        "for text->latent sampling); init.shap_e_decoder/init.shap_e_"
        "text300m config keys work too.")


def shap_e_init_arrays(prompt: str, num_points: int = 4096,
                       mean_std: float = 0.6, z_scale: float = 1.0,
                       seed: int = 0, **generate_kw
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """``init.type=shap_e`` arrays (reference shap_e_initialize,
    utils/initialize.py:170-228): the vertex cloud subsampled without
    replacement (or padded by resampling) to ``num_points`` with a numpy
    generator seeded ``seed``, centred, scaled to a largest norm of
    ``mean_std``, z scaled by ``z_scale``."""
    xyz, rgb = shap_e_generate(prompt, num_points=1 << 30, **generate_kw)
    xyz = np.asarray(xyz, np.float32)
    rgb = np.asarray(rgb, np.float32)
    rng = np.random.default_rng(seed)
    if xyz.shape[0] > num_points:
        idx = rng.choice(xyz.shape[0], num_points, replace=False)
        xyz, rgb = xyz[idx], rgb[idx]
    elif xyz.shape[0] < num_points:
        idx = rng.integers(0, xyz.shape[0], num_points - xyz.shape[0])
        xyz = np.concatenate([xyz, xyz[idx]], 0)
        rgb = np.concatenate([rgb, rgb[idx]], 0)
    xyz = xyz - xyz.mean(axis=0, keepdims=True)
    xyz = xyz / (np.linalg.norm(xyz, axis=-1).max() + 1e-5) * mean_std
    xyz[..., 2] *= z_scale
    return xyz, rgb
