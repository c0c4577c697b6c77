"""Paper-figure snapshots: posed stills and spiral turntable videos.

Port of the JAX package's ``tools/snapshot.py`` (reference utils/paper.py
take_photo_from_ckpt, utils/paper_spiral.py take_spiral_from_ckpt in
gsgen3d/gsgen): canonical front/left/right 1024x1024 stills with
transmittance-alpha RGBA and a depth colormap, and a fixed-elevation
orbit with rgb|depth side-by-side frames, rendered on the device of the
scene.  A render whose duplicates overflow ``dup_cap`` raises (outside
the trainer nothing grows the bucket, and the image would miss
Gaussians).  Stills are written by the port's PNG encoder
(:func:`..io.logging.write_png`), the orbit by
:func:`..io.logging.write_video` (PNG frames where imageio is missing).

Usage:
  python -m gsgen_torch.tools.snapshot photos <ckpt> [--out dir]
  python -m gsgen_torch.tools.snapshot spiral <ckpt> [--frames 90]
  (each with [--config configs/base.yaml] [--reso N] [--device cuda])
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from ..data.cameras import c2w_from_up_and_look_at
from ..models.scene import RenderConfig, SceneState, render_view
from ..ops.camera import CameraIntrinsics
from ..utils.colormaps import apply_depth_colormap
from ..utils.spiral import camera_path_fixed_elevation

UP = np.array([0.0, 0.0, 1.0])
ORIGIN = np.zeros(3)

# canonical paper poses (reference utils/paper.py:27-31)
PHOTO_POSES = {
    "front": np.array([1.5, 1.5, 2.0]) * 0.9,
    "left": np.array([2.0, 0.0, 2.0]),
    "right": np.array([-2.0, 0.0, 2.0]) * 0.8,
}


@torch.no_grad()
def _frame(state: SceneState, cfg: RenderConfig, c2w, intr):
    dev = state.params["mean"].device
    out = render_view(state.params, state.active,
                      torch.as_tensor(c2w, dtype=torch.float32, device=dev),
                      intr, cfg, torch.zeros(3, device=dev))
    n_dup = int(out["n_dup"])
    if n_dup > cfg.dup_cap:
        raise RuntimeError(
            f"a {intr.w}x{intr.h} still needs {n_dup} duplicates, over "
            f"renderer.dup_cap {cfg.dup_cap}: raise renderer.dup_cap")
    rgb = torch.clamp(out["rgb"], 0.0, 1.0).cpu().numpy()
    op = out["opacity"].cpu().numpy()[..., None]
    depth = apply_depth_colormap(out["depth"].cpu().numpy()[..., None],
                                 accumulation=op)
    # alpha = 1 - T, the reference's putalpha source (utils/paper.py:74)
    alpha = 1.0 - out["T"].cpu().numpy().reshape(rgb.shape[0],
                                                 rgb.shape[1], 1)
    return rgb, depth, alpha


def take_photos(state: SceneState, cfg: RenderConfig, reso: int = 1024,
                poses: dict | None = None, use_bg: bool = False) -> dict:
    """{name: {"rgb": [H,W,3|4], "depth": [H,W,3|4]}} float arrays.

    With use_bg=False an alpha channel (1 - transmittance) is appended,
    matching the reference's transparent paper figures
    (utils/paper.py:58-85).
    """
    intr = CameraIntrinsics.from_reso(reso)
    shots = {}
    for name, pos in (poses or PHOTO_POSES).items():
        c2w = c2w_from_up_and_look_at(UP, ORIGIN, np.asarray(pos, np.float64))
        rgb, depth, alpha = _frame(state, cfg, c2w, intr)
        if not use_bg:
            rgb = np.concatenate([rgb, alpha], axis=-1)
            depth = np.concatenate([depth, alpha], axis=-1)
        shots[name] = {"rgb": rgb, "depth": depth}
    return shots


def take_spiral(state: SceneState, cfg: RenderConfig, n_frames: int = 90,
                reso: int = 512, camera_distance: float = 2.5,
                elevation: float = 45.0,
                rng: np.random.Generator | None = None) -> np.ndarray:
    """[T, H, 2W, 3] rgb|depth orbit frames (utils/paper_spiral.py:20-99).

    With rng set, composites over one random background color like the
    reference's random_bg branch (:53-81); otherwise background-free.
    """
    intr = CameraIntrinsics.from_reso(reso)
    c2ws = camera_path_fixed_elevation(n_frames, 1, camera_distance,
                                       elevation)
    bg = rng.random(3).astype(np.float32) if rng is not None else None
    frames = []
    for c2w in c2ws:
        rgb, depth, alpha = _frame(state, cfg, c2w, intr)
        if bg is not None:
            rgb = np.clip(rgb + (1.0 - alpha) * bg, 0.0, 1.0)
        frames.append(np.concatenate([rgb, depth], axis=1))
    return np.stack(frames)


def main(argv=None):
    import argparse

    from ..config import build_trainer, load_config
    from ..io.logging import write_png, write_video

    ap = argparse.ArgumentParser()
    ap.add_argument("mode", choices=["photos", "spiral"])
    ap.add_argument("ckpt")
    ap.add_argument("--config", default="configs/base.yaml")
    ap.add_argument("--out", default=None)
    ap.add_argument("--reso", type=int, default=None)
    ap.add_argument("--frames", type=int, default=90)
    ap.add_argument("--use_bg", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    trainer = build_trainer(load_config(args.config), device=args.device)
    step = trainer.load(args.ckpt)
    print(f"loaded step {step}")

    if args.mode == "photos":
        out_dir = Path(args.out or "paper_images")
        out_dir.mkdir(parents=True, exist_ok=True)
        shots = take_photos(trainer.state.scene, trainer.rcfg,
                            reso=args.reso or 1024, use_bg=args.use_bg)
        for name, imgs in shots.items():
            for kind, img in imgs.items():
                path = write_png(out_dir / f"{name}_{kind}.png", img)
                print(f"wrote {path}")
    else:
        frames = take_spiral(trainer.state.scene, trainer.rcfg,
                             n_frames=args.frames, reso=args.reso or 512)
        out = write_video(args.out or "spiral.mp4", frames, fps=30)
        print(f"wrote {out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
