"""Run directories, scalar logs, eval images and videos.

Port of the JAX package's ``io/logging.py``, with the same run-directory
layout: ``<root>/<prompt>/<date>/<time>/{ckpts,eval,logs}`` plus
``scalars.jsonl`` (one JSON object a logged step), ``config.json`` and the
code snapshot (``code_snapshot.tar.gz`` of the git-tracked files).

Images are written by the port's own PNG writer (:func:`write_png`,
``zlib`` and ``struct`` of the standard library), so eval images exist on
every machine.  TensorBoard event files go to ``logs/`` where
``torch.utils.tensorboard`` imports, as in the JAX package.  Orbit videos
need ``imageio``: where it is missing, the frames are written as PNGs under
``eval/<name>_<step>/`` instead, and one printed line says which form was
written.
"""

from __future__ import annotations

import datetime
import json
import struct
import subprocess
import tarfile
import zlib
from pathlib import Path
from typing import Dict, Optional

import numpy as np


def _to_u8(img: np.ndarray) -> np.ndarray:
    return (np.clip(img, 0, 1) * 255).astype(np.uint8)


def write_png(path, img: np.ndarray) -> str:
    """[H, W, 3] uint8 (or [H, W, 3] float in [0, 1]) -> an 8-bit RGB PNG,
    every row with filter 0 (None)."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        img = _to_u8(img)
    h, w, c = img.shape
    if c != 3:
        raise ValueError(f"write_png takes [H, W, 3], got {img.shape}")
    raw = np.concatenate([np.zeros((h, 1), np.uint8),
                          np.ascontiguousarray(img).reshape(h, w * 3)],
                         axis=1).tobytes()

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    png = (b"\x89PNG\r\n\x1a\n"
           + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
           + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))
    Path(path).write_bytes(png)
    return str(path)


class RunLogger:
    def __init__(self, root="checkpoints", name: str = "run",
                 use_tensorboard: bool = True):
        now = datetime.datetime.now()
        safe = name.replace(" ", "_")[:80]
        self.dir = (Path(root) / safe / now.strftime("%Y-%m-%d")
                    / now.strftime("%H%M%S"))
        self.ckpt_dir = self.dir / "ckpts"
        self.eval_dir = self.dir / "eval"
        self.log_dir = self.dir / "logs"
        for d in (self.ckpt_dir, self.eval_dir, self.log_dir):
            d.mkdir(parents=True, exist_ok=True)
        self._scalars_file = open(self.dir / "scalars.jsonl", "a")
        self.tb = None
        if use_tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter
                self.tb = SummaryWriter(log_dir=str(self.log_dir))
            except Exception:
                self.tb = None

    def log_scalars(self, step: int, scalars: Dict[str, float]):
        rec = {"step": step, **{k: float(v) for k, v in scalars.items()}}
        self._scalars_file.write(json.dumps(rec) + "\n")
        self._scalars_file.flush()
        if self.tb is not None:
            for k, v in scalars.items():
                self.tb.add_scalar(k, float(v), step)

    def log_image(self, step: int, name: str, img: np.ndarray) -> str:
        """img [H, W, 3] float in [0, 1] -> eval/<name>_<step>.png."""
        path = self.eval_dir / f"{name.replace('/', '_')}_{step:06d}.png"
        write_png(path, img)
        if self.tb is not None:
            self.tb.add_image(name, np.moveaxis(np.clip(img, 0, 1), -1, 0),
                              step)
        return str(path)

    def log_video(self, step: int, name: str, frames: np.ndarray,
                  fps: int = 15, fmt: str = "mp4") -> str:
        """frames [T, H, W, 3] float in [0, 1] -> eval/<name>_<step>.mp4
        (a gif where ffmpeg is missing) with imageio, or PNG frames under
        eval/<last part of name>_<step>/ without it."""
        u8 = _to_u8(frames)
        safe = name.replace("/", "_")
        try:
            import imageio.v2 as imageio
        except ImportError:
            d = self.eval_dir / f"{name.split('/')[-1]}_{step:06d}"
            d.mkdir(parents=True, exist_ok=True)
            for i, frame in enumerate(u8):
                write_png(d / f"frame_{i:04d}.png", frame)
            print(f"eval video step {step}: imageio is not installed, "
                  f"{len(u8)} PNG frames written to {d}", flush=True)
            return str(d)
        path = self.eval_dir / f"{safe}_{step:06d}.{fmt}"
        try:
            if fmt == "gif":
                imageio.mimwrite(path, u8, duration=1000.0 / fps, loop=0)
            else:
                imageio.mimwrite(path, u8, fps=fps)
        except Exception:
            path = self.eval_dir / f"{safe}_{step:06d}.gif"
            imageio.mimwrite(path, u8, duration=1000.0 / fps, loop=0)
        print(f"eval video step {step}: {path}", flush=True)
        return str(path)

    def save_config(self, blob: Dict):
        (self.dir / "config.json").write_text(
            json.dumps(blob, indent=2, default=str))

    def snapshot_code(self, repo_root=".") -> Optional[str]:
        """Archive the git-tracked sources into the run dir; where
        ``repo_root`` is no git checkout, write why instead."""
        try:
            files = subprocess.run(
                ["git", "ls-files"], cwd=repo_root, check=True,
                capture_output=True, text=True).stdout.splitlines()
            out = self.dir / "code_snapshot.tar.gz"
            with tarfile.open(out, "w:gz") as t:
                for f in files:
                    p = Path(repo_root) / f
                    if p.exists():
                        t.add(p, arcname=f)
            return str(out)
        except Exception as e:
            (self.dir / "code_snapshot_skipped.txt").write_text(str(e))
            return None

    def close(self):
        self._scalars_file.close()
        if self.tb is not None:
            self.tb.close()
