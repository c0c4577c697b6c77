r"""CLI entry point: train a text-to-3D Gaussian scene with the port.

    python -m gsgen_torch.main --config configs/base.yaml --steps 5
    python -m gsgen_torch.main --config configs/base.yaml \
        guidance.backbone=sd_unet guidance.backbone_preset=sd21 \
        guidance.backbone_dtype=bfloat16 --steps 3
    python -m gsgen_torch.main --config configs/base.yaml \
        --config configs/guidance/vsd.yaml --config configs/prompt/vsd.yaml \
        --steps 3
    python -m gsgen_torch.main --config configs/base.yaml ckpt=path/to/step_N

The first runs SDS on MockUNet, the second SDS on the SD 2.1 UNet and
VAE with random weights (no weights are in the repository yet), the
third VSD (LoRA and camera conditioning on the SD 2.1 UNet): several
``--config`` files merge in order, as an ``include:`` list does.
``ckpt=`` resumes from a checkpoint directory of the JAX package
(``arrays.npz``).  Runs on the card unless ``--device cpu`` is given.

The port trains only.  A config that enables the upsample fine-tune
(``upsample_tune.enabled``, as ``configs/flagship_rehearsal.yaml`` does)
raises before any step (ROADMAP Queue 1 item 2).  Every run prints one
line naming the outputs that the JAX package's ``main.py`` writes and the
port does not yet: run directory and logs, checkpoints, the
``export.types`` exports, eval images and video (ROADMAP Queue 1 item 1).
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np


def skipped_outputs(tcfg, export_types) -> str:
    """The line naming what the JAX package's ``main.py`` would write under
    the trainer config ``tcfg`` and ``export.types`` and the port does not
    write yet; an output whose period is 0 is off there and left out."""
    parts = ["run directory and logs", "the final checkpoint"]
    if tcfg.save_period:
        parts.append(f"checkpoints every {tcfg.save_period} steps")
    if export_types:
        parts.append("exports " + ", ".join(export_types))
    for name, period in (("eval images", tcfg.eval_image_period),
                         ("eval video", tcfg.eval_video_period),
                         ("guidance samples", tcfg.guidance_eval_period)):
        if period:
            parts.append(f"{name} every {period} steps")
    return ("not written (ROADMAP Queue 1 item 1; the JAX package's main.py "
            "writes them): " + ", ".join(parts))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", action="append",
                    help="config file; repeat to merge overlays in order "
                         "(default: configs/base.yaml)")
    ap.add_argument("--steps", type=int, default=None,
                    help="number of steps to run (default: to max_steps)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("overrides", nargs="*",
                    help="dotted config overrides, e.g. trainer.max_steps=100")
    args = ap.parse_intermixed_args(argv)

    from .config import build_trainer, load_config
    from .training.trainer import train_state_from_jax_arrays

    overrides = [o for o in args.overrides if "=" in o]
    ckpt = None
    for o in list(overrides):
        if o.startswith("ckpt="):
            ckpt = Path(o.split("=", 1)[1])
            overrides.remove(o)
    cfg = load_config(args.config or ["configs/base.yaml"], overrides)
    if (cfg.get("upsample_tune") or {}).get("enabled"):
        raise NotImplementedError(
            "upsample_tune.enabled: the upsample fine-tune after training "
            "is not ported yet (ROADMAP Queue 1 item 2)")
    trainer = build_trainer(cfg, device=args.device)
    print(skipped_outputs(trainer.cfg, (cfg.get("export") or {}).get(
        "types", ["ply", "splat"])), flush=True)
    if ckpt is not None:
        with np.load(ckpt / "arrays.npz") as data:
            trainer.state = train_state_from_jax_arrays(dict(data),
                                                        trainer.device)
        print(f"resumed from {ckpt} at step {trainer.state.step}")

    def cb(step, metrics):
        events = {k: v for k, v in metrics.items() if k.startswith("num_")}
        if events:
            live = int(trainer.state.scene.active.sum())
            print(f"step {step:6d} | density {events} | live {live}",
                  flush=True)
        if step % trainer.cfg.log_period == 0 or args.steps is not None:
            print(f"step {step:6d} | loss {float(metrics['loss_total']):.6f}"
                  f" | n_dup {int(metrics['n_dup_max'])}", flush=True)

    trainer.fit(args.steps, callback=cb)
    return 0


if __name__ == "__main__":
    sys.exit(main())
