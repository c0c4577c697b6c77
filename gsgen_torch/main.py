r"""CLI entry point: train a text-to-3D Gaussian scene with the port.

    python -m gsgen_torch.main --config configs/base.yaml --steps 5
    python -m gsgen_torch.main --config configs/base.yaml \
        guidance.backbone=sd_unet guidance.backbone_preset=sd21 \
        guidance.backbone_dtype=bfloat16 --steps 3
    python -m gsgen_torch.main --config configs/base.yaml \
        --config configs/guidance/vsd.yaml --config configs/prompt/vsd.yaml \
        --steps 3
    python -m gsgen_torch.main --config configs/flagship_rehearsal.yaml \
        --steps 3
    python -m gsgen_torch.main --config configs/base.yaml ckpt=path/to/step_N
    python -m gsgen_torch.main --config configs/flagship_rehearsal.yaml \
        --tune-only ckpt=path/to/ckpts

The first runs SDS on MockUNet, the second SDS on the SD 2.1 UNet and
VAE with random weights (no weights are in the repository yet), the
third VSD (LoRA and camera conditioning on the SD 2.1 UNet): several
``--config`` files merge in order, as an ``include:`` list does.  The
flagship rehearsal also runs the upsample fine-tune after training and
exports ply, splat and mesh.  ``ckpt=`` resumes from a checkpoint of
either package (a ``step_N`` directory, or a ``ckpts`` directory whose
latest step is taken); ``--tune-only`` then runs only the fine-tune.
Runs on the card unless ``--device cpu`` is given.

As the JAX package's ``main.py`` does, a run writes, unless ``--no-log``,
a run directory ``<log root>/<prompt>/<date>/<time>/`` with
``config.json``, the code snapshot, ``scalars.jsonl``, eval images and
orbit videos and periodic checkpoints (the trainer's periods), then the
final checkpoint and the ``export.types`` exports (default ply and splat)
under ``exports/``.  One printed line names what the JAX trainer would
also write and the port does not yet: guidance samples and the profiler
trace.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
from typing import Optional


def skipped_outputs(tcfg, has_sampler: bool) -> Optional[str]:
    """The line naming what the JAX trainer writes under the trainer
    config ``tcfg`` and the port does not yet (guidance samples, where the
    guidance has a sampler there; the trace of ``profile_steps``), or None;
    an output whose period is 0 is off there and left out."""
    parts = []
    if tcfg.guidance_eval_period and has_sampler:
        parts.append(f"guidance samples every {tcfg.guidance_eval_period} "
                     "steps (ROADMAP Queue 1 item 5)")
    if tcfg.profile_steps is not None:
        parts.append(f"the profiler trace of steps {list(tcfg.profile_steps)}")
    if not parts:
        return None
    return ("not written (the JAX package's trainer writes them): "
            + ", ".join(parts))


def export_assets(trainer, types, base) -> None:
    """Write ``scene.<type>`` (``obj`` for mesh) for each export type."""
    from .io import export as ex
    scene = trainer.state.scene
    base.mkdir(parents=True, exist_ok=True)
    for t in types:
        path = base / f"scene.{t if t != 'mesh' else 'obj'}"
        if t == "ply":
            ex.to_ply(scene.params, scene.active, path)
        elif t == "splat":
            ex.to_splat(scene.params, scene.active, path, trainer.rcfg)
        elif t == "mesh":
            ex.to_mesh(scene.params, scene.active, trainer.rcfg, path)
        else:
            raise ValueError(f"export type {t!r}: ply, splat or mesh")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", action="append",
                    help="config file; repeat to merge overlays in order "
                         "(default: configs/base.yaml)")
    ap.add_argument("--no-log", action="store_true",
                    help="write no run directory, checkpoint or export")
    ap.add_argument("--log-root", default="checkpoints",
                    help="where run directories go (default: checkpoints)")
    ap.add_argument("--steps", type=int, default=None,
                    help="number of steps to run (default: to max_steps)")
    ap.add_argument("--tune-only", action="store_true",
                    help="skip training; run only the upsample fine-tune "
                         "(with ckpt=)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("overrides", nargs="*",
                    help="dotted config overrides, e.g. trainer.max_steps=100")
    args = ap.parse_intermixed_args(argv)

    from .config import build_trainer, load_config
    from .io.checkpoint import save_checkpoint
    from .io.logging import RunLogger

    overrides = [o for o in args.overrides if "=" in o]
    ckpt = None
    for o in list(overrides):
        if o.startswith("ckpt="):
            ckpt = o.split("=", 1)[1]
            overrides.remove(o)
    cfg = load_config(args.config or ["configs/base.yaml"], overrides)
    name = cfg.get("prompt", {}).get("prompt", "run")

    logger = None
    if not args.no_log:
        logger = RunLogger(root=args.log_root, name=name)
        logger.save_config(cfg)
        logger.snapshot_code()
        print(f"run dir: {logger.dir}", flush=True)

    trainer = build_trainer(cfg, device=args.device, logger=logger)
    line = skipped_outputs(trainer.cfg, trainer.prompt_processor is not None)
    if line:
        print(line, flush=True)
    if ckpt:
        step = trainer.load(ckpt)
        print(f"resumed from {ckpt} at step {step}", flush=True)

    def cb(step, metrics):
        events = {k: v for k, v in metrics.items() if k.startswith("num_")}
        if events:
            live = int(trainer.state.scene.active.sum())
            print(f"step {step:6d} | density {events} | live {live}",
                  flush=True)
        if step % trainer.cfg.log_period == 0 or args.steps is not None:
            print(f"step {step:6d} | loss {float(metrics['loss_total']):.6f}"
                  f" | n_dup {int(metrics['n_dup_max'])}", flush=True)

    up_d = dict(cfg.get("upsample_tune") or {})
    tune_enabled = up_d.pop("enabled", False)
    if not (tune_enabled and args.tune_only):
        trainer.fit(args.steps, callback=cb)

    if tune_enabled:
        from .training.upsample import UpsampleTuneConfig, tune_with_upsample
        known = {f.name for f in dataclasses.fields(UpsampleTuneConfig)}
        ucfg = UpsampleTuneConfig(
            **{k: v for k, v in up_d.items() if k in known})
        print(f"upsample fine-tune: {ucfg.num_poses} poses, {ucfg.epoch} "
              f"epochs at {ucfg.reso}^2", flush=True)
        losses = tune_with_upsample(trainer, ucfg,
                                    cache_uid=name.replace(" ", "_"))
        if losses:
            print(f"upsample fine-tune: loss {losses[0]:.6f} -> "
                  f"{losses[-1]:.6f} in {len(losses)} steps", flush=True)

    if logger is not None:
        step_final = int(trainer.state.step)
        save_checkpoint(logger.ckpt_dir, step_final, trainer.state,
                        seed=trainer.cfg.seed)
        exp = cfg.get("export") or {}
        types = exp.get("types", ["ply", "splat"])
        if types:
            base = logger.dir / "exports"
            export_assets(trainer, types, base)
            print(f"exports: {base}", flush=True)
        logger.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
