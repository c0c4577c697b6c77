"""Hyper-parameter sweep expansion + sequential runner.

The port's own copy of the JAX package's ``utils/sweep.py`` (reference
utils/sweep.py:57-117 + sweep.py in gsgen3d/gsgen): a sweep YAML maps
dotted config fields to value lists; ``joint_fields`` are zipped
together, everything else is crossed.  ``run_sweep`` runs configs one
after another on ``device`` (the card by default); ``run_sweep_scheduled``
runs each in a subprocess on a free slot, an environment overlay such as
``{"CUDA_VISIBLE_DEVICES": "0"}`` (the reference's free-GPU scheduler,
sweep.py:80-122).

Sweep YAML example:
    joint_fields: [trainer.max_steps, trainer.batch_size]
    trainer.max_steps: [100, 200]
    trainer.batch_size: [2, 4]
    init.num_points: [256, 1024]      # crossed -> 2 * 2 = 4 configs
"""

from __future__ import annotations

import copy
import itertools
from pathlib import Path
from typing import Dict, List, Optional

import yaml

from ..config import load_config, set_dotted


def generate_sweep_configs(base_config: str, sweep_spec: Dict,
                           out_dir: str = "sweep", base: int = 0
                           ) -> List[str]:
    """Expand a sweep spec over a base config into numbered YAML files."""
    cfg0 = load_config(base_config)
    spec = dict(sweep_spec)
    joint_fields = spec.pop("joint_fields", []) or []
    joint_lens = {len(spec[f]) for f in joint_fields}
    assert len(joint_lens) <= 1, "joint fields must have equal length"
    joint_len = joint_lens.pop() if joint_lens else 0
    cross_fields = [f for f in spec if f not in joint_fields]

    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    paths = []
    cnt = 0
    for cross_items in itertools.product(*[spec[f] for f in cross_fields]):
        base_cfg = copy.deepcopy(cfg0)
        for f, v in zip(cross_fields, cross_items):
            set_dotted(base_cfg, f, v)
        joint_iter = (zip(*[spec[f] for f in joint_fields])
                      if joint_len else [()])
        for joint_items in joint_iter:
            cfg = copy.deepcopy(base_cfg)
            for f, v in zip(joint_fields, joint_items):
                set_dotted(cfg, f, v)
            p = out / f"{cnt + base}.yaml"
            p.write_text(yaml.safe_dump(cfg))
            paths.append(str(p))
            cnt += 1
    return paths


def run_sweep(config_paths: List[str], steps: Optional[int] = None,
              log_root: str = "checkpoints/sweep", device="cuda"):
    """Run sweep configs sequentially on ``device``."""
    from ..config import build_trainer
    from ..io.logging import RunLogger
    results = []
    for p in config_paths:
        cfg = load_config(p)
        name = Path(p).stem
        logger = RunLogger(root=log_root, name=name)
        logger.save_config(cfg)
        trainer = build_trainer(cfg, device=device, logger=logger)
        trainer.fit(steps)
        results.append({"config": p, "run_dir": str(logger.dir)})
        logger.close()
    return results


def run_sweep_scheduled(config_paths: List[str],
                        slots: Optional[List[Dict[str, str]]] = None,
                        steps: Optional[int] = None,
                        log_root: str = "checkpoints/sweep",
                        poll_s: float = 5.0, device="cuda"):
    """Schedule sweep configs onto device SLOTS as subprocesses — the
    reference's free-GPU scheduler (sweep.py:80-122: nvitop polling +
    CUDA_VISIBLE_DEVICES): each slot is an env overlay naming a card
    (e.g. ``{"CUDA_VISIBLE_DEVICES": "0"}``); a config launches whenever
    a slot frees up and runs :func:`run_sweep` on ``device``.  With one
    slot it is the sequential runner, one subprocess a config.

    Returns [{config, returncode}].
    """
    import os
    import subprocess
    import sys
    import time

    slots = slots or [{}]
    pending = list(config_paths)
    running: List[tuple] = []        # (proc, slot, cfg_path)
    results = []
    while pending or running:
        # reap
        still = []
        for proc, slot, cfg_path in running:
            rc = proc.poll()
            if rc is None:
                still.append((proc, slot, cfg_path))
            else:
                results.append({"config": cfg_path, "returncode": rc})
        running = still
        # launch
        busy = {id(s) for _, s, _ in running}
        for slot in slots:
            if not pending or id(slot) in busy:
                continue
            cfg_path = pending.pop(0)
            env = dict(os.environ)
            env.update(slot)
            code = (
                "from gsgen_torch.utils.sweep import run_sweep; "
                f"run_sweep([{cfg_path!r}], steps={steps!r}, "
                f"log_root={log_root!r}, device={device!r})")
            proc = subprocess.Popen([sys.executable, "-c", code], env=env)
            running.append((proc, slot, cfg_path))
            busy.add(id(slot))
        if running:
            time.sleep(poll_s)
    return results
