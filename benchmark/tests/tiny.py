"""A tiny cell for the CPU tests: the TINY UNet and VAE presets, 64
Gaussians, two 16^2 views, written with its own BENCHMARK.json under a
temporary root (the repo's ``configs/`` and the benchmark's metric
readers linked in)."""

from __future__ import annotations

import json
import os
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]

TINY_UNET = {
    "attention_head_dim": [2, 2], "block_out_channels": [32, 64],
    "cross_attention_dim": 1024,
    "down_block_types": ["CrossAttnDownBlock2D", "CrossAttnDownBlock2D"],
    "up_block_types": ["CrossAttnUpBlock2D", "CrossAttnUpBlock2D"],
    "flip_sin_to_cos": True, "freq_shift": 0, "in_channels": 4,
    "out_channels": 4, "layers_per_block": 1, "norm_num_groups": 32,
    "sample_size": 8, "use_linear_projection": True}
TINY_VAE = {"block_out_channels": [32, 64], "in_channels": 3,
            "out_channels": 3, "latent_channels": 4, "layers_per_block": 1,
            "norm_num_groups": 32, "scaling_factor": 0.18215}
# the tiny cells' limits, between their program's readings and those of
# the controls and the faults on the CPU (test_bench_control.py): the
# stage numbers at lower x (upper / lower)^0.6 of seeds 2^31 + 5, 17, 99
LIMITS = {"sds": {"loss_gap": 0.03, "grad_gap": 0.1, "change_gap": 0.05,
                  "eps_gap": 0.045, "latent_gap": 0.03},
          "vsd": {"loss_gap": 0.05, "grad_gap": 0.05, "change_gap": 0.05,
                  "grad_gap_median": 0.005, "eps_gap": 1e-4,
                  "latent_gap": 0.03}}
# the controls: the cell's own (every network one precision below the
# stated one) and each network alone a step lower, the other exact
CONTROLS = {"sds": {"control": {"unet": "int8", "vae": "int8"},
                    "unet=fp8": {"unet": "fp8"}, "vae=fp8": {"vae": "fp8"}},
            "vsd": {"control": {"unet": "tf32", "vae": "int8"},
                    "unet=tf32": {"unet": "tf32"},
                    "vae=fp8": {"vae": "fp8"}, "vae=int8": {"vae": "int8"}}}
OVERRIDES = ["init.num_points=64", "init.capacity=128", "data.reso=[16]",
             "renderer.tile_size=8", "renderer.chunk=128",
             "renderer.dup_cap=4096", "trainer.batch_size=2"]


def traffic(kind: str) -> dict:
    vsd = kind == "vsd"
    return {
        "kind": "sd", "guidance": kind, "why": "CPU test",
        "port_configs": ["configs/base.yaml",
                         f"configs/guidance/{'vsd' if vsd else 'sd'}.yaml",
                         f"configs/prompt/{'vsd' if vsd else 'sd'}.yaml"],
        "overrides": OVERRIDES,
        "precision": {"unet": "float32" if vsd else "bfloat16",
                      "vae": "bfloat16"},
        "unet_passes": ([{"batch": 4}, {"batch": 4, "lora": True},
                         {"batch": 2, "grad": True, "lora": True}]
                        if vsd else [{"batch": 4}]),
        "check_steps": 3, "warm_steps": 1, "trace_steps": 2}


def write_root(root: Path, kind: str, limits: dict = None) -> str:
    """A benchmark root with one tiny cell of guidance ``kind``; returns
    the cell's name."""
    name = f"{kind}-tiny"
    b = root / "benchmark"
    for sub in ("configs", "traffic", "workloads"):
        (b / sub).mkdir(parents=True, exist_ok=True)
    if not (root / "configs").exists():
        os.symlink(REPO / "configs", root / "configs")
    if not (b / "metrics").exists():
        os.symlink(REPO / "benchmark" / "metrics", b / "metrics")
    (b / "configs" / "tiny.json").write_text(json.dumps(
        {"port_preset": "tiny", "unet": TINY_UNET, "vae": TINY_VAE}))
    (b / "traffic" / f"{kind}-16.json").write_text(json.dumps(traffic(kind)))
    (b / "workloads" / f"{name}.json").write_text(json.dumps(
        {"limits": limits or LIMITS[kind]}))
    man = {"command": ["python3", "-m", "benchmark.run"],
           "paths": ["benchmark"], "run_seconds": 1,
           "configs": [{"name": "tiny", "source": "test",
                        "file": "benchmark/configs/tiny.json",
                        "reduced": [], "why": "test"}],
           "workloads": [{"name": name, "config": "tiny",
                          "traffic": f"{kind}-16", "chips": 1,
                          "why": "test"}],
           "end_to_end": [
               {"name": f"step_ms.{kind}", "unit": "ms", "better": "lower",
                "bound": 0.05, "source": "host_clock"},
               {"name": "setup_s", "unit": "s", "better": "lower",
                "bound": 0.25, "source": "host_clock"}],
           "per_layer": []}
    (root / "BENCHMARK.json").write_text(json.dumps(man))
    return name
