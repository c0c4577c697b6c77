#!/usr/bin/env python3
"""Smoke test of the PyTorch port (gsgen_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each reported on its own line:

1. device: require CUDA, print the card's name and power limit, TF32 off
   (the package's precision policy, utils/precision.py::exact_fp32);
2. build: compile gsgen_torch/csrc/*.cu with nvcc for sm_90a; the raster
   kernels' ptxas lines (registers, shared memory, spills: none allowed);
3. kernels: every kernel of the render path against its plain PyTorch
   version on the card, at a small size, at the bench workload (100K
   Gaussians, 512^2, dup_cap 2^18, chunk 128), at configs/base.yaml's
   render (chunk 256, dup_cap 2^20) and on an opaque early-exit scene,
   with feature widths F=3 and F=5, and F=10 at both render shapes (the
   bench's tiles walk 3+ windows: the stage ring wraps); plus a full
   small render against the dense oracle; the same scenes but 1024^2 in
   the compact layout: its
   BinnedTiles bit-exact against the plain binning, K8 and K9 against
   their plain versions (window counts exact), K8's image and T against
   K1's, with the empty tiles of unaligned start and the windows shared
   by two tiles counted;
   Phase 3 also holds K5 (flash self-attention forward) against its plain
   version at SD 2.1's level 0 [8, 4096, 5, 64] in bf16 and fp32, SD
   1.5's level 0 [8, 4096, 8, 40] in bf16, a small [2, 256, 2, 64] in
   fp32, and in bf16 [1, 4096, 2, 64] (the whole TMA ring on few CTAs),
   [2, 128, 3, 40] (one tile, TMA zero fill past D) and [2, 256, 2, 160]
   (the mma.sync instance); and K5's lse, K6 (dK, dV) and K7 (dQ) against
   the plain backward at the VSD path's [4, 4096, 5, 64] in fp32 and
   bf16 (K7 fp32 there also within 1e-5 of max|dq|), a small
   [2, 256, 2, 64] in fp32, [1, 4096, 2, 64] and [2, 256, 2, 160] in bf16,
   [2, 128, 3, 40] in bf16 (one tile, TMA zero fill) and [2, 256, 2, 160]
   in fp32, each error also as a share of the gradient's max, and
   autograd through K5 + K6 + K7 against autograd through the plain path;
4. train: configs/base.yaml with guidance.type=mock, 5 training steps at
   full width through build_trainer / fit, with every kernel's launch
   counter read around the run;
5. times: each kernel, its plain version and, where one exists, one
   PyTorch call computing the same function, at the bench and base.yaml
   shapes (K5 at SD 2.1's level 0, SDPA its library yardstick; K6 and K7
   at [4, 4096, 5, 64] in fp32 and bf16, SDPA's backward theirs, each
   also in device time; SDPA in fp32 beside K5's fp32 instance at B=8 and
   B=4), K1-K4, K8, K9 and torch.searchsorted by device time (a CUDA
   graph of 50 calls replayed between two events) beside their host-loop
   times, the lanes each tile's forward walked (max, mean) at both render
   shapes, and the full render forward+backward in both layouts; one
   line gives every K5/K6/K7 instance's ms, TFLOP/s, share of its bound and
   SDPA's time, with the bound at the rate its design can reach (bf16
   989 TFLOP/s; fp32 3xTF32 3 x ops / 495 TFLOP/s);
6. profile: two more training steps under torch.profiler; device busy
   time, idle share and the top device kernels per step (the trace goes
   to gsgen_torch/_build/train_step_trace.json);
7. sds: the slice, configs/base.yaml with SDS on the SD 2.1 UNet and VAE
   in bf16 (random weights, mock prompt embeddings) for 3 steps at 512^2,
   batch 4, with K1-K5's launch counters read around the run; first the
   SDS loss and its render gradient on a TINY backbone on the card
   against the same on the CPU; then 2 steps each of configs/base.yaml
   as it is (SDS on MockUNet) and configs/flagship_rehearsal.yaml;
8. sds profile: one slice step under torch.profiler, device time split
   into render, VAE and UNet (trace: gsgen_torch/_build/sds_step_trace.json);
9. vsd: the VSD losses and the gradients of the render and of every
   trainable leaf on a TINY_VSD backbone (L = 256, fused attention on) on
   the card against the CPU; then 3 steps of configs/base.yaml +
   guidance/vsd.yaml + prompt/vsd.yaml (SD 2.1 UNet in fp32 with LoRA and
   camera conditioning, VAE in bf16, 512^2, batch 4) with every launch
   counter read around them (15 K5, 5 K6, 5 K7 a step) and a LoRA leaf
   required to move; then one VSD step under torch.profiler, device time
   split into render, VAE, UNet forward and UNet backward (trace:
   gsgen_torch/_build/vsd_step_trace.json);
10. density: 3 SDS steps of the slice config in the compact layout
   (renderer.binning_layout=compact: K8, K9 and K3 once per view, K1, K2,
   K4 never), one of them profiled as in phase 8; 6 steps of
   configs/base.yaml + renderer/regular.yaml
   (compact, mock guidance) with a densify event at step 3 and a prune
   event at step 5 (overrides in DENSITY): the live count rises, then
   falls, and the Adam moments of new and freed slots are 0; the next
   view of that scene through kernel_checks in both layouts; one
   densify_compactness event at capacity 65,536 with its peak memory;

11. outputs: ``gsgen_torch.main`` on configs/flagship_rehearsal.yaml for
   3 steps (eval image every step, orbit video and checkpoint at step 2)
   into a temporary log root: the upsample fine-tune as the config sets
   it (32 poses, 4 epochs at 256^2) with K1-K4's counters read around it
   (once per view: 64^2 renders forward, 256^2 steps forward and
   backward), ply / splat / mesh, each output's seconds and bytes, and
   the final checkpoint loaded into a fresh trainer, every array equal.
   Phase 3 also holds K3 bitwise on count patterns the renders do not
   reach (total 0, total past cap, N 1, zero-count runs, ragged cap) and
   phase 5 prints K3 (render shapes and edge cases), torch.searchsorted
   and a one-element add (the floor that launch spacing sets) in device
   time;

then one JSON line with the kernels, the card line, and the result line.
Exits non-zero before the result line if any phase fails.
"""

from __future__ import annotations

import dataclasses
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

PEAK_FLOPS = 67e12      # H100 SXM fp32 outside the tensor cores
PEAK_BF16_FLOPS = 989e12  # H100 SXM bf16 dense tensor cores
# K5-K7 in fp32 run 3xTF32: three TF32 tensor-core products per product,
# so the rate that design can reach is 495 / 3 TFLOP/s of fp32 work
PEAK_3XTF32_FLOPS = 495e12 / 3
PEAK_BYTES = 3.35e12    # H100 SXM HBM3
# K5 (and its lse) against its plain version: max abs error over max
# |plain output|; K6 / K7: the same over each gradient's max |plain|
FLASH_TOL = {"bfloat16": 2e-2, "float32": 1e-4}
FLASH_BWD_TOL = {"bfloat16": 3e-2, "float32": 1e-4}
# K7 fp32 (3xTF32) at the VSD path's shape: within this share of max|dq|
K7_FP32_VSD_TOL = 1e-5
SD21_ATTN = (8, 4096, 5, 64)    # SD 2.1 level-0 self-attention [B, L, H, D]
VSD_ATTN = (4, 4096, 5, 64)     # the same under VSD's LoRA pass (batch 4)
SLICE = ["guidance.backbone=sd_unet", "guidance.backbone_preset=sd21",
         "guidance.backbone_dtype=bfloat16"]
VSD_CONFIGS = ["base.yaml", "guidance/vsd.yaml", "prompt/vsd.yaml"]
VSD_FLASH = dict(flash_attn_fwd=15, flash_attn_bwd_dkv=5, flash_attn_bwd_dq=5)
LIB_FLASH = "jax/experimental/pallas/ops/tpu/flash_attention.py"
COMPACT = ["renderer.binning_layout=compact"]
# base.yaml + renderer/regular.yaml on mock guidance, with a densify event
# at step 3 and a prune event at step 5: every live Gaussian that got any
# gradient is a densify candidate (mean2d_thresh 1e-9), and one whose
# largest screen radius (camera-plane units) passed 3e-5, about the median
# after the densify, is pruned
DENSITY_CONFIGS = ["base.yaml", "renderer/regular.yaml"]
DENSITY = ["guidance.type=mock", *COMPACT, "renderer.densify.warm_up=3",
           "renderer.densify.period=3", "renderer.densify.mean2d_thresh=1.0e-9",
           "renderer.prune.warm_up=5", "renderer.prune.period=5",
           "renderer.prune.radii2d_thresh=3.0e-5"]
SMALL_TOL = dict(T=(1e-5, 1e-6), img=(1e-4, 1e-5), grad=(2e-3, 2e-4))
SCALE_TOL = dict(T=(1e-3, 3e-4), img=(2e-3, 5e-4), grad=(5e-3, 2e-3))


class SmokeFailure(Exception):
    pass


def require(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def call_line(rel_file: str, func: str, needle: str) -> str:
    """'line' of the first line holding ``needle`` after ``def func(`` in
    the JAX package's ``rel_file``, read as text."""
    start = int(reference_line(rel_file, func).rsplit(":", 1)[1])
    path = ROOT / reference_line(rel_file, func).rsplit(":", 1)[0]
    for i, line in enumerate(path.read_text().splitlines(), 1):
        if i > start and needle in line:
            return str(i)
    raise SmokeFailure(f"{needle!r} not found after {func} in {path}")


def reference_line(rel_file: str, func: str) -> str:
    """'path:line' of a TPU kernel in the JAX package, read as text."""
    hits = sorted(p for p in ROOT.glob(f"*/{rel_file}")
                  if p.parent.parent.name != "gsgen_torch")
    require(hits, f"reference kernel file {rel_file} not found")
    for i, line in enumerate(hits[0].read_text().splitlines(), 1):
        if line.startswith(f"def {func}("):
            return f"{hits[0].relative_to(ROOT)}:{i}"
    raise SmokeFailure(f"{func} not found in {hits[0]}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is false", flush=True)
        return 1
    if not (ROOT / "gsgen_torch" / "csrc").is_dir():
        print("FAIL: the gsgen_torch package is not beside chip_smoke.py",
              flush=True)
        return 1
    sys.path.insert(0, str(ROOT))
    try:
        return run(torch)
    except SmokeFailure as e:
        print(f"FAIL: {e}", flush=True)
        return 1


def run(torch) -> int:
    from gsgen_torch.config import build_trainer, load_config
    from gsgen_torch.models.init import InitConfig, initialize
    from gsgen_torch.models.scene import (RenderConfig, activate,
                                          render_view)
    from gsgen_torch.ops import (binning, cuda_lib, cuda_raster,
                                 expansion_rank, flash_attention,
                                 gid_repack)
    from gsgen_torch.ops.camera import (CameraIntrinsics, get_frustum,
                                        sphere_in_frustum)
    from gsgen_torch.ops.oracle import composite_dense, pixel_grid
    from gsgen_torch.ops.projection import (conic_from_cov2d,
                                            project_gaussians)
    from gsgen_torch.ops.rasterize import (ch_out_for, chunk_weights,
                                           make_geom, tile_pixels)
    from gsgen_torch.utils.precision import exact_fp32

    dev = torch.device("cuda")

    # ---- phase 1: device ----
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else \
        "nvidia-smi gave no answer"
    exact_fp32()
    name = torch.cuda.get_device_name(0)
    print(f"phase 1 device: ok {name} x{torch.cuda.device_count()} "
          f"| nvidia-smi: {card}", flush=True)

    # ---- phase 2: build ----
    t0 = time.perf_counter()
    cuda_lib.build(force=True)
    cuda_lib.lib()
    build_s = time.perf_counter() - t0
    regs = [ln.strip() for ln in cuda_lib.build_info["log"].splitlines()
            if "registers" in ln]
    # ptxas names each function before its stack / spill line
    spills, func = [], ""
    for ln in cuda_lib.build_info["log"].splitlines():
        if "Function properties for" in ln:
            func = ln.split(" for ", 1)[1].strip()
        elif "spill stores" in ln and \
                ", 0 bytes spill stores, 0 bytes spill loads" not in ln:
            spills.append(f"{func}: {ln.strip()}")
    print(f"phase 2 build: ok {build_s:.2f} s, "
          f"{len(cuda_lib.sources())} sources | spills: "
          + ("; ".join(spills) or "none") + " | " + " ; ".join(regs),
          flush=True)
    raster_ptxas = ptxas_lines(cuda_lib.build_info["log"], "raster_")
    require(len(raster_ptxas) == 2, f"ptxas names {len(raster_ptxas)} "
            "raster kernels, expected 2")
    require(not [f for f in spills if "raster_" in f],
            f"a raster kernel spills: {spills}")
    print("phase 2 raster: ok | " + " | ".join(
        f"{k}: {v}" for k, v in raster_ptxas.items()), flush=True)

    # ---- helpers ----
    gen = torch.Generator(device=dev)

    def prepare(params, active, c2w, intr, rcfg, rgb_only, F10=False):
        """render_view's steps up to the rasterizer (no autograd); F10:
        ten feature channels (colour, depth, depth^2, colour^2, sqrt depth,
        alpha) instead of 3 or 5."""
        with torch.no_grad():
            c2w = torch.as_tensor(c2w, dtype=torch.float32, device=dev)
            f32 = lambda v: torch.tensor(v, dtype=torch.float32,  # noqa
                                         device=dev)
            fx, fy, cx, cy = map(f32, (intr.fx, intr.fy, intr.cx, intr.cy))
            mean, qvec, svec, color, alpha = activate(params, rcfg)
            normals, pts = get_frustum(c2w, intr)
            cull = sphere_in_frustum(
                mean, torch.amax(svec, -1) * rcfg.frustum_culling_radius,
                normals, pts)
            proj = project_gaussians(mean, qvec, svec, c2w, near=rcfg.near)
            vis = active & cull & proj.in_front
            conic, _ = conic_from_cov2d(proj.cov2d)
            ntiles = (-(-intr.w // rcfg.tile_size)) ** 2
            pad = int(ntiles * rcfg.chunk * rcfg.pad_frac + rcfg.chunk - 1
                      ) // rcfg.chunk * rcfg.chunk
            bin_args = (proj.mean2d, proj.cov2d, proj.depth, vis, fx, fy, cx,
                        cy, intr.w, intr.h, rcfg.tile_size, rcfg.dup_cap)
            bin_kw = dict(chunk=rcfg.chunk, alpha=alpha, pad_budget=pad,
                          tile_culling_radius=rcfg.tile_culling_radius)
            d = proj.depth[:, None]
            feats = color if rgb_only else torch.cat([color, d, d ** 2], -1)
            if F10:
                feats = torch.cat([color, d, d ** 2, color ** 2,
                                   d.abs().sqrt(), alpha[:, None]], -1)
            geom = make_geom((-cx / fx, -cy / fy), (1.0 / fx, 1.0 / fy), dev)
            return dict(bin_args=bin_args, bin_kw=bin_kw, mean2d=proj.mean2d,
                        conic=conic, alpha=alpha, feats=feats, geom=geom,
                        intr=intr, rcfg=rcfg)

    def plain_bins(*args, **kw):
        saved = binning.expansion_gid, binning.repack_gid
        binning.expansion_gid = expansion_rank.expansion_gid_plain
        binning.repack_gid = gid_repack.repack_gid_plain
        try:
            return binning.bin_gaussians(*args, **kw)
        finally:
            binning.expansion_gid, binning.repack_gid = saved

    def close(a, b, rtol, atol, what):
        err = (a - b).abs()
        bad = err > atol + rtol * b.abs()
        require(torch.isfinite(a).all(), f"{what}: non-finite kernel output")
        require(not bool(bad.any()),
                f"{what}: {int(bad.sum())} of {bad.numel()} values outside "
                f"rtol {rtol} atol {atol} (max abs err "
                f"{float(err.max()):.3e})")
        return float(err.max()) if err.numel() else 0.0

    errs = {k: 0.0 for k in ("raster_fwd", "raster_bwd", "expansion_rank",
                             "gid_repack", "flash_attn_fwd",
                             "flash_attn_bwd_dkv", "flash_attn_bwd_dq",
                             "raster_fwd_compact", "raster_bwd_compact")}
    notes = []

    def same_bins(label, bins, bins_p):
        """Every field the layout fills bit-exact; the others None."""
        for f in bins._fields:
            a, b = getattr(bins, f), getattr(bins_p, f)
            if a is None or b is None:
                require(a is None and b is None,
                        f"{label}: BinnedTiles.{f} set on one path only")
                continue
            require(a.dtype == b.dtype and torch.equal(a, b),
                    f"{label}: BinnedTiles.{f} differs from the plain path")

    def recorded_bins(prep):
        """Bin with the kernels, recording the inputs K3 and K4 get."""
        seen = {}
        saved = binning.expansion_gid, binning.repack_gid

        def rec(name, fn):
            def wrapped(*args):
                seen[name] = args
                return fn(*args)
            return wrapped

        binning.expansion_gid = rec("expansion_rank", saved[0])
        binning.repack_gid = rec("gid_repack", saved[1])
        try:
            with torch.no_grad():
                bins = binning.bin_gaussians(*prep["bin_args"],
                                             **prep["bin_kw"])
        finally:
            binning.expansion_gid, binning.repack_gid = saved
        return bins, seen

    def kernel_checks(label, prep, tol):
        """K3/K4 and every BinnedTiles field bit-exact; K1/K2 within tol."""
        bins, seen = recorded_bins(prep)
        with torch.no_grad():
            bins_p = plain_bins(*prep["bin_args"], **prep["bin_kw"])
        same_bins(label, bins, bins_p)
        require(torch.equal(expansion_rank.expansion_gid(*seen["expansion_rank"]),
                            expansion_rank.expansion_gid_plain(
                                *seen["expansion_rank"])),
                f"{label}: expansion_rank differs")
        require(torch.equal(gid_repack.repack_gid(*seen["gid_repack"]),
                            gid_repack.repack_gid_plain(*seen["gid_repack"])),
                f"{label}: gid_repack differs")
        rcfg, intr = prep["rcfg"], prep["intr"]
        K = rcfg.chunk
        F = prep["feats"].shape[-1]
        st = dict(n_tiles_w=-(-intr.w // rcfg.tile_size),
                  tile_size=rcfg.tile_size, chunk=K, F=F,
                  ch_out=ch_out_for(F), T_thresh=rcfg.T_thresh)
        dup = cuda_raster.pack_dup(prep["mean2d"], prep["conic"],
                                   prep["alpha"], prep["feats"],
                                   bins.padded_gid, bins.row_valid)
        nck = ((bins.ends - bins.starts + K - 1) // K).to(torch.int32)
        a = (bins.starts, bins.ends, nck, prep["geom"])
        out = cuda_raster.raster_fwd(dup, *a, **st)
        out_p = cuda_raster.raster_fwd_plain(dup, *a, **st)
        torch.cuda.synchronize()
        e1 = close(out[:, F], out_p[:, F], *tol["T"], f"{label}: K1 T")
        e2 = close(out[:, :F], out_p[:, :F], *tol["img"],
                   f"{label}: K1 features")
        cnt, cnt_p = out[:, -1, 0], out_p[:, -1, 0]
        require(torch.equal(cnt, cnt_p),
                f"{label}: K1 processed-chunk counts differ in "
                f"{int((cnt != cnt_p).sum())} tiles")
        errs["raster_fwd"] = max(errs["raster_fwd"], e1, e2)
        g = torch.randn(out.shape, generator=gen.manual_seed(7), device=dev)
        grad = cuda_raster.raster_bwd(dup, out, g, *a, **st)
        grad_p = cuda_raster.raster_bwd_plain(dup, out_p, g, *a, **st)
        torch.cuda.synchronize()
        rtol, atol = tol["grad"]
        for r in range(6 + F):
            scale = max(float(grad_p[r].abs().max()), 1e-3) \
                if tol is SCALE_TOL else 1.0
            e = close(grad[r], grad_p[r], rtol, atol * scale,
                      f"{label}: K2 grad row {r}")
            errs["raster_bwd"] = max(errs["raster_bwd"], e)
        exited = int((cnt < nck.float()).sum())
        notes.append(f"{label}: F={F} K={K} dups={int(bins.total)} "
                     f"chunks={int(cnt.sum())} (max {int(cnt.max())} a "
                     f"tile) early-exit tiles={exited}")
        return dict(bins=bins, dup=dup, nck=nck, st=st, out=out, g=g,
                    geom=prep["geom"], seen=seen)

    layout_stats = dict(empty_unaligned=0, shared_windows=0)

    def compact_checks(label, prep, tol, padded):
        """The compact layout on the scene of ``padded`` (kernel_checks'
        result): its BinnedTiles bit-exact against the plain binning, K8
        against its plain version (window counts exact), K9 against the
        plain gradient, and K8's image and T against K1's."""
        kw = dict(prep["bin_kw"], layout="compact")
        with torch.no_grad():
            bins = binning.bin_gaussians(*prep["bin_args"], **kw)
            bins_p = plain_bins(*prep["bin_args"], **kw)
        same_bins(f"{label} compact", bins, bins_p)
        st, g = padded["st"], padded["g"]
        F, K = st["F"], st["chunk"]
        dup = cuda_raster.pack_dup(
            prep["mean2d"], prep["conic"], prep["alpha"], prep["feats"],
            bins.gid_s, torch.ones_like(bins.gid_s, dtype=torch.bool))
        starts, ends = bins.starts, bins.ends
        wc = cuda_raster.window_counts(starts, ends, K)
        geom = prep["geom"]
        out = cuda_raster.raster_fwd_compact(dup, starts, ends, wc, geom,
                                             **st)
        out_p = cuda_raster.raster_fwd_plain(dup, starts, ends, wc, geom,
                                             **st)
        torch.cuda.synchronize()
        e1 = close(out[:, F], out_p[:, F], *tol["T"], f"{label}: K8 T")
        e2 = close(out[:, :F], out_p[:, :F], *tol["img"],
                   f"{label}: K8 features")
        cnt, cnt_p = out[:, -1, 0], out_p[:, -1, 0]
        require(torch.equal(cnt, cnt_p),
                f"{label}: K8 window counts differ in "
                f"{int((cnt != cnt_p).sum())} tiles")
        empty = (starts == ends) & (starts % K != 0)
        require(bool((cnt[empty] == 1).all()),
                f"{label}: an empty unaligned tile did not count 1 window")
        close(out[:, F], padded["out"][:, F], *tol["T"],
              f"{label}: K8 T vs K1 T")
        close(out[:, :F], padded["out"][:, :F], *tol["img"],
              f"{label}: K8 image vs K1 image")
        errs["raster_fwd_compact"] = max(errs["raster_fwd_compact"], e1, e2)
        grad = cuda_raster.raster_bwd_compact(dup, out, g, starts, ends, wc,
                                              geom, **st)
        grad_p = cuda_raster.raster_bwd_plain(dup, out_p, g, starts, ends,
                                              wc, geom, **st)
        torch.cuda.synchronize()
        rtol, atol = tol["grad"]
        for r in range(6 + F):
            scale = max(float(grad_p[r].abs().max()), 1e-3) \
                if tol is SCALE_TOL else 1.0
            e = close(grad[r], grad_p[r], rtol, atol * scale,
                      f"{label}: K9 grad row {r}")
            errs["raster_bwd_compact"] = max(errs["raster_bwd_compact"], e)
        n_empty = int(empty.sum())
        # a non-empty tile starting inside a window shares it with the
        # earlier tiles whose rows fill the window's first lanes
        n_shared = int(((starts % K != 0) & (ends > starts)).sum())
        layout_stats["empty_unaligned"] += n_empty
        layout_stats["shared_windows"] += n_shared
        notes.append(f"{label} compact: rows={int(bins.total)} "
                     f"windows={int(cnt.sum())} (padded chunks "
                     f"{int(padded['out'][:, -1, 0].sum())}) empty unaligned "
                     f"tiles={n_empty} shared windows={n_shared}")
        return dict(bins=bins, dup=dup, nck=wc, st=st, out=out, g=g,
                    geom=geom, seen=padded["seen"])

    def scene_3d(n, capacity, mean_std, svec, alpha_val, seed):
        cfg = InitConfig(num_points=n, capacity=capacity, mean_std=mean_std,
                         svec_val=svec, alpha_val=alpha_val)
        return initialize(cfg, RenderConfig(), gen.manual_seed(seed), dev)

    c2w_front = [[1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 1, -2.5]]

    # ---- phase 3: kernels vs plain versions ----
    # small: tests' sizes (RES 32, TILE 8, CHUNK 128) + a full render
    # against the dense oracle (culling radius 60: the alpha-aware AABB
    # then bins each Gaussian's exact support, so nothing is cut)
    rc_small = RenderConfig(tile_size=8, chunk=128, dup_cap=4096,
                            tile_culling_radius=60.0)
    s_small = scene_3d(200, 256, 0.5, 0.05, 0.6, 1)
    intr32 = CameraIntrinsics.from_reso(32)
    for F_rgb in (True, False):
        label = f"small F={3 if F_rgb else 5}"
        prep = prepare(s_small.params, s_small.active, c2w_front, intr32,
                       rc_small, F_rgb)
        compact_checks(label, prep, SMALL_TOL,
                       kernel_checks(label, prep, SMALL_TOL))
    out = render_view(s_small.params, s_small.active, c2w_front, intr32,
                      rc_small, torch.zeros(3, device=dev), rgb_only=True)
    prep = prepare(s_small.params, s_small.active, c2w_front, intr32,
                   rc_small, True)
    pix = pixel_grid(intr32.image_topleft, intr32.pixel_size, 32, 32,
                     device=dev)
    with torch.no_grad():
        ref, T_ref = composite_dense(
            prep["mean2d"], prep["conic"], prep["alpha"], prep["feats"],
            prep["bin_args"][2], prep["bin_args"][3], pix)
    close(out["T"].reshape(-1), T_ref, *SMALL_TOL["T"], "small render T")
    close(out["rgb"].reshape(-1, 3), ref, *SMALL_TOL["img"],
          "small render rgb vs dense oracle")

    # bench workload (the JAX package's bench.py): 100K Gaussians, 512^2
    rc_bench = RenderConfig(dup_cap=1 << 18, chunk=128)
    s_bench = scene_3d(100_000, None, 0.6, 0.01, 0.8, 0)
    intr512 = CameraIntrinsics.from_reso(512)
    bench, bench_c = {}, {}
    for rgb_only in (True, False):
        label = f"bench F={3 if rgb_only else 5}"
        prep = prepare(s_bench.params, s_bench.active, c2w_front, intr512,
                       rc_bench, rgb_only)
        bench[rgb_only] = kernel_checks(label, prep, SCALE_TOL)
        bench_c[rgb_only] = compact_checks(label, prep, SCALE_TOL,
                                           bench[rgb_only])

    # configs/base.yaml's render: its initial scene and first camera
    cfg_base = load_config(ROOT / "configs" / "base.yaml",
                           ["guidance.type=mock"])
    probe = build_trainer(cfg_base, device="cuda")
    cam = probe.data.get_batch()
    intr_b = probe.data.intrinsics()
    f_cam = float(cam["fx"][0])
    intr_view = CameraIntrinsics(fx=f_cam, fy=f_cam, cx=intr_b.cx,
                                 cy=intr_b.cy, w=intr_b.w, h=intr_b.h,
                                 near=intr_b.near, far=intr_b.far)
    base_view = (probe.state.scene, cam["c2w"][0], intr_view, probe.rcfg)
    prep = prepare(probe.state.scene.params, probe.state.scene.active,
                   cam["c2w"][0], intr_view, probe.rcfg, False)
    base = kernel_checks("base.yaml F=5", prep, SCALE_TOL)
    base_c = compact_checks("base.yaml F=5", prep, SCALE_TOL, base)
    # F = 10, the most feature rows the kernels take: at chunk 256 K2's
    # stages and lane sums pass 48 KB of shared memory
    prep = prepare(probe.state.scene.params, probe.state.scene.active,
                   cam["c2w"][0], intr_view, probe.rcfg, False, F10=True)
    compact_checks("base.yaml F=10", prep, SCALE_TOL,
                   kernel_checks("base.yaml F=10", prep, SCALE_TOL))
    del probe
    # and at the bench render, where tiles walk 3+ windows of 128 rows
    # (the stage ring wraps)
    prep = prepare(s_bench.params, s_bench.active, c2w_front, intr512,
                   rc_bench, False, F10=True)
    deep = kernel_checks("bench F=10", prep, SCALE_TOL)
    require(int(deep["out"][:, -1, 0].max()) >= 3,
            "bench F=10: no tile processed 3 windows")
    compact_checks("bench F=10", prep, SCALE_TOL, deep)
    del deep

    # opaque scene: tiles leave early, later chunks must stay zero
    s_opq = scene_3d(20_000, None, 0.5, 0.03, 0.999, 3)
    prep = prepare(s_opq.params, s_opq.active, c2w_front, intr512, rc_bench,
                   True)
    opq = kernel_checks("early-exit F=3", prep, SCALE_TOL)
    require(int((opq["out"][:, -1, 0] < opq["nck"].float()).sum()) > 0,
            "early-exit scene: no tile left early")
    opq_c = compact_checks("early-exit F=3", prep, SCALE_TOL, opq)
    require(int((opq_c["out"][:, -1, 0] < opq_c["nck"].float()).sum()) > 0,
            "early-exit scene: no tile left early in the compact layout")
    require(layout_stats["empty_unaligned"] > 0
            and layout_stats["shared_windows"] > 0,
            f"compact scenes lack an empty unaligned tile or a shared "
            f"window: {layout_stats}")
    notes.append(f"compact layout over the scenes above: {layout_stats}")

    # K3 where the merge's shares hold only cum entries, only slots, one
    # entry, runs of zero counts, or a ragged end (bitwise)
    k3_cases = k3_edge_cases(torch, dev, expansion_rank)
    notes.append("K3 edge cases bitwise equal: " + ", ".join(k3_cases))

    # 1024^2: where the TPU package switches to its streaming backward
    # (cotangents n_tiles * ch_out * P * 4 bytes > 9 MiB); one K2 serves both
    s_large = scene_3d(30_000, None, 0.6, 0.01, 0.8, 4)
    kernel_checks("1024^2 F=5",
                  prepare(s_large.params, s_large.active, c2w_front,
                          CameraIntrinsics.from_reso(1024),
                          RenderConfig(dup_cap=1 << 19, chunk=128), False),
                  SCALE_TOL)
    del s_large

    # K5: flash self-attention forward against its plain version
    def qkv(shape, dtype, seed):
        g = gen.manual_seed(seed)
        return [torch.randn(shape, generator=g, device=dev).to(dtype)
                for _ in range(3)]

    for i, (label, shape, dtn) in enumerate((
            ("SD 2.1 level 0", SD21_ATTN, "bfloat16"),
            ("SD 2.1 level 0", SD21_ATTN, "float32"),
            ("SD 1.5 level 0", (8, 4096, 8, 40), "bfloat16"),
            ("small", (2, 256, 2, 64), "float32"),
            ("whole ring, few CTAs", (1, 4096, 2, 64), "bfloat16"),
            ("one tile, TMA zero fill", (2, 128, 3, 40), "bfloat16"),
            ("mma.sync instance", (2, 256, 2, 160), "bfloat16"))):
        dt = getattr(torch, dtn)
        q, k, v = qkv(shape, dt, 20 + i)
        scale = shape[-1] ** -0.5
        got = flash_attention.flash_self_attention(q, k, v, scale)
        want = flash_attention.flash_self_attention_plain(q, k, v, scale)
        torch.cuda.synchronize()
        require(got.shape == q.shape and got.dtype == dt,
                f"K5 {label} {dtn}: output {got.dtype} {tuple(got.shape)}")
        require(bool(torch.isfinite(got).all()),
                f"K5 {label} {dtn}: non-finite output")
        err = float((got.float() - want.float()).abs().max())
        tol = FLASH_TOL[dtn] * float(want.float().abs().max())
        require(err <= tol, f"K5 {label} {shape} {dtn}: max abs err "
                f"{err:.3e} above {tol:.3e}")
        errs["flash_attn_fwd"] = max(errs["flash_attn_fwd"], err)
        notes.append(f"K5 {label} {list(shape)} {dtn}: max abs err "
                     f"{err:.2e} (tol {tol:.2e})")
        del q, k, v, got, want
    torch.cuda.empty_cache()

    # K6 / K7 (flash backward) against the plain formulas from the same
    # lse and Di, and K5's lse against the plain lse
    def qkvo(shape, dtype, seed):
        return qkv(shape, dtype, seed) + [torch.randn(
            shape, generator=gen.manual_seed(seed + 100),
            device=dev).to(dtype)]

    for i, (label, shape, dtn) in enumerate((
            ("VSD level 0", VSD_ATTN, "float32"),
            ("VSD level 0", VSD_ATTN, "bfloat16"),
            ("small", (2, 256, 2, 64), "float32"),
            ("whole ring, few CTAs", (1, 4096, 2, 64), "bfloat16"),
            ("mma.sync instance", (2, 256, 2, 160), "bfloat16"),
            ("one tile, TMA zero fill", (2, 128, 3, 40), "bfloat16"),
            ("D <= 160 instance", (2, 256, 2, 160), "float32"))):
        dt = getattr(torch, dtn)
        q, k, v, dout = qkvo(shape, dt, 40 + i)
        scale = shape[-1] ** -0.5
        out, lse = flash_attention.flash_self_attention_lse(q, k, v, scale)
        _, lse_p = flash_attention.flash_self_attention_plain_lse(q, k, v,
                                                                  scale)
        e_lse = float((lse - lse_p).abs().max())
        require(e_lse <= FLASH_TOL[dtn] * float(lse_p.abs().max()),
                f"K5 lse {label} {dtn}: max abs err {e_lse:.3e}")
        delta = flash_attention.attention_delta(out, dout)
        dk, dv = flash_attention.flash_bwd_dkv(q, k, v, dout, lse, delta,
                                               scale)
        dq = flash_attention.flash_bwd_dq(q, k, v, dout, lse, delta, scale)
        want = flash_attention.flash_self_attention_bwd_plain(
            q, k, v, out, lse, dout, scale)
        torch.cuda.synchronize()
        msg = []
        for nm, got, ref in zip(("dq", "dk", "dv"), (dq, dk, dv), want):
            kname = "K7" if nm == "dq" else "K6"
            require(got.shape == q.shape and got.dtype == dt,
                    f"{kname} {label} {dtn}: {nm} {got.dtype} "
                    f"{tuple(got.shape)}")
            require(bool(torch.isfinite(got).all()),
                    f"{kname} {label} {dtn}: non-finite {nm}")
            err = float((got.float() - ref.float()).abs().max())
            top = float(ref.float().abs().max())
            tol = FLASH_BWD_TOL[dtn] * top
            require(err <= tol, f"{kname} {label} {shape} {dtn}: {nm} max "
                    f"abs err {err:.3e} above {tol:.3e}")
            if nm == "dq" and dtn == "float32" and shape == VSD_ATTN:
                require(err <= K7_FP32_VSD_TOL * top,
                        f"K7 {label} fp32: max abs err {err:.3e} above "
                        f"{K7_FP32_VSD_TOL} of max|dq| {top:.3e}")
            key = "flash_attn_bwd_dq" if nm == "dq" else "flash_attn_bwd_dkv"
            errs[key] = max(errs[key], err)
            msg.append(f"{nm} {err:.2e} = {err / top:.1e} of max (tol "
                       f"{tol:.2e})")
        notes.append(f"K6/K7 {label} {list(shape)} {dtn}: "
                     + ", ".join(msg) + f"; K5 lse {e_lse:.2e}")
        del q, k, v, dout, out, lse, lse_p, delta, dk, dv, dq, want
        torch.cuda.empty_cache()

    # autograd: K5 + K6 + K7 through the Function against autograd through
    # the plain path (fp32, the VSD path's type)
    q, k, v, dout = qkvo((2, 1024, 5, 64), torch.float32, 60)
    ps = [x.clone().requires_grad_(True) for x in (q, k, v)]
    out = flash_attention.flash_self_attention(*ps, 0.125)
    require(out.grad_fn is not None,
            "flash_self_attention returned an output detached from inputs "
            "that require grad")
    got = torch.autograd.grad(out, ps, dout)
    ref_ps = [x.clone().requires_grad_(True) for x in (q, k, v)]
    want = torch.autograd.grad(flash_attention.flash_self_attention_plain(
        *ref_ps, 0.125), ref_ps, dout)
    torch.cuda.synchronize()
    a_errs = []
    for nm, a, b in zip(("dq", "dk", "dv"), got, want):
        err = float((a - b).abs().max())
        require(err <= FLASH_BWD_TOL["float32"] * float(b.abs().max()),
                f"autograd through K5-K7 vs plain: {nm} max abs err "
                f"{err:.3e}")
        a_errs.append(f"{nm} {err:.2e}")
    notes.append("autograd K5+K6+K7 vs plain [2, 1024, 5, 64] fp32: "
                 + ", ".join(a_errs))
    del q, k, v, dout, ps, out, got, ref_ps, want
    torch.cuda.empty_cache()
    print("phase 3 kernels: ok | " + " | ".join(notes), flush=True)

    # ---- phase 4: train configs/base.yaml (guidance.type=mock) ----
    wrappers = dict(raster_fwd=cuda_raster.raster_fwd,
                    raster_bwd=cuda_raster.raster_bwd,
                    expansion_rank=expansion_rank.expansion_gid,
                    gid_repack=gid_repack.repack_gid,
                    flash_attn_fwd=flash_attention.flash_self_attention,
                    flash_attn_bwd_dkv=flash_attention.flash_bwd_dkv,
                    flash_attn_bwd_dq=flash_attention.flash_bwd_dq,
                    raster_fwd_compact=cuda_raster.raster_fwd_compact,
                    raster_bwd_compact=cuda_raster.raster_bwd_compact)
    trainer, mock = drive(torch, build_trainer, load_config, wrappers,
                          "base.yaml", ["guidance.type=mock"], 5, {})
    step_ms = mock["ms_per_step"]
    print(f"phase 4 train: ok configs/base.yaml guidance.type=mock "
          f"{mock['steps']} steps, batch {mock['batch']}, {mock['reso']}^2, "
          f"capacity {trainer.state.scene.params['mean'].shape[0]} "
          f"| losses {mock['losses']} | ms/step "
          f"{[round(x, 3) for x in step_ms]} | launches {mock['launches']}",
          flush=True)

    # ---- phase 5: times ----
    def time_ms(fn, iters, warmup=1):
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(iters):
            fn()
        e.record()
        torch.cuda.synchronize()
        return s.elapsed_time(e) / iters

    def graph_ms(fn, iters=50, reps=5):
        """Device time of one call of ``fn`` without its host launch path:
        a CUDA graph of ``iters`` calls replayed ``reps`` times between two
        events, over iters x reps (the graph's own gaps between kernels
        included)."""
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(iters):
                fn()
        graph.replay()
        torch.cuda.synchronize()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(reps):
            graph.replay()
        e.record()
        torch.cuda.synchronize()
        return s.elapsed_time(e) / (iters * reps)

    def needed_lanes(r):
        """(pixel, real duplicate row) pairs the forward has to composite:
        lanes before each pixel's T cutoff, in chunks (windows) the tile
        processed."""
        bins, st = r["bins"], r["st"]
        K, F = st["chunk"], st["F"]
        dup, starts, nck = r["dup"], bins.starts, r["nck"]
        compact = bins.gid_s is not None
        base = starts.long() // K * K if compact else starts.long()
        n_tiles = starts.shape[0]
        P = st["tile_size"] ** 2
        tiles = torch.arange(n_tiles, dtype=torch.int32, device=dev)
        pixx, pixy = tile_pixels(tiles, r["geom"], st["n_tiles_w"],
                                 st["tile_size"])
        T = torch.ones(n_tiles, P, 1, device=dev)
        alive = nck > 0
        lanes = torch.arange(K, device=dev)
        total, i = 0, 0
        with torch.no_grad():
            while bool(alive.any()):
                idx = alive.nonzero()[:, 0]
                cols = base[idx][:, None] + i * K + lanes[None]
                d = dup[:6 + F][:, cols].permute(1, 0, 2)
                if compact:
                    real = ((cols >= starts[idx].long()[:, None])
                            & (cols < bins.ends[idx].long()[:, None])
                            )[:, None, :]
                else:
                    real = bins.row_valid[cols][:, None, :]
                om, cp, proc, _ = chunk_weights(
                    d, pixx[idx], pixy[idx], T[idx], st["T_thresh"],
                    real if compact else None)
                total += int((proc & real).sum())
                q = torch.where(proc, cp * om, torch.full_like(om, math.inf))
                T[idx] = T[idx] * torch.clamp(q.amin(2, keepdim=True),
                                              max=1.0)
                i += 1
                alive = alive & (i < nck) & (T.amax((1, 2))
                                             >= st["T_thresh"])
        return total

    def bounds(r):
        """Least times (ms) on the card for each kernel's work, from this
        run's inputs: max(bytes / 3.35 TB/s, flops / 67 TFLOP/s)."""
        bins, st = r["bins"], r["st"]
        F = st["F"]
        lanes = needed_lanes(r)
        compact = bins.gid_s is not None
        rows = int(bins.total) if compact else int(bins.row_valid.sum())
        n_tiles = bins.starts.shape[0]
        P = st["tile_size"] ** 2
        out_b = n_tiles * st["ch_out"] * P * 4
        dup_b = rows * (6 + F) * 4
        cap = r["seen"]["expansion_rank"][1]
        capp = bins.gid_s.shape[0] if compact else bins.padded_gid.shape[0]
        ms = lambda b, f: 1e3 * max(b / PEAK_BYTES, f / PEAK_FLOPS)  # noqa
        by = lambda b, f: "bytes" if b / PEAK_BYTES >= f / PEAK_FLOPS \
            else "operations"  # noqa
        # starts, ends and counts read; grad written whole (zero fill)
        fwd = (dup_b + out_b + 12 * n_tiles, lanes * (23 + 2 * F))
        bwd = (dup_b + 2 * n_tiles * (F + 2) * P * 4 + 12 * n_tiles
               + 16 * capp * 4, lanes * (64 + 4 * F))
        if compact:
            return {k: (ms(*v), by(*v)) for k, v in
                    dict(raster_fwd_compact=fwd,
                         raster_bwd_compact=bwd).items()}
        k3 = (r["seen"]["expansion_rank"][0].numel() * 4 + cap * 4, 0)
        k4 = (cap * 4 + capp * 4 + (bins.chunk_tile.numel()
                                    + 2 * n_tiles) * 4, 0)
        return {k: (ms(*v), by(*v)) for k, v in
                dict(raster_fwd=fwd, raster_bwd=bwd, expansion_rank=k3,
                     gid_repack=k4).items()}

    def kernel_times(r, iters, plain_iters):
        bins, st, dup, nck = r["bins"], r["st"], r["dup"], r["nck"]
        cap = r["seen"]["expansion_rank"][1]
        geom, g, out = r["geom"], r["g"], r["out"]
        a = (bins.starts, bins.ends, nck, geom)
        fwd = lambda: cuda_raster.raster_fwd(dup, *a, **st)  # noqa: E731
        fwd_p = lambda: cuda_raster.raster_fwd_plain(  # noqa: E731
            dup, *a, **st)
        bwd = lambda: cuda_raster.raster_bwd(  # noqa: E731
            dup, out, g, *a, **st)
        bwd_p = lambda: cuda_raster.raster_bwd_plain(  # noqa: E731
            dup, out, g, *a, **st)
        k3_args, k4_args = r["seen"]["expansion_rank"], r["seen"]["gid_repack"]
        cum = k3_args[0]
        arange = torch.arange(cap, dtype=torch.int32, device=dev)
        k3 = lambda: expansion_rank.expansion_gid(*k3_args)  # noqa: E731
        k3_p = lambda: expansion_rank.expansion_gid_plain(*k3_args)  # noqa
        k3_l = lambda: torch.searchsorted(cum, arange, right=True)  # noqa
        k4 = lambda: gid_repack.repack_gid(*k4_args)  # noqa: E731
        k4_p = lambda: gid_repack.repack_gid_plain(*k4_args)  # noqa: E731
        bd = bounds(r)
        res = {}
        for k, (f, fp, fl) in dict(
                raster_fwd=(fwd, fwd_p, None), raster_bwd=(bwd, bwd_p, None),
                expansion_rank=(k3, k3_p, k3_l),
                gid_repack=(k4, k4_p, None)).items():
            res[k] = dict(
                ms=time_ms(f, iters), plain_ms=time_ms(fp, plain_iters),
                library_ms=None if fl is None else time_ms(fl, iters),
                bound_ms=bd[k][0], bound_by=bd[k][1])
        # K1-K4 take microseconds to a few tenths of a millisecond: a host
        # loop of calls times their launch path too; ms and library_ms
        # become device times (a CUDA graph), the host-loop times stay
        # beside them
        for k, f, fl in (("raster_fwd", fwd, None), ("raster_bwd", bwd, None),
                         ("expansion_rank", k3, k3_l),
                         ("gid_repack", k4, None)):
            res[k]["host_loop_ms"] = res[k]["ms"]
            res[k]["ms"] = graph_ms(f)
            if fl is not None:
                res[k]["library_host_loop_ms"] = res[k]["library_ms"]
                res[k]["library_ms"] = graph_ms(fl)
        return res

    def compact_times(r, iters, plain_iters):
        """K8 and K9 (and their plain versions) on the compact bins."""
        bins, st, dup, wc = r["bins"], r["st"], r["dup"], r["nck"]
        a = (bins.starts, bins.ends, wc, r["geom"])
        g, out = r["g"], r["out"]
        bd = bounds(r)
        fns = dict(
            raster_fwd_compact=(
                lambda: cuda_raster.raster_fwd_compact(dup, *a, **st),
                lambda: cuda_raster.raster_fwd_plain(dup, *a, **st)),
            raster_bwd_compact=(
                lambda: cuda_raster.raster_bwd_compact(dup, out, g, *a, **st),
                lambda: cuda_raster.raster_bwd_plain(dup, out, g, *a, **st)))
        return {k: dict(ms=graph_ms(f), host_loop_ms=time_ms(f, iters),
                        plain_ms=time_ms(fp, plain_iters), library_ms=None,
                        bound_ms=bd[k][0], bound_by=bd[k][1])
                for k, (f, fp) in fns.items()}

    def walked_lanes(r):
        """Lanes each tile's forward walked: its rows in the windows it
        processed.  (max, mean over tiles that walked any, max / mean,
        median, 90th and 99th percentile)."""
        bins, K = r["bins"], r["st"]["chunk"]
        start, end = bins.starts.long(), bins.ends.long()
        cnt = r["out"][:, -1, 0].long()
        n = (torch.minimum(end, start // K * K + cnt * K) - start).clamp(
            min=0)
        n = n[n > 0].double()
        q = torch.quantile(n, torch.tensor([0.5, 0.9, 0.99], device=n.device,
                                           dtype=n.dtype))
        return (float(n.max()), float(n.mean()), float(n.max() / n.mean()),
                *(float(x) for x in q))

    times_base = kernel_times(base, 20, 3)
    times_bench = kernel_times(bench[False], 20, 3)
    # the floor that the spacing of launches sets: a one-element add (one
    # block that does almost nothing) in the same 50-call graph
    one = torch.zeros(1, dtype=torch.int32, device=dev)
    floor_ms = [graph_ms(lambda: one.add_(1)) for _ in range(2)]
    for tb in (times_base, times_bench):
        tb["expansion_rank"]["floor_ms"] = min(floor_ms)
    k3_edge_ms = {name: graph_ms(
        lambda c=cum, n=cap: expansion_rank.expansion_gid(c, n))
        for name, (cum, cap) in k3_cases.items()}
    times_base["expansion_rank"]["edge_case_ms"] = k3_edge_ms
    print(f"phase 5 K3: ok | card {card} | device time, a CUDA graph of 50 "
          "calls: " + " | ".join(
              f"{name} N {r['seen']['expansion_rank'][0].numel()} cap "
              f"{r['seen']['expansion_rank'][1]}: K3 {tb['ms']:.4f} ms "
              f"({100 * tb['bound_ms'] / tb['ms']:.1f}% of bound "
              f"{tb['bound_ms']:.4f} bytes), torch.searchsorted "
              f"{tb['library_ms']:.4f}, one-element add {tb['floor_ms']:.4f}"
              for name, r, tb in (
                  ("base.yaml", base, times_base["expansion_rank"]),
                  ("bench", bench[False], times_bench["expansion_rank"])))
          + f" | one-element add runs {floor_ms} | K3 on the edge cases: "
          + ", ".join(f"{k} {v:.4f}" for k, v in k3_edge_ms.items()),
          flush=True)
    times_base.update(compact_times(base_c, 20, 3))
    times_bench.update(compact_times(bench_c[False], 20, 3))
    walked = {f"{shape} {layout}": walked_lanes(r) for shape, layout, r in (
        ("base", "padded", base), ("base", "compact", base_c),
        ("bench", "padded", bench[False]),
        ("bench", "compact", bench_c[False]))}
    print(f"phase 5 lanes: ok lanes a tile's forward walked (max, mean, "
          f"max/mean; median, p90, p99): " + " | ".join(
              f"{k} {v[0]:.0f}, {v[1]:.1f}, {v[2]:.2f}; {v[3]:.0f}, "
              f"{v[4]:.0f}, {v[5]:.0f}" for k, v in walked.items()),
          flush=True)

    # full render forward + backward of one 512^2 view, all parameter
    # gradients, at the bench workload and at base.yaml's render
    bg1 = torch.ones(3, device=dev)
    cot = torch.randn(512, 512, 3, generator=gen.manual_seed(5), device=dev)

    def render_ms(scene, c2w, intr, rcfg):
        params = {k: v.detach().requires_grad_(True)
                  for k, v in scene.params.items()}

        def fb():
            o = render_view(params, scene.active, c2w, intr, rcfg, bg1)
            torch.autograd.grad((o["rgb"] * cot).sum(), list(params.values()))
        return time_ms(fb, 10, warmup=2)

    compact = lambda rc: dataclasses.replace(  # noqa: E731
        rc, binning_layout="compact")
    render = dict(bench=render_ms(s_bench, c2w_front, intr512, rc_bench),
                  base=render_ms(*base_view))
    n8 = cuda_raster.raster_fwd_compact.launches
    render_compact = dict(
        bench=render_ms(s_bench, c2w_front, intr512, compact(rc_bench)),
        base=render_ms(*base_view[:3], compact(base_view[3])))
    require(cuda_raster.raster_fwd_compact.launches - n8 == 24,
            "the compact renders did not run K8 once per render")
    # the two layouts once more, in the other order (chip noise)
    render_again = dict(
        base_compact=render_ms(*base_view[:3], compact(base_view[3])),
        base_padded=render_ms(*base_view))

    # K5 at SD 2.1's level 0 in bf16 (the slice's type); the yardstick is
    # one SDPA call on [B, H, L, D] views of the same tensors
    import torch.nn.functional as F
    B, L, H, D = SD21_ATTN
    scale = D ** -0.5
    flash_ops = 4.0 * B * H * L * L * D
    q, k, v = qkv(SD21_ATTN, torch.bfloat16, 30)
    qh, kh, vh = (x.transpose(1, 2) for x in (q, k, v))
    sdpa_err = float((F.scaled_dot_product_attention(
        qh, kh, vh, scale=scale).transpose(1, 2).float()
        - flash_attention.flash_self_attention_plain(
            q, k, v, scale).float()).abs().max())
    b_ms = 1e3 * 4 * B * L * H * D * 2 / PEAK_BYTES
    o_ms = 1e3 * flash_ops / PEAK_BF16_FLOPS
    times_flash = dict(
        ms=time_ms(lambda: flash_attention.flash_self_attention(
            q, k, v, scale), 20),
        plain_ms=time_ms(lambda: flash_attention.flash_self_attention_plain(
            q, k, v, scale), 3),
        library_ms=time_ms(lambda: F.scaled_dot_product_attention(
            qh, kh, vh, scale=scale), 20),
        bound_ms=max(b_ms, o_ms),
        bound_by="bytes" if b_ms >= o_ms else "operations")
    q32, k32, v32 = (x.float() for x in (q, k, v))
    flash_fp32_ms = time_ms(lambda: flash_attention.flash_self_attention(
        q32, k32, v32, scale), 5)
    flash_fp32_plain_ms = time_ms(
        lambda: flash_attention.flash_self_attention_plain(
            q32, k32, v32, scale), 3)
    # SDPA in fp32 (TF32 off) at K5's fp32 shapes: B=8, and B=4, where the
    # VSD path's K5 also writes its lse
    qh32, kh32, vh32 = (x.transpose(1, 2) for x in (q32, k32, v32))
    sdpa_fp32 = dict(
        b8=time_ms(lambda: F.scaled_dot_product_attention(
            qh32, kh32, vh32, scale=scale), 5),
        b4=time_ms(lambda: F.scaled_dot_product_attention(
            qh32[:4], kh32[:4], vh32[:4], scale=scale), 5))
    del q, k, v, qh, kh, vh, q32, k32, v32, qh32, kh32, vh32
    torch.cuda.empty_cache()

    # K6 / K7 at the VSD path's [4, 4096, 5, 64] (fp32 on the path, bf16
    # beside it); the yardstick is SDPA's backward, one call computing all
    # three gradients; K5 with its lse at the same shape
    Bv, Lv, Hv, Dv = VSD_ATTN
    units = Bv * Hv * Lv * Lv * Dv
    times_bwd, k5_b4, sdpa_bwd_ms = {}, {}, {}
    for dtn in ("float32", "bfloat16"):
        dt = getattr(torch, dtn)
        q, k, v, dout = qkvo(VSD_ATTN, dt, 70)
        out, lse = flash_attention.flash_self_attention_lse(q, k, v, scale)
        delta = flash_attention.attention_delta(out, dout)
        args = (q, k, v, dout, lse, delta, scale)
        k5_b4[dtn] = time_ms(lambda: flash_attention.flash_self_attention_lse(
            q, k, v, scale), 10)
        qh, kh, vh = (x.transpose(1, 2).detach().requires_grad_(True)
                      for x in (q, k, v))
        o_h = F.scaled_dot_product_attention(qh, kh, vh, scale=scale)
        do_h = dout.transpose(1, 2)
        sdpa_bwd = time_ms(lambda: torch.autograd.grad(
            o_h, (qh, kh, vh), do_h, retain_graph=True), 10)
        sdpa_bwd_ms[dtn] = sdpa_bwd
        io = Bv * Lv * Hv * Dv * dt.itemsize
        in_b = 4 * io + 2 * Bv * Hv * Lv * 4
        for name, fn, fn_p, ops, out_b in (
                ("flash_attn_bwd_dkv", flash_attention.flash_bwd_dkv,
                 flash_attention.flash_bwd_dkv_plain, 8.0 * units, 2 * io),
                ("flash_attn_bwd_dq", flash_attention.flash_bwd_dq,
                 flash_attention.flash_bwd_dq_plain, 6.0 * units, io)):
            b_ms = 1e3 * (in_b + out_b) / PEAK_BYTES
            o_ms = 1e3 * ops / flash_peak(dtn)
            # device_ms: the kernel alone, without the wrapper's host path
            times_bwd[(name, dtn)] = dict(
                ms=time_ms(lambda fn=fn: fn(*args), 10),
                device_ms=graph_ms(lambda fn=fn: fn(*args), 10, 3),
                plain_ms=time_ms(lambda fn_p=fn_p: fn_p(*args), 3),
                library_ms=sdpa_bwd, bound_ms=max(b_ms, o_ms),
                bound_by="bytes" if b_ms >= o_ms else "operations")
        del q, k, v, dout, out, lse, delta, args, qh, kh, vh, o_h, do_h
        torch.cuda.empty_cache()
    bwd_bound = {d: 1e3 * 10.0 * units / pk for d, pk in
                 (("float32", PEAK_FLOPS), ("bfloat16", PEAK_BF16_FLOPS))}
    # one row per K5 / K6 / K7 instance: ms, TFLOP/s, share of its bound
    # and the SDPA call beside it
    flash_rows = [
        ("K5 bf16 wgmma+TMA", list(SD21_ATTN), times_flash["ms"], flash_ops,
         times_flash["bound_ms"], times_flash["library_ms"]),
        ("K5 fp32 3xTF32", list(SD21_ATTN), flash_fp32_ms, flash_ops,
         1e3 * flash_ops / PEAK_3XTF32_FLOPS, sdpa_fp32["b8"]),
        ("K5 fp32 3xTF32 +lse", list(VSD_ATTN), k5_b4["float32"],
         4.0 * units, 1e3 * 4.0 * units / PEAK_3XTF32_FLOPS,
         sdpa_fp32["b4"]),
        ("K5 bf16 wgmma+TMA +lse", list(VSD_ATTN), k5_b4["bfloat16"],
         4.0 * units, 1e3 * 4.0 * units / PEAK_BF16_FLOPS, None)]
    for (name, dtn), v in times_bwd.items():
        design = {("flash_attn_bwd_dkv", "bfloat16"): "K6 bf16 wgmma+TMA",
                  ("flash_attn_bwd_dkv", "float32"): "K6 fp32 3xTF32",
                  ("flash_attn_bwd_dq", "bfloat16"): "K7 bf16 wgmma+TMA",
                  ("flash_attn_bwd_dq", "float32"): "K7 fp32 3xTF32"}
        ops = (8.0 if name == "flash_attn_bwd_dkv" else 6.0) * units
        flash_rows.append((design[(name, dtn)], list(VSD_ATTN), v["ms"], ops,
                           v["bound_ms"], sdpa_bwd_ms[dtn]))
    flash_instances = [
        dict(instance=n, shape=shp, ms=ms, tflops=ops / ms / 1e9,
             bound_ms=bd, pct_of_bound=100.0 * bd / ms, sdpa_ms=sd)
        for n, shp, ms, ops, bd, sd in flash_rows]
    require(all(r["pct_of_bound"] <= 100.0 for r in flash_instances),
            "a flash instance reads above 100% of its bound: "
            f"{flash_instances}")
    print(f"phase 5 flash: ok | card {card} | " + " | ".join(
        f"{r['instance']} {r['shape']} {r['ms']:.4f} ms = "
        f"{r['tflops']:.1f} TFLOP/s, {r['pct_of_bound']:.1f}% of bound "
        f"{r['bound_ms']:.4f} ms, SDPA "
        + ("n/a" if r["sdpa_ms"] is None else f"{r['sdpa_ms']:.4f} ms")
        + ("" if "K5" in r["instance"] else " (whole bwd)")
        for r in flash_instances), flush=True)
    print(f"phase 5 times: ok | card {card} | K6/K7 {list(VSD_ATTN)}: "
          + " | ".join(
              f"{n} {d} {v['ms']:.3f} ms (device {v['device_ms']:.3f}, "
              f"plain {v['plain_ms']:.3f}, SDPA "
              f"bwd {v['library_ms']:.3f}, bound {v['bound_ms']:.4f} "
              f"{v['bound_by']})" for (n, d), v in times_bwd.items())
          + f" | whole backward bound 10 B H L^2 D: fp32 "
            f"{bwd_bound['float32']:.3f} ms, bf16 {bwd_bound['bfloat16']:.4f}"
            f" ms | K5 with lse at B=4: fp32 {k5_b4['float32']:.3f} ms, "
            f"bf16 {k5_b4['bfloat16']:.4f} ms", flush=True)
    print(f"phase 5 times: ok | card {card} | K5 {list(SD21_ATTN)} bf16 "
          f"{times_flash['ms']:.4f} ms = "
          f"{flash_ops / times_flash['ms'] / 1e9:.1f} TFLOP/s (plain "
          f"{times_flash['plain_ms']:.3f}, SDPA "
          f"{times_flash['library_ms']:.4f} [max abs diff to plain "
          f"{sdpa_err:.2e}], bound {times_flash['bound_ms']:.4f} "
          f"{times_flash['bound_by']}), fp32 {flash_fp32_ms:.3f} ms "
          f"(plain {flash_fp32_plain_ms:.3f}, SDPA fp32 "
          f"{sdpa_fp32['b8']:.3f}, bound "
          f"{1e3 * flash_ops / PEAK_3XTF32_FLOPS:.3f} at 495/3 TFLOP/s) "
          f"| SDPA fp32 "
          f"at B=4: {sdpa_fp32['b4']:.3f} ms (K5 with lse "
          f"{k5_b4['float32']:.3f})", flush=True)
    print(f"phase 5 times: ok | card {card} | render fwd+bwd 512^2: "
          + ", ".join(f"{k} {v:.3f} ms = {512 * 512 / v * 1e3:.0f} rays/s"
                      for k, v in render.items())
          + " | compact layout: " + ", ".join(
              f"{k} {v:.3f} ms" for k, v in render_compact.items())
          + " | again: " + ", ".join(f"{k} {v:.3f} ms"
                                     for k, v in render_again.items())
          + " | "
          + " | ".join(f"{k}: base {v['ms']:.4f} ms (plain "
                       f"{v['plain_ms']:.3f}, bound {v['bound_ms']:.4f} "
                       f"{v['bound_by']}), bench "
                       f"{times_bench[k]['ms']:.4f} ms"
                       for k, v in times_base.items()), flush=True)
    print(f"phase 5 times: ok | card {card} | device time (a CUDA graph of "
          "50 calls; host loop of calls in brackets), base / bench: "
          + " | ".join(
              f"{k} {tb[k]['ms']:.4f} [{tb[k]['host_loop_ms']:.4f}]"
              + ("" if tb[k]["library_ms"] is None else
                 f", torch.searchsorted {tb[k]['library_ms']:.4f} "
                 f"[{tb[k]['library_host_loop_ms']:.4f}]")
              for tb in (times_base, times_bench)
              for k in (*RASTER, "expansion_rank", "gid_repack")),
          flush=True)

    # ---- phase 6: where a train step's device time goes ----
    from torch.profiler import ProfilerActivity, profile
    prof_steps = 2
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.fit(prof_steps)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    trace = cuda_lib.BUILD / "train_step_trace.json"
    prof.export_chrome_trace(str(trace))
    events = [e for e in json.loads(trace.read_text())["traceEvents"]
              if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
    busy = busy_us(events)
    by_name = {}
    for e in events:
        key = kernel_key(e["name"])
        by_name[key] = by_name.get(key, 0.0) + float(e["dur"])
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    busy_ms = busy / 1e3 / prof_steps
    step_wall = wall_ms / prof_steps
    profile_info = dict(
        traced_ms_per_step=step_wall, device_busy_ms_per_step=busy_ms,
        device_idle_share=1.0 - busy_ms / step_wall,
        device_kernels_per_step=len(events) / prof_steps,
        top_device_ms_per_step={k: v / 1e3 / prof_steps for k, v in top})
    require(len(events) > 0, "the profiler saw no device work")
    print(f"phase 6 profile: ok {prof_steps} traced steps, "
          f"{step_wall:.2f} ms/step, device busy {busy_ms:.2f} ms/step "
          f"(idle share {profile_info['device_idle_share']:.3f}), "
          f"{len(events) / prof_steps:.0f} device ops/step | top: "
          + "; ".join(f"{k} {v / 1e3 / prof_steps:.3f} ms" for k, v in top),
          flush=True)

    del trainer
    torch.cuda.empty_cache()

    # ---- phase 7: SDS on the SD 2.1 UNet + VAE (the slice) ----
    sds = sds_phases(torch, dev, build_trainer, load_config, wrappers)
    launches = sds["launches"]

    # ---- phase 8: where an SDS step's device time goes ----
    sds_profile = profile_step(torch, sds.pop("trainer"),
                               cuda_lib.BUILD / "sds_step_trace.json", False)
    torch.cuda.empty_cache()

    # ---- phase 9: VSD on the SD 2.1 UNet (LoRA + camera), K6 / K7 ----
    vsd = vsd_phases(torch, dev, build_trainer, load_config, wrappers)
    vsd_profile = profile_step(torch, vsd.pop("trainer"),
                               cuda_lib.BUILD / "vsd_step_trace.json", True)
    vsd_launches = vsd["slice"]["launches"]
    torch.cuda.empty_cache()

    # ---- phase 10: the compact layout and density control at full width --
    dens = slice_phases(torch, dev, build_trainer, load_config, wrappers)
    trainer = dens.pop("trainer")
    cam = trainer.data.get_batch()
    intr_t = trainer.data.intrinsics()
    f_cam = float(cam["fx"][0])
    intr_view = CameraIntrinsics(fx=f_cam, fy=f_cam, cx=intr_t.cx,
                                 cy=intr_t.cy, w=intr_t.w, h=intr_t.h,
                                 near=intr_t.near, far=intr_t.far)
    prep = prepare(trainer.state.scene.params, trainer.state.scene.active,
                   cam["c2w"][0], intr_view, trainer.rcfg, False)
    notes.clear()
    compact_checks("densified", prep, SCALE_TOL,
                   kernel_checks("densified", prep, SCALE_TOL))
    print("phase 10 density: ok the densified, pruned scene's next view "
          "through K1-K4 and K8/K9 against the plain path | "
          + " | ".join(notes), flush=True)
    dens["compactness"] = compactness_event(torch, trainer)
    del trainer
    torch.cuda.empty_cache()
    compact_launches = dens["sds_compact"]["launches"]

    # ---- phase 11: the run's outputs and the upsample fine-tune ----
    def check_view(label, scene, c2w, intr, rcfg):
        """K1-K4 on one view of the fine-tune, as kernel_checks holds them."""
        notes.clear()
        kernel_checks(label, prepare(scene.params, scene.active, c2w, intr,
                                     rcfg, True), SCALE_TOL)
        return notes[-1]

    outputs = outputs_phase(torch, build_trainer, load_config, wrappers,
                            card, check_view)
    torch.cuda.empty_cache()

    meta = dict(
        raster_fwd=("gsgen_torch/csrc/raster_fwd.cu",
                    reference_line("ops/pallas_raster.py", "_fwd_kernel")),
        raster_bwd=("gsgen_torch/csrc/raster_bwd.cu",
                    reference_line("ops/pallas_raster.py", "_bwd_kernel_v2")),
        raster_fwd_compact=(
            "gsgen_torch/csrc/raster_fwd.cu",
            reference_line("ops/pallas_raster.py", "_fwd_kernel")
            + " (compact=True, call "
            + call_line("ops/pallas_raster.py", "_make_core_compact",
                        "fwd_call = pl.pallas_call(") + ")"),
        raster_bwd_compact=(
            "gsgen_torch/csrc/raster_bwd.cu",
            reference_line("ops/pallas_raster.py", "_bwd_kernel_v3")
            + " (call " + call_line("ops/pallas_raster.py",
                                    "_make_core_compact",
                                    "bwd_call = pl.pallas_call(") + ")"),
        expansion_rank=("gsgen_torch/csrc/expansion_rank.cu",
                        reference_line("ops/expansion_rank.py", "_kernel")),
        gid_repack=("gsgen_torch/csrc/gid_repack.cu",
                    reference_line("ops/gid_repack.py", "_kernel")))
    kernels = []
    for k, (src, ref) in meta.items():
        tb, tn = times_base[k], times_bench[k]
        on_path = compact_launches if "compact" in k else vsd_launches
        kernels.append(dict(
            name=k, route="cuda", source=src, replaces=ref,
            launches=on_path[k], sds_launches=launches[k],
            max_abs_err=errs[k], ms=tb["ms"],
            plain_ms=tb["plain_ms"], bound_ms=tb["bound_ms"],
            bound_by=tb["bound_by"], library_ms=tb["library_ms"],
            **{h: tb[h] for h in ("host_loop_ms", "library_host_loop_ms",
                                  "floor_ms", "edge_case_ms") if h in tb},
            **({"design": RASTER_DESIGN[k[7:10]]} if k in RASTER else {}),
            shapes="configs/base.yaml render (512^2, chunk 256, dup_cap "
                   "2^20)",
            bench=dict(shapes="100K Gaussians, 512^2, chunk 128, dup_cap "
                              "2^18", **tn)))
    kernels.append(dict(
        name="flash_attn_fwd", route="cuda",
        source="gsgen_torch/csrc/flash_attn_fwd.cu",
        replaces=reference_line("guidance/unet2d.py",
                                "_flash_self_attention"),
        launches=vsd_launches["flash_attn_fwd"],
        sds_launches=launches["flash_attn_fwd"],
        max_abs_err=errs["flash_attn_fwd"], **times_flash,
        shapes=f"SD 2.1 level-0 self-attention {list(SD21_ATTN)} bf16",
        fp32_ms=flash_fp32_ms, fp32_plain_ms=flash_fp32_plain_ms,
        fp32_library_ms=sdpa_fp32["b8"], fp32_b4_lse_ms=k5_b4["float32"],
        fp32_b4_library_ms=sdpa_fp32["b4"],
        fp32_bound_ms=1e3 * flash_ops / PEAK_3XTF32_FLOPS,
        design="bf16 D<=64: wgmma + TMA (2 consumer warpgroups, 128 "
               "queries a CTA, 3-stage K/V ring); bf16 D>64: mma.sync; "
               "fp32: 3xTF32 on mma.sync m16n8k8, cp.async double buffer"))
    for name, func, line in (
            ("flash_attn_bwd_dkv", "_flash_attention_dkv_kernel", 796),
            ("flash_attn_bwd_dq", "_flash_attention_dq_kernel", 1146)):
        kernels.append(dict(
            name=name, route="cuda",
            source="gsgen_torch/csrc/flash_attn_bwd.cu",
            replaces=f"{LIB_FLASH}:{line} {func} (jax 0.9.0), reached from "
                     + reference_line("guidance/unet2d.py",
                                      "_flash_self_attention"),
            launches=vsd_launches[name], max_abs_err=errs[name],
            **times_bwd[(name, "float32")],
            shapes=f"VSD level-0 self-attention backward {list(VSD_ATTN)} "
                   "fp32; library_ms: SDPA's backward (dQ, dK and dV)",
            design=("bf16 D<=64: wgmma + TMA (2 consumer warpgroups, 128 "
                    "keys a CTA, 3-stage Q/dO ring); bf16 D>64: mma.sync; "
                    "fp32: 3xTF32 on mma.sync m16n8k8, cp.async double "
                    "buffer" if name == "flash_attn_bwd_dkv" else
                    "bf16 D<=64: wgmma + TMA (2 consumer warpgroups, 128 "
                    "queries a CTA, 3-stage K/V ring); bf16 D>64: mma.sync; "
                    "fp32: 3xTF32 on mma.sync m16n8k8, K/V tiles of 32 "
                    "keys split at fragment load, cp.async double buffer"),
            bf16=times_bwd[(name, "bfloat16")]))
    print(json.dumps({"kernels": kernels, "render_fwd_bwd_ms": render,
                      "render_fwd_bwd_ms_compact": render_compact,
                      "render_fwd_bwd_ms_again": render_again,
                      "density": dens, "compact_layout": layout_stats,
                      "walked_lanes": walked,
                      "train_ms_per_step": step_ms, "build_s": build_s,
                      "train_profile": profile_info, "sds": sds,
                      "sds_profile": sds_profile, "vsd": vsd,
                      "vsd_profile": vsd_profile, "outputs": outputs,
                      "flash_bwd_bound_ms": bwd_bound,
                      "flash_instances": flash_instances}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def k3_edge_cases(torch, dev, expansion_rank):
    """K3 against its plain version, bitwise, on count patterns the render
    shapes do not reach; returns {name: (cum, cap)}."""
    g = torch.Generator(device="cpu").manual_seed(13)

    def counts(n, hi):
        return torch.randint(0, hi, (n,), generator=g)

    zero_runs = counts(60000, 8)
    for a, b in ((0, 20000), (30000, 45000), (52000, 60000)):
        zero_runs[a:b] = 0
    # base.yaml's pattern: 65,536 rows, most of them zero-count
    sparse = counts(65536, 40) * (torch.rand(65536, generator=g) < 0.02)
    cases = {
        "total 0": (torch.zeros(5000, dtype=torch.int64), 4096),
        "total over cap": (counts(3000, 50), 3 * 4096 + 1234),
        "N 1": (torch.tensor([7]), 4096),
        "N 1 count 0": (torch.tensor([0]), 100),
        "N 1 over cap": (torch.tensor([5000]), 4096),
        "zero runs at start, middle and end": (zero_runs, 1 << 18),
        "sparse rows, cap 2^20": (sparse, 1 << 20),
        "ragged cap": (counts(10000, 3), 5 * 4096 + 3),
        "cap 3": (torch.tensor([1, 1]), 3),
    }
    out = {}
    for name, (c, cap) in cases.items():
        cum = torch.cumsum(c, 0).to(torch.int32).to(dev)
        require(torch.equal(expansion_rank.expansion_gid(cum, cap),
                            expansion_rank.expansion_gid_plain(cum, cap)),
                f"K3 differs from its plain version: {name}")
        out[name] = (cum, cap)
    return out


def outputs_phase(torch, build_trainer, load_config, wrappers, card,
                  check_view):
    """Phase 11: ``gsgen_torch.main`` on configs/flagship_rehearsal.yaml for
    3 steps with an eval image every step and the orbit video and a
    checkpoint at step 2, into a temporary log root; the fine-tune as the
    config sets it (32 poses, 4 epochs, 256^2) with K1-K4's counters read
    around it, then K1-K4 held against their plain versions
    (``check_view``) on the tuned scene at the first 64^2 and the first
    256^2 view the fine-tune rendered, at the render config it used; ply,
    splat and mesh; each output's seconds and bytes; the final checkpoint
    loaded into a fresh trainer, every array equal."""
    import shutil
    import tempfile

    import numpy as np

    from gsgen_torch import main as main_mod
    from gsgen_torch.io import checkpoint as ckpt_mod
    from gsgen_torch.io import export as export_mod
    from gsgen_torch.training import evaluation, upsample

    cfg_path = ROOT / "configs" / "flagship_rehearsal.yaml"
    overrides = ["trainer.eval_image_period=1", "trainer.eval_video_period=2",
                 "trainer.save_period=2"]
    seconds, tune, stamps, saved = {}, {}, [], []
    patched, views = [], {}

    def patch(mod, name, wrapper):
        patched.append((mod, name, getattr(mod, name)))
        setattr(mod, name, wrapper(getattr(mod, name)))

    def timed(key):
        def wrap(fn):
            def call(*a, **kw):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = fn(*a, **kw)
                torch.cuda.synchronize()
                seconds.setdefault(key, []).append(time.perf_counter() - t0)
                if key == "save_checkpoint":
                    saved.append(out)
                return out
            return call
        return wrap

    def counted(fn):
        def call(trainer, ucfg, **kw):
            torch.cuda.synchronize()
            for w in wrappers.values():
                w.launches = 0
            t0 = time.perf_counter()
            losses = fn(trainer, ucfg, **kw)
            torch.cuda.synchronize()
            tune.update(seconds=time.perf_counter() - t0, losses=losses,
                        launches={k: w.launches for k, w in wrappers.items()},
                        num_poses=ucfg.num_poses, epoch=ucfg.epoch,
                        reso=ucfg.reso, batch=ucfg.batch_size)
            require(sorted(views) == sorted({64, ucfg.reso}),
                    f"phase 11: fine-tune rendered at {sorted(views)}")
            tune["kernel_checks"] = [
                check_view(f"fine-tune {w}^2", trainer.state.scene, *views[w])
                for w in sorted(views)]
            return losses
        return call

    def recorded(fn):
        """The first view the fine-tune renders at each resolution: its
        camera, intrinsics and render config."""
        def call(params, active, c2w, intr, rcfg, *a, **kw):
            views.setdefault(intr.w, (c2w[0].detach().clone(), intr, rcfg))
            return fn(params, active, c2w, intr, rcfg, *a, **kw)
        return call

    def stamped(fn):
        def call(*a, **kw):
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            stamps.append(time.perf_counter())
            return out
        return call

    root = Path(tempfile.mkdtemp(prefix="gsgen_outputs_"))
    patch(upsample, "tune_with_upsample", counted)
    patch(upsample, "adam_update", stamped)
    patch(upsample, "render_batch", recorded)
    for mod, name in ((export_mod, "to_ply"), (export_mod, "to_splat"),
                      (export_mod, "to_mesh"),
                      (ckpt_mod, "save_checkpoint"),
                      (evaluation, "eval_image"),
                      (evaluation, "eval_video")):
        patch(mod, name, timed(name))
    try:
        t0 = time.perf_counter()
        rc = main_mod.main(["--config", str(cfg_path), "--steps", "3",
                            "--log-root", str(root), *overrides])
        wall_s = time.perf_counter() - t0
        require(rc == 0, f"phase 11: gsgen_torch.main returned {rc}")
        runs = [p for p in root.glob("*/*/*") if p.is_dir()]
        require(len(runs) == 1, f"phase 11: run directories {runs}")
        run = runs[0]

        # the fine-tune: the 64^2 renders (K1, K3, K4), then every step's
        # 256^2 render forward and backward (K1-K4), once per view
        views_lo = tune["num_poses"] // tune["batch"] * tune["batch"]
        views_hi = tune["epoch"] * views_lo
        want = dict(raster_fwd=views_lo + views_hi, raster_bwd=views_hi,
                    expansion_rank=views_lo + views_hi,
                    gid_repack=views_lo + views_hi)
        got = tune["launches"]
        require(all(got[k] == want.get(k, 0) for k in got),
                f"phase 11: fine-tune launches {got}, expected {want}")
        losses = tune["losses"]
        per_epoch = views_lo // tune["batch"]
        require(len(losses) == tune["epoch"] * per_epoch
                and all(math.isfinite(x) for x in losses)
                and sum(losses[-per_epoch:]) < sum(losses[:per_epoch]),
                f"phase 11: fine-tune losses {losses} (the last epoch's "
                "must sum below the first's)")
        step_ms = [1e3 * (b - a) for a, b in zip(stamps, stamps[1:])]

        files = {p.relative_to(run).as_posix(): p for p in run.rglob("*")
                 if p.is_file()}
        for need in ("config.json", "scalars.jsonl",
                     "ckpts/step_2/arrays.npz", "ckpts/step_3/arrays.npz",
                     "eval/eval_image_000000.png",
                     "eval/eval_image_000001.png",
                     "eval/eval_image_000002.png", "exports/scene.ply",
                     "exports/scene.splat", "exports/scene.obj"):
            require(need in files and files[need].stat().st_size > 0,
                    f"phase 11: {need} missing or empty in {sorted(files)}")
        video = [k for k in files if "orbit" in k]
        require(video, f"phase 11: no orbit video in {sorted(files)}")

        # a fresh trainer of the same config resumes from the final
        # checkpoint: every array equal
        fresh = build_trainer(load_config(cfg_path, overrides),
                              device="cuda")
        require(fresh.load(run / "ckpts") == 3 and fresh.state.step == 3,
                "phase 11: the final checkpoint is not step 3")
        with np.load(run / "ckpts" / "step_3" / "arrays.npz") as data:
            disk = dict(data)
        mine = ckpt_mod.state_arrays(fresh.state, fresh.cfg.seed)
        require(list(mine) == list(disk), "phase 11: checkpoint keys differ")
        bad = [k for k in disk if not np.array_equal(mine[k], disk[k])]
        require(not bad, f"phase 11: arrays differ after load: {bad}")
        live = int(fresh.state.scene.active.sum())
        del fresh
        obj = files["exports/scene.obj"].read_text().splitlines()
        faces = sum(1 for ln in obj if ln.startswith("f "))
        require(faces > 0, "phase 11: the mesh has no face")
        require(files["exports/scene.splat"].stat().st_size == 32 * live,
                "phase 11: splat records != live Gaussians")
        # an orbit of PNG frames (no imageio) counts as one output
        sizes = {}
        for k, p in files.items():
            k = k.rsplit("/", 1)[0] if "/orbit_" in k else k
            sizes[k] = sizes.get(k, 0) + p.stat().st_size
        res = dict(
            run_wall_s=wall_s, seconds=seconds, bytes=sizes,
            video=sorted({k.rsplit("/", 1)[0] if "/orbit_" in k else k
                          for k in video}), video_files=len(video),
            live=live, mesh_faces=faces,
            fine_tune=dict(launches=got, losses=losses,
                           kernel_checks=tune["kernel_checks"],
                           seconds=tune["seconds"],
                           ms_per_step=step_ms,
                           steps=len(losses), reso=tune["reso"],
                           batch=tune["batch"]))
    finally:
        for mod, name, fn in reversed(patched):
            setattr(mod, name, fn)
        shutil.rmtree(root, ignore_errors=True)
    med = sorted(step_ms)[len(step_ms) // 2]
    print(f"phase 11 outputs: ok | card {card} | gsgen_torch.main "
          f"flagship_rehearsal.yaml --steps 3 {' '.join(overrides)}: "
          f"{wall_s:.2f} s | fine-tune {len(losses)} steps at "
          f"{tune['reso']}^2, batch {tune['batch']}: {tune['seconds']:.3f} s"
          f" in all, median {med:.2f} ms/step (after the first), loss "
          f"{losses[0]:.5f} -> {losses[-1]:.5f}, launches {got} | K1-K4 "
          "against their plain versions on the tuned scene: "
          + " | ".join(tune["kernel_checks"]) + " | "
          + " | ".join(f"{k} {', '.join(f'{x:.3f}' for x in v)} s"
                       for k, v in seconds.items())
          + " | bytes: " + ", ".join(
              f"{k} {v}" for k, v in sorted(res["bytes"].items()))
          + f" | orbit video: {res['video']} ({len(video)} files)"
          f" | mesh faces {faces} | checkpoint loaded into a fresh "
          "trainer: every array equal", flush=True)
    return res


DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
RASTER = ("raster_fwd", "raster_bwd", "raster_fwd_compact",
          "raster_bwd_compact")
RASTER_DESIGN = dict(
    fwd="one block a tile, one thread a pixel, exact sequential scan over "
        "the tile's own rows only (walk ends at ends[t]); windows by "
        "cp.async.bulk into a 2-stage mbarrier ring; geometry rows read 4 "
        "lanes per 16-byte load, features only where aG > 0",
    bwd="one block a tile, one thread a pixel, forward recomputed over the "
        "tile's own rows only; per-lane gradient rows summed over a warp "
        "by a 16-shuffle transpose-reduce, warps added in fixed order (no "
        "atomics); windows by cp.async.bulk into a 2-stage mbarrier ring")


def flash_peak(dtn: str) -> float:
    """The operations rate a flash kernel's design can reach: bf16 tensor
    cores; 3xTF32 in fp32."""
    return PEAK_BF16_FLOPS if dtn == "bfloat16" else PEAK_3XTF32_FLOPS


def busy_us(events):
    """Union of the device events' [ts, ts + dur) spans, in us."""
    busy, end = 0.0, -math.inf
    for e in sorted(events, key=lambda e: e["ts"]):
        s, d = float(e["ts"]), float(e["dur"])
        busy += max(0.0, s + d - max(s, end))
        end = max(end, s + d)
    return busy


def ptxas_lines(log, needle):
    """{kernel: "registers and shared memory; stack and spills"} from
    ptxas's -v report for each function whose name holds ``needle``."""
    res, func = {}, ""
    for ln in log.splitlines():
        if "Function properties for" in ln:
            func = ln.split(" for ", 1)[1].strip()
            continue
        if needle not in func or not ("spill" in ln or "registers" in ln):
            continue
        short = re.search(r"(raster_\w+?kernel)", func)
        key = short.group(1) if short else func
        res[key] = "; ".join(filter(None, (res.get(key), ln.split(
            ":", 1)[-1].strip() if "registers" in ln else ln.strip())))
    return res


def kernel_key(name):
    """A device kernel's name without its template and argument lists."""
    key = name.replace("(anonymous namespace)::", "").replace("void ", "")
    return key.split("(")[0].split("<")[0][-48:]


PER_VIEW = dict(padded=("raster_fwd", "raster_bwd", "expansion_rank",
                        "gid_repack"),
                compact=("raster_fwd_compact", "raster_bwd_compact",
                         "expansion_rank"))


def drive(torch, build_trainer, load_config, wrappers, cfg_names, overrides,
          n_steps, flash_per_step, layout="padded", on_step=None):
    """``n_steps`` training steps of a config (one file or a list merged in
    order) through build_trainer / fit with every kernel counter set to 0
    just before and read just after; losses finite and changing, every
    scene parameter and some trainable guidance leaf (if any) moved, the
    render kernels of ``layout`` (K1-K4, or K8, K9 and K3) once per view and
    no other render kernel, and each flash kernel ``flash_per_step[name]``
    (default 0) times a step.  ``on_step(trainer, step, metrics)`` runs
    after each step."""
    names = [cfg_names] if isinstance(cfg_names, str) else cfg_names
    label = " + ".join(names) + "".join(" " + o for o in overrides)
    trainer = build_trainer(load_config([ROOT / "configs" / n for n in names],
                                        overrides), device="cuda")
    p0 = {k: v.detach().clone() for k, v in trainer.state.scene.params.items()}
    gp0 = {k: v.detach().clone() for k, v in trainer.state.gp.items()}
    losses, stamps = [], []

    def step_cb(step, metrics):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        losses.append(float(metrics["loss_total"]))
        if on_step is not None:
            on_step(trainer, step, metrics)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for w in wrappers.values():
        w.launches = 0
    t_start = time.perf_counter()
    trainer.fit(n_steps, callback=step_cb)
    launches = {k: w.launches for k, w in wrappers.items()}
    views = n_steps * trainer.cfg.batch_size * trainer.cfg.grad_accum
    require(trainer.state.step == n_steps, f"{label}: step counter")
    require(all(math.isfinite(x) for x in losses), f"{label}: losses {losses}")
    require(len(set(losses)) > 1, f"{label}: loss never changed: {losses}")
    moved = {k: float((v - p0[k]).abs().max())
             for k, v in trainer.state.scene.params.items()}
    require(all(m > 0 for m in moved.values()),
            f"{label}: params not moved {moved}")
    gp_moved = max((float((v - gp0[k]).abs().max())
                    for k, v in trainer.state.gp.items()), default=None)
    require(gp_moved is None or gp_moved > 0,
            f"{label}: no trainable guidance leaf moved")
    for k, c in launches.items():
        want = (flash_per_step.get(k, 0) * n_steps if k.startswith("flash")
                else views if k in PER_VIEW[layout] else 0)
        require(c == want, f"{label}: {k} launched {c} times in {n_steps} "
                f"steps, expected {want}")
    res = dict(config=label, steps=n_steps,
               batch=trainer.cfg.batch_size,
               reso=trainer.data.intrinsics().w, losses=losses,
               ms_per_step=[1e3 * (b - a) for a, b in
                            zip([t_start] + stamps, stamps)],
               peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
               launches=launches, gp_max_move=gp_moved)
    return trainer, res


def sds_phases(torch, dev, build_trainer, load_config, wrappers):
    """Phase 7: the SDS loss on the card against the CPU (TINY backbone),
    then the slice config, base.yaml and flagship_rehearsal.yaml."""
    import copy

    from gsgen_torch.guidance.sd_unet import TINY, SDUNetBackbone
    from gsgen_torch.guidance.sds import SDSConfig, SDSGuidance
    from gsgen_torch.guidance.unet2d import set_fused_attention
    from gsgen_torch.prompt.processors import (PromptProcessor,
                                               PromptProcessorConfig)

    # the SDS loss and its render gradient, card vs CPU (fp32, TF32 off;
    # latent 16 puts the TINY UNet's level 0 at L = 256: K5 in fp32,
    # three launches)
    cpu = torch.device("cpu")
    bb_cpu = SDUNetBackbone(TINY, latent_size=16, device="cpu")
    bb_dev = copy.deepcopy(bb_cpu).to(dev)
    set_fused_attention(bb_dev, "on")
    g = torch.Generator(device="cpu").manual_seed(11)
    rgb = torch.rand(2, 40, 40, 3, generator=g)
    tt = torch.tensor([150, 800])
    noise = torch.randn(2, 16, 16, 4, generator=g)
    cams = (torch.tensor([10.0, 70.0]), torch.tensor([20.0, -160.0]),
            torch.tensor([2.5, 2.5]))
    out = {}
    for d, bb in ((cpu, bb_cpu), (dev, bb_dev)):
        guid = SDSGuidance(SDSConfig(), bb, device=d)
        emb = PromptProcessor(PromptProcessorConfig(use_cache=False),
                              device=d)()
        x = rgb.to(d).detach().requires_grad_(True)
        n0 = wrappers["flash_attn_fwd"].launches
        r = guid.loss(x, emb, *(c.to(d) for c in cams), t=tt.to(d),
                      noise=noise.to(d))
        r["loss_sds"].backward()
        out[d.type] = (float(r["loss_sds"].detach()), x.grad.cpu(),
                       wrappers["flash_attn_fwd"].launches - n0)
    (l_c, g_c, _), (l_d, g_d, k5) = out["cpu"], out["cuda"]
    require(k5 == 3, f"TINY SDS on the card launched K5 {k5} times, not 3")
    require(abs(l_d - l_c) <= 1e-3 * abs(l_c),
            f"TINY SDS loss card {l_d} vs CPU {l_c}")
    g_err = float((g_d - g_c).abs().max())
    require(g_err <= 1e-3 * float(g_c.abs().max()),
            f"TINY SDS rgb grad card vs CPU: max abs err {g_err:.3e}")
    del bb_cpu, bb_dev

    trainer, slice_res = drive(torch, build_trainer, load_config, wrappers,
                               "base.yaml", SLICE, 3,
                               dict(flash_attn_fwd=5))
    res = dict(tiny_card_vs_cpu=dict(loss=[l_c, l_d], grad_max_abs_err=g_err),
               slice=slice_res, launches=slice_res["launches"])
    print(f"phase 7 sds: ok TINY SDS loss card {l_d:.6g} vs CPU {l_c:.6g}, "
          f"rgb grad max abs err {g_err:.2e} | slice {slice_res['config']}: "
          f"{slice_res['steps']} steps, batch {slice_res['batch']}, "
          f"{slice_res['reso']}^2 | losses {slice_res['losses']} | ms/step "
          f"{[round(x, 2) for x in slice_res['ms_per_step']]} | peak "
          f"{slice_res['peak_gib']:.2f} GiB | launches "
          f"{slice_res['launches']}", flush=True)
    for name, k5 in (("base.yaml", 0), ("flagship_rehearsal.yaml", 5)):
        other, r = drive(torch, build_trainer, load_config, wrappers, name,
                         [], 2, dict(flash_attn_fwd=k5))
        del other
        torch.cuda.empty_cache()
        res[name] = r
        print(f"phase 7 sds: ok {name}: 2 steps, batch {r['batch']}, "
              f"{r['reso']}^2 | losses {r['losses']} | ms/step "
              f"{[round(x, 2) for x in r['ms_per_step']]} | peak "
              f"{r['peak_gib']:.2f} GiB | launches {r['launches']}",
              flush=True)
    res["trainer"] = trainer
    return res


def vsd_phases(torch, dev, build_trainer, load_config, wrappers):
    """Phase 9: the VSD losses and gradients on the card against the CPU
    (TINY_VSD backbone, injected draws), then the slice config."""
    import copy

    from gsgen_torch.guidance.sd_unet import TINY_VSD, SDUNetBackbone
    from gsgen_torch.guidance.unet2d import set_fused_attention
    from gsgen_torch.guidance.vsd import VSDConfig, VSDGuidance
    from gsgen_torch.prompt.processors import (PromptProcessor,
                                               PromptProcessorConfig)

    # fp32, TF32 off; latent 16 puts TINY_VSD's level 0 at L = 256: per
    # loss three UNet passes of three fused self-attentions (9 K5), one
    # of them differentiated (3 K6, 3 K7)
    cpu = torch.device("cpu")
    bb_cpu = SDUNetBackbone(TINY_VSD, latent_size=16, device="cpu",
                            fp32_unet=True)
    bb_dev = copy.deepcopy(bb_cpu).to(dev)
    set_fused_attention(bb_dev, "on")
    g = torch.Generator(device="cpu").manual_seed(12)
    rgb = torch.rand(2, 40, 40, 3, generator=g)
    c2ws = torch.randn(2, 3, 4, generator=g)
    draws = dict(t=torch.tensor([150, 800]),
                 noise=torch.randn(2, 16, 16, 4, generator=g),
                 t_lora=torch.tensor([40, 600]),
                 noise_lora=torch.randn(2, 16, 16, 4, generator=g))
    cams = (torch.tensor([10.0, 70.0]), torch.tensor([20.0, -160.0]),
            torch.tensor([2.5, 2.5]))
    # non-zero up-projections: every trainable leaf then has a gradient
    train0 = {k: v + 0.02 * torch.randn(v.shape, generator=g)
              if k.endswith("up.weight") else v for k, v in
              VSDGuidance(VSDConfig(), bb_cpu,
                          device="cpu").trainable_params.items()}
    flash = [k for k in wrappers if k.startswith("flash")]
    out = []
    for d, bb in ((cpu, bb_cpu), (dev, bb_dev)):
        guid = VSDGuidance(VSDConfig(), bb, device=d)
        emb = PromptProcessor(PromptProcessorConfig(use_cache=False),
                              device=d)()
        x = rgb.to(d).requires_grad_(True)
        train = {k: v.to(d).requires_grad_(True) for k, v in train0.items()}
        n0 = {k: wrappers[k].launches for k in flash}
        r = guid.loss(x, emb, *(c.to(d) for c in cams), c2ws=c2ws.to(d),
                      train=train, drop=False,
                      **{k: v.to(d) for k, v in draws.items()})
        grads = torch.autograd.grad(r["loss_vsd"] + r["loss_lora"],
                                    [x] + list(train.values()))
        out.append((float(r["loss_vsd"].detach()),
                    float(r["loss_lora"].detach()),
                    [gr.cpu() for gr in grads],
                    {k: wrappers[k].launches - n0[k] for k in flash}))
    (v_c, l_c, g_c, _), (v_d, l_d, g_d, n_d) = out
    require(n_d == dict(flash_attn_fwd=9, flash_attn_bwd_dkv=3,
                        flash_attn_bwd_dq=3),
            f"TINY VSD on the card: flash launches {n_d}")
    require(abs(v_d - v_c) <= 1e-3 * abs(v_c),
            f"TINY VSD loss_vsd card {v_d} vs CPU {v_c}")
    require(abs(l_d - l_c) <= 1e-3 * abs(l_c),
            f"TINY VSD loss_lora card {l_d} vs CPU {l_c}")
    names = ["rgb"] + list(train0)
    g_errs = {}
    for nm, a, b in zip(names, g_d, g_c):
        scale = float(b.abs().max())
        require(scale > 0, f"TINY VSD: zero gradient for {nm}")
        err = float((a - b).abs().max())
        require(err <= 1e-3 * scale, f"TINY VSD grad {nm} card vs CPU: max "
                f"abs err {err:.3e} (max |grad| {scale:.3e})")
        g_errs[nm] = err / scale
    worst = max(g_errs, key=g_errs.get)
    del bb_cpu, bb_dev

    trainer, slice_res = drive(torch, build_trainer, load_config, wrappers,
                               VSD_CONFIGS, [], 3, VSD_FLASH)
    res = dict(tiny_card_vs_cpu=dict(
        loss_vsd=[v_c, v_d], loss_lora=[l_c, l_d], n_grads=len(names),
        worst_grad=[worst, g_errs[worst]]), slice=slice_res)
    print(f"phase 9 vsd: ok TINY_VSD card vs CPU: loss_vsd {v_d:.6g} vs "
          f"{v_c:.6g}, loss_lora {l_d:.6g} vs {l_c:.6g}, {len(names)} "
          f"gradients (rgb + every trainable leaf), worst {worst} max abs "
          f"err / max |grad| {g_errs[worst]:.2e} | slice "
          f"{slice_res['config']}: {slice_res['steps']} steps, batch "
          f"{slice_res['batch']}, {slice_res['reso']}^2 | losses "
          f"{slice_res['losses']} | ms/step "
          f"{[round(x, 2) for x in slice_res['ms_per_step']]} | peak "
          f"{slice_res['peak_gib']:.2f} GiB | LoRA max move "
          f"{slice_res['gp_max_move']:.3e} | launches "
          f"{slice_res['launches']}", flush=True)
    res["trainer"] = trainer
    return res


def slice_phases(torch, dev, build_trainer, load_config, wrappers):
    """Phase 10: 3 SDS steps of base.yaml in the compact layout (K8, K9 and
    K3 once per view, K1, K2 and K4 never), then 6 steps of base.yaml +
    renderer/regular.yaml (compact, mock guidance) through a densify event
    (step 3) and a prune event (step 5): the live count must rise at the
    first and fall at the second, and the Adam moments of every slot that
    turned live or dead must be 0.  Returns the trainer of the second run
    for the checks on its scene."""
    from gsgen_torch.models.scene import FIELDS

    trainer, sds_c = drive(torch, build_trainer, load_config, wrappers,
                           "base.yaml", SLICE + COMPACT, 3,
                           dict(flash_attn_fwd=5), layout="compact")
    print(f"phase 10 compact sds: ok {sds_c['config']}: {sds_c['steps']} "
          f"steps, batch {sds_c['batch']}, {sds_c['reso']}^2 | losses "
          f"{sds_c['losses']} | ms/step "
          f"{[round(x, 2) for x in sds_c['ms_per_step']]} | peak "
          f"{sds_c['peak_gib']:.2f} GiB | launches {sds_c['launches']}",
          flush=True)
    from gsgen_torch.ops import cuda_lib
    sds_c["profile"] = profile_step(
        torch, trainer, cuda_lib.BUILD / "sds_compact_step_trace.json",
        False, phase="10 compact sds")
    del trainer
    torch.cuda.empty_cache()

    live, events, prev = [], [], {}

    def on_step(tr, step, metrics):
        active = tr.state.scene.active.clone()
        if "active" in prev:
            turned = prev["active"] ^ active        # new or freed slots
            if bool(turned.any()):
                worst = max(float(getattr(tr.state.opt, m)[f][turned].abs()
                                  .max()) for m in ("mu", "nu")
                            for f in FIELDS)
                require(worst == 0.0, f"step {step}: Adam moments of new or "
                        f"freed slots not zero (max {worst})")
        prev["active"] = active
        live.append(int(active.sum()))
        events.append({k: int(v) for k, v in metrics.items()
                       if k.startswith("num_")})

    trainer, reg = drive(torch, build_trainer, load_config, wrappers,
                         DENSITY_CONFIGS, DENSITY, 6, {}, layout="compact",
                         on_step=on_step)
    require(events[3].get("num_split", 0) + events[3].get("num_clone", 0) > 0
            and live[3] > live[2],
            f"densify at step 3 did not grow the scene: {live} {events}")
    require(sum(v for k, v in events[5].items() if "pruned" in k) > 0
            and live[5] < live[4],
            f"prune at step 5 did not shrink the scene: {live} {events}")
    require(all(not e for i, e in enumerate(events) if i not in (3, 5)),
            f"density events outside steps 3 and 5: {events}")
    reg.update(live=live, events=events, overrides=DENSITY)
    print(f"phase 10 density: ok {reg['config']}: {reg['steps']} steps | "
          f"live Gaussians per step {live} | events {events} | losses "
          f"{reg['losses']} | ms/step "
          f"{[round(x, 2) for x in reg['ms_per_step']]} | peak "
          f"{reg['peak_gib']:.2f} GiB | launches {reg['launches']}",
          flush=True)
    return dict(sds_compact=sds_c, regular=reg, trainer=trainer)


def compactness_event(torch, trainer):
    """One densify_compactness event on the card at the trainer's capacity
    (65,536 in base.yaml): peak memory and time of the row-blocked KNN and
    the gap fill."""
    from gsgen_torch.models import density
    from gsgen_torch.models.scene import FIELDS
    from gsgen_torch.training.optimizer import AdamState

    opt = trainer.state.opt
    scene_opt = AdamState(mu={k: opt.mu[k] for k in FIELDS},
                          nu={k: opt.nu[k] for k in FIELDS}, count=opt.count)
    scene = trainer.state.scene
    cap = scene.active.shape[0]
    live0 = int(scene.active.sum())
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    new, _, info = density.densify_compactness(scene, scene_opt,
                                               trainer.dcfg, trainer.rcfg)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0)
    peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
    live1 = int(new.active.sum())
    require(info["num_compact"] > 0 and live1 == live0 + info["num_compact"],
            f"compactness event: {info}, live {live0} -> {live1}")
    res = dict(capacity=cap, live_before=live0, live_after=live1,
               ms=ms, peak_gib_above_start=peak, **info)
    print(f"phase 10 compactness: ok capacity {cap}: live {live0} -> "
          f"{live1} ({info['num_compact']} new) in {ms:.1f} ms, peak "
          f"{peak:.3f} GiB above what was allocated before", flush=True)
    return res


def profile_step(torch, trainer, trace, vsd, phase=None):
    """Phase 8 (SDS), the end of phase 9 (VSD) and phase 10 (SDS in the
    compact layout): one step under
    torch.profiler.  Each device op is attributed to the host range its
    launch fell in: the render forward, the UNet (SDS: ``predict_noise``;
    VSD: every UNet call, "unet_fwd"), the VAE forward and the VAE
    backward (between the gradient reaching the latents and leaving the
    images).  VSD's UNet backward ("unet_bwd") runs from the gradient
    reaching the LoRA pass's output until the VAE backward starts: the
    autograd engine takes the later-recorded UNet branch first.  Other
    launches from the backward thread are the render backward, the rest is
    "other" (optimizer, losses, guidance glue)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    import gsgen_torch.training.trainer as trainer_mod

    bb = trainer.guidance.backbone
    orig_render, orig_encode = trainer_mod.render_batch, bb.encode_images
    span = {}

    def open_span(name):
        span[name] = record_function(f"step:{name}")
        span[name].__enter__()

    def close_span(name):
        if name in span:
            span.pop(name).__exit__(None, None, None)

    def render_batch(*a, **kw):
        with record_function("step:render"):
            return orig_render(*a, **kw)

    def encode_images(imgs):
        def start(grad):
            close_span("unet_bwd")
            open_span("vae_bwd")

        def stop(grad):
            close_span("vae_bwd")
            close_span("unet_bwd")

        if imgs.requires_grad:
            imgs.register_hook(stop)
        with record_function("step:vae"):
            z = orig_encode(imgs)
        if z.requires_grad:
            z.register_hook(start)
        return z

    if vsd:
        orig_unet = bb.unet.forward

        def unet_forward(*a, **kw):
            with record_function("step:unet_fwd"):
                out = orig_unet(*a, **kw)
            if out.requires_grad:
                out.register_hook(lambda grad: open_span("unet_bwd"))
            return out

        bb.unet.forward = unet_forward
    else:
        orig_pred = bb.predict_noise

        def predict_noise(*a, **kw):
            with record_function("step:unet"):
                return orig_pred(*a, **kw)

        bb.predict_noise = predict_noise
    trainer_mod.render_batch = render_batch
    bb.encode_images = encode_images
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            trainer.fit(1)
            torch.cuda.synchronize()
            wall_ms = 1e3 * (time.perf_counter() - t0)
    finally:
        trainer_mod.render_batch = orig_render
        del bb.encode_images
        if vsd:
            del bb.unet.forward
        else:
            del bb.predict_noise
    prof.export_chrome_trace(str(trace))
    what = "a VSD step" if vsd else "an SDS step"
    ev = [e for e in json.loads(trace.read_text())["traceEvents"]
          if e.get("ph") == "X"]
    dev_ev = [e for e in ev if e.get("cat") in DEVICE_CATS]
    require(len(dev_ev) > 0, f"the profiler saw no device work in {what}")
    launch = {e["args"]["correlation"]: (e["ts"], e["tid"]) for e in ev
              if e.get("cat") == "cuda_runtime"
              and "correlation" in e.get("args", {})}
    spans = [(e["name"][5:], e["ts"], e["ts"] + e["dur"], e["tid"])
             for e in ev if e.get("cat") == "user_annotation"
             and e["name"].startswith("step:")]
    bwd_tids = {tid for name, _, _, tid in spans if name == "vae_bwd"}

    def group(e):
        hit = launch.get(e.get("args", {}).get("correlation"))
        if hit is None:
            return "unattributed"
        ts, tid = hit
        for name, a, b, stid in spans:
            if stid == tid and a <= ts <= b:
                return "vae" if name.startswith("vae") else name
        return "render" if tid in bwd_tids else "other"

    # a part's device ms is the union of its ops' spans: cuDNN runs some
    # fp32 convolutions on side streams, so kernel times overlap
    by_group, by_name = {}, {}
    for e in dev_ev:
        grp = group(e)
        by_group.setdefault(grp, []).append(e)
        key = (grp, kernel_key(e["name"]))
        by_name[key] = by_name.get(key, 0.0) + float(e["dur"]) / 1e3
    by_group = {k: busy_us(v) / 1e3 for k, v in by_group.items()}
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    busy_ms = busy_us(dev_ev) / 1e3
    streams = {e.get("args", {}).get("stream") for e in dev_ev}
    info = dict(traced_ms_per_step=wall_ms, device_busy_ms_per_step=busy_ms,
                device_idle_share=1.0 - busy_ms / wall_ms,
                device_ops_per_step=len(dev_ev), device_streams=len(streams),
                device_ms_by_part=by_group,
                top_device_ms=[[g, k, v] for (g, k), v in top])
    phase = phase or ("9 vsd" if vsd else "8 sds")
    print(f"phase {phase} profile: ok 1 "
          f"traced step, {wall_ms:.2f} ms, device "
          f"busy {busy_ms:.2f} ms (idle share "
          f"{info['device_idle_share']:.3f}), {len(dev_ev)} device ops on "
          f"{len(streams)} streams | by part (device ms, union of its "
          "ops' spans): " + ", ".join(
              f"{k} {v:.2f}" for k, v in sorted(by_group.items(),
                                                 key=lambda kv: -kv[1]))
          + " | top (summed kernel ms): " + "; ".join(
              f"[{g}] {k} {v:.3f} ms" for (g, k), v in top), flush=True)
    return info


if __name__ == "__main__":
    sys.exit(main())
