#!/usr/bin/env python3
"""Smoke test of the PyTorch port (gsgen_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each reported on its own line:

1. device: require CUDA, print the card's name and power limit, TF32 off
   (the package's precision policy, utils/precision.py::exact_fp32);
2. build: compile gsgen_torch/csrc/*.cu with nvcc for sm_90a; the raster
   kernels' ptxas lines (registers, shared memory, spills: none allowed)
   and those of K5's fp32 wgmma + TMA instances (P V 16, 32 and 64 wide),
   K6 / K7's fp32 ones, K6 / K7's bf16 instances of widths 80 and 160 and
   the 3xTF32 convolution's 1x1 and 3x3 instances (no spill, and no wgmma
   that ptxas serialised);
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
   1.5's level 0 [8, 4096, 8, 40] in bf16, in fp32 a small [2, 256, 2,
   64], one tile [2, 128, 3, 64] and SD 1.5's width [2, 1024, 8, 40] (TMA
   zero fill past D), and in bf16 [1, 4096, 2, 64] (the whole TMA ring on
   few CTAs), [2, 128, 3, 40] (one tile, TMA zero fill past D) and, with
   its lse, [2, L, 2, D] at L = 128, 256, 1024 and D = 16, 24, 40, 64, 72,
   80, 136, 160 (every P V width the bf16 instance is built for, and
   widths that round up to the next), at the IF-II upsampler's levels [2,
   16384, 8,
   16] and [2, 4096, 8, 32] in fp32 and bf16 (bf16 there also each
   element within one bf16 step plus 5% of the output's RMS) and at phase
   14 d's TINY_SR level 0 [8, 65536, 2, 16] in fp32 (the plain version on
   its first, a middle and its last 2,048 queries) and SDXL's level 1
   [8, 4096, 10, 64] in bf16 (the 1024^2 SDS step's K5 shape); and
   K5's lse, K6 (dK, dV) and K7 (dQ) against
   the plain backward at the VSD path's [4, 4096, 5, 64] in fp32 and
   bf16 (K7 fp32 there also within 1e-5 of max|dq|), a small
   [2, 256, 2, 64] in fp32, [1, 4096, 2, 64] in bf16, SD 1.5's `on`
   levels [2, 1024, 8, 80] and [2, 256, 8, 160] and the width between
   them [2, 256, 2, 120] in bf16 (the wide instances, TMA zero fill past
   D), [2, 128, 3, 40] in bf16 (one tile, TMA zero fill), in fp32 [2, 1024,
   8, 40] (SD 1.5's width, zero fill past D), [2, 128, 3, 8] (one tile,
   one k-step of head dims) and [2, 256, 2, 160]
   in fp32, each error also as a share of the gradient's max, and
   autograd through K5 + K6 + K7 against autograd through the plain path;
   and the 3xTF32 convolution against F.conv2d in fp32 within 1e-5 of
   the output's largest value (CONV_CASES: the VSD path's shapes at
   batch 8 and 4 with each K split split_k picks there, 1, 2, 4 and 8
   ways; CONV_EDGE_CASES: the VAE's (0, 1) padding, ragged channel and
   pixel tiles);
4. train: configs/base.yaml with guidance.type=mock, 5 training steps at
   full width through build_trainer / fit, with every kernel's launch
   counter read around the run;
5. times: each kernel, its plain version and, where one exists, one
   PyTorch call computing the same function, at the bench and base.yaml
   shapes (K5 at SD 2.1's level 0, SDPA its library yardstick; K6 and K7 at
   [4, 4096, 5, 64] in fp32 and bf16, each also in device time, SDPA's
   backward theirs in device time from a profiler trace, K6 + K7 summed
   beside it, and in bf16 at SD 1.5's `on` levels [4, 1024, 8, 80] and
   [4, 256, 8, 160] in device time beside SDPA's backward; SDPA in fp32 beside
   K5's fp32 instance at B=8 and B=4), K1-K4, K8, K9 and torch.searchsorted
   by device time (a CUDA graph of 50 calls replayed between two events)
   beside their host-loop times, the lanes each tile's forward walked (max,
   mean) at both render shapes, and the full render forward+backward in
   both layouts; one line gives every K5/K6/K7 instance's ms, TFLOP/s,
   share of its bound and SDPA's time, with the bound at the rate its
   design can reach (bf16 989 TFLOP/s, K5 bf16 also its exp2 a score on the
   SFU at 4.18e12 a second: gsgen_torch/tools/k5_bench.py::bound_ms; fp32
   3xTF32 3 x ops / 495 TFLOP/s); K5 fp32 at the IF-II upsampler's two
   levels with its plain version and SDPA in fp32;
6. profile: two more training steps under torch.profiler; device busy
   time, idle share and the top device kernels per step (the trace goes
   to gsgen_torch/_build/train_step_trace.json);
7. sds: the slice, configs/base.yaml with SDS on the SD 2.1 UNet and VAE
   in bf16 (random weights, mock prompt embeddings) for 3 steps at 512^2,
   batch 4, with K1-K5's launch counters read around the run; first the
   SDS loss and its render gradient on a TINY backbone on the card
   against the same on the CPU; then 2 steps each of configs/base.yaml
   as it is (SDS on MockUNet) and configs/flagship_rehearsal.yaml; then
   2 steps of SDS on SDXL base 1.0 at full width (configs/base.yaml +
   guidance/sdxl.yaml + prompt/sd.yaml, 4 views of 1024^2, 4,096
   Gaussians at capacity 65,536) with the counters set to 0 just before:
   K5 10 times a step (SDXL_K5_PER_STEP), K1-K4 once a view, no 3xTF32
   convolution (bf16);
8. sds profile: one slice step under torch.profiler, device time split
   into render, VAE and UNet (trace: gsgen_torch/_build/sds_step_trace.json);
9. vsd: the VSD losses and the gradients of the render and of every
   trainable leaf on a TINY_VSD backbone (L = 256, fused attention on) on
   the card against the CPU; then 3 steps of configs/base.yaml +
   guidance/vsd.yaml + prompt/vsd.yaml (SD 2.1 UNet in fp32 with LoRA and
   camera conditioning, VAE in bf16, 512^2, batch 4) with every launch
   counter read around them (15 K5, 5 K6, 5 K7 a step) and a LoRA leaf
   required to move; then one VSD step under torch.profiler, device time
   split into render, VAE, UNet forward and UNet backward, with K5's,
   K6's and K7's device ms and launches in the step (trace:
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
   the final checkpoint loaded into a fresh trainer, every array equal;
   with trainer.guidance_eval_period=2 the guidance-eval sample at step 2
   (SD 2.1 bf16, 25 CFG steps: 125 K5 launches, counters set to 0 around
   it) and with trainer.profile_steps=[1, 2] the profiler trace of step 1
   (device ops required).
   Phase 3 also holds K3 bitwise on count patterns the renders do not
   reach (total 0, total past cap, N 1, zero-count runs, ragged cap) and
   phase 5 prints K3 (render shapes and edge cases), torch.searchsorted
   and a one-element add (the floor that launch spacing sets) in device
   time;
12. point_e: FPS at capacity 65,536 (4,096 active, 1,024 samples), one
   base40M-textvec forward at full width and the aux loss and its mean
   gradient (TINY) on the card against the CPU; the forward's device time
   at the aux batch [8, 6, 1024]; ``point_e_generate`` on seeded
   random-weight base40M-textvec and upsample ``.pt`` checkpoints (64 + 64
   Karras steps) into a temporary GSGEN_ASSET_DIR, its seconds, then a
   cache hit; 3 steps of configs/corgi.yaml with the SD 2.1 overrides,
   ``init.type=point_e`` on those checkpoints and the aux guidance on
   base40M-textvec (1,024 points, batch 4) at 512^2, batch 4, with the
   launch counters read around them, ``loss_aux`` finite and non-zero and
   the aux term's mean gradient non-zero; one such step under
   torch.profiler with a "point_e" part (FPS and the transformer) and
   FPS's device ops (trace: gsgen_torch/_build/point_e_step_trace.json);
   2 steps of configs/corgi.yaml as it ships (mock aux, MockUNet);
13. render extras: (a) configs/base.yaml + renderer/mlp_bg.yaml on the
   SD 2.1 slice (bf16, 512^2, batch 4, capacity 65,536): 2 steps with the
   launch counters read around them, then one step under torch.profiler
   with a "background" part (the SH-MLP over 262,144 rays a view), the
   MLP's forward and backward for 4 views timed alone (trace:
   gsgen_torch/_build/mlp_bg_step_trace.json); (b) base.yaml +
   renderer/legacy.yaml (SH degree 1), mock guidance, 3 steps; (c)
   base.yaml + renderer/normal_as_rgb.yaml (estimated normals, k = 30
   over capacity 65,536), mock guidance, 2 steps and one profiled with a
   "normals" part, knn_self and the batched 3x3 eigh timed alone, and the
   card's normals against the CPU's on a sphere of 4,096 points; (d)
   base.yaml with pbr (learned normals, render_normal: F = 8), the
   learned_const background with random_aug at 0.5 and every penalty at a
   nonzero weight, 3 steps in the padded and 3 in the compact layout
   (K1-K4, or K8, K9 and K3, once per view), each run's first view held
   through K1-K4 and K8/K9 against their plain versions at F = 8, and K1,
   K2, K8, K9 timed in device time at F = 8 and at F = 5 on that view;
   (e) the configuration of (d) at RES 32 with mock guidance, one step on
   the card and on the CPU from the same state with the same background
   draws: loss, each penalty and each field's gradient;
14. sampling and DeepFloyd IF: (a) DDIM (eta 0 and 0.5), PNDM and
   ancestral CFG samples on the TINY UNet, the card against the CPU on
   the same injected draws; (b) VSD's sample (through the trainer's
   guidance-eval hook) and sample_lora at full width, 25 steps each (SD
   2.1 UNet fp32 + LoRA + camera; 125 K5 launches each); (c)
   guidance/if.yaml over base.yaml at full width (IF_PIXEL bf16, 64^2
   pixel space, batch 4, prompts at T5-XXL's width): 3 SDS steps and one
   guidance sample with no K5 launch, and the TINY IF loss and its render
   gradient on the card against the CPU; (d) the IF-II upsampler
   (IF2_PIXEL, random weights) at a 256^2 target, B = 1, 3 of the
   config's 50 steps, then the upsample fine-tune through
   make_diffusion_upsampler (TINY_SR, 3 steps) on 8 poses; each part's
   ms, peak GiB and launches;
15. image-to-3D: (a) card against CPU at TINY sizes from one state and
   one set of draws: an image step at RES 32 (TINY SD, a TINY DPT depth
   estimator, the grad mask on: every loss and field gradient), the TINY
   CLIP text and vision towers, encode_grid's cubic resize, the TINY
   grid Point-E and Make-It-3D's clip_ref_loss; (b) base.yaml +
   data/sit3d.yaml (378^2, batch 4) on a shaded-sphere PNG (auto-matted),
   its depth from a random-weight DPT-hybrid omnidata .ckpt, the DPT
   depth estimator on every render, SD 2.1 bf16: 3 steps with the
   counters read (K1-K4 once a view, K5 5 a step), every loss term
   finite, the 4,096 front rows bitwise frozen and the others moved, the
   first view through K1-K4 against plain; one step profiled (render,
   vae, unet, dpt, other) and DPT's forward + backward timed alone;
   (c) the normal estimator (3-channel DPT, mock guidance),
   2 steps, F = 8 through K1/K2; (d) init.type=point_e_image on
   random-weight base40M-image, upsample and ViT-L/14 .pt checkpoints
   (64 + 64 Karras steps at CFG 3), then a cache hit; (e) Make-It-3D at
   full width (random ViT-B/16 on the SD 2.1 bf16 backbone, 4 views at
   378^2, 2 original): loss_sds + loss_clip, the rgb gradient, ms;
16. weights and tokenizers from model directories (random weights
   written by the script as safetensors with a writer of its own, read
   back by the port's reader; tokenizer files at full vocabulary size,
   written by the script, read by the port's own reader,
   prompt/tokenizer_files.py, with transformers and tokenizers never
   imported; each tokenizer's host ms): (a) a random SD 1.5 diffusers
   directory (unet/ fp16, vae/ fp32, text_encoder/ the ViT-L/14 text
   tower fp32, tokenizer/ CLIP's 49,408 ids and 48,894 merges), every
   tensor read back bitwise, and base.yaml + guidance/sd.yaml +
   prompt/sd.yaml through guidance.weights_path and prompt.model_id
   (512^2, batch 4, bf16, padded, fused attention "auto") for 3 steps
   from the prompt's text (prompt, negative and view prompts through the
   port's tokenizer: start / end / pad ids, one id a word, the words
   back from the ids; then the ViT-L/14 tower), the backbone's weights
   bitwise the file's in bf16, K5 5 a step; its first view
   through K1-K4 and the step's own K5 q, k, v [8, 4096, 8, 40] against
   their plain versions; one step profiled (render, vae, unet, other, K5's
   device ms); then 2 steps of the same directory under fused_attention
   "on" (K5 15 a step: also levels 1 and 2, [8, 1024, 8, 80] and [8, 256,
   8, 160]), one of them profiled; the step's own q, k, v at each of the
   three levels against the plain version, each timed beside SDPA and
   the bound; then python -m gsgen_torch.main on the same directory for
   2 steps, the way a user starts a scene; (b) the T5 v1.1 XXL encoder
   (4096 wide, 24 layers, random fp32 weights made on the card) as the
   prompt encoder of guidance/if.yaml (IF_PIXEL) for 2 steps, its texts
   tokenized from a spiece.model of 32,000 pieces + 100 extra ids (no
   <unk>, </s> then <pad>, the pieces give the text back), [10, 77] ids
   with a padding mask, its encode ms and peak memory; (c) BERT-base from
   a written safetensors directory with a vocab.txt of 30,522 entries in
   bert-base-uncased's layout as the fill-mask probe
   (bert_fill_mask(model_dir)): [MASK] kept whole, no [UNK]; the per-view
   prompts from get_debiased_prompt(model_dir=...) and through the prompt
   processor's debiasing_model_id, the probe's ms; (d)
   init.type point_cloud (a .ply), mesh (an .obj icosphere) and shap_e
   (a full-width random text300M: 64 Karras steps at CFG 15 on the
   projected text vector of (a)'s tower on (a)'s tokenizer's ids,
   decoded at grid 128 by a random
   vector decoder), each with its init seconds, then 2 mock steps at
   capacity 65,536;

17. the tools around a trained scene, each at its own full size: (a)
   tools/demo_recon.py's 400-step recipe (64^2, batch 4, capacity
   16,384, densify and prune at 100 / 200 / 300) with K1-K4's counters
   read around it and its first view through K1-K4 against plain; the
   orbit PSNR must reach 29.0 dB (the JAX package's chip bar); (b) a
   base.yaml checkpoint (capacity 65,536, mock, 3 steps) written through
   gsgen_torch.main, then the snapshot CLI (photos at 1024^2, a 90-frame
   spiral at 512^2) as subprocesses, and in process the stills, the
   spiral and 30 relit frames at 512^2 with the counters read, every
   render's n_dup within dup_cap, the first still through K1-K4 against
   plain, the normals' time; (c) the viewer on port 0: /, /render at
   256 / 512 / 1024^2, four at once, /stats, each image decoded; (d) the
   rehearsal with --sd and --clip on a random SD 2.1 diffusers directory
   (its OpenCLIP ViT-H/14 text tower, a tokenizer/ that pads with "!";
   512^2, batch 4, bf16, 10 steps, eval every 5; K5 5 a step); (e)
   make_init_asset
   point_e on seeded random checkpoints into a temporary
   GSGEN_ASSET_DIR, then init.type=point_e from that file; (f) PSNR /
   SSIM / LPIPS at 512^2 on random .pth files, (g) undistort on 2^20
   points, (h) one Adan step over base.yaml's fields at capacity 65,536,
   each card against the CPU; (i) a two-config sweep of smoke.yaml
   through run_sweep_scheduled on one slot;
18. parallel (gsgen_torch.parallel), at base.yaml's render (512^2, tile
   16, chunk 256, dup_cap 2^20) on base.yaml's initial scene (capacity
   65,536) and on the bench scene (100K Gaussians, capacity 131,072):
   (a) one process, NCCL at world size 1: the tile-sharded and the
   Gaussian-sharded render and gradients of each scene's view against the
   unsharded render (images exact, gradients within 1e-5 of each field's
   largest), the data x tile render of 4 views, one Gaussian-sharded and
   one gauss x tile Adam step against the unsharded step, 2 steps of
   base.yaml (mock) with tile_mesh against 2 without; K1-K4's launches
   read from the counters; (b) two ranks on the one card over gloo, each
   rendering its 256-row slab of the bench view through K1-K4: the
   gathered image, the all-reduced tile-sharded and the reduce-scattered
   Gaussian-sharded gradients against the unsharded render, each slab's
   forward and backward device time, 4 Gaussian-sharded steps (ms/step)
   with a densify and a prune event; (c) dryrun_multichip over every card
   (NCCL, one rank a card);
19. c2f and presets: (a) configs/flagship_rehearsal.yaml with its
   resolution milestones moved to steps 10 and 20, 22 steps (SD 2.1 bf16,
   batch 4, 64^2 -> 256^2 -> 512^2), one line a resolution with the
   duplicate bucket before and at the switch, the bucket the JAX trainer's
   rule predicts from the n_dup_max of the feedback step before it (a
   bucket below it fails), n_dup_max, the padded demand against cap +
   pad_budget, ms/step and K1-K5's launches; (b) renderer/split_by_scale,
   renderer/progressive and shrink_then_densify through a densify event at
   step 2 at capacity 65,536 (mock guidance; the live count must change;
   the event's counts, ms and peak memory), and prompt/sd_perp_neg.yaml on
   the SD 2.1 slice for 2 steps (the perp-neg weights of every view,
   required each step);
20. conv: the 3xTF32 convolution's device ms at the seven SD 2.1 shapes
   with the most work, at batch 8, beside its plain version (cuDNN IEEE
   fp32, cudnn.benchmark off), cuDNN with cudnn.benchmark on (a fresh
   process) and the bound; its kernels row also carries its launches in
   phase 9's VSD steps (VSD_CONV a step, required) and phase 7's SDS
   drives (none, required);

then one JSON line with the kernels, the card line, and the result line.
Exits non-zero before the result line if any phase fails.
"""

from __future__ import annotations

import dataclasses
import json
import math
import re
import struct
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

# the H100 peaks, K5's bound (bf16: bytes, operations and one exp2 a score)
# and K6's / K7's, the CUDA-graph timer, SDPA's backward and the trace's
# device ops, shared with the K5 bench
from gsgen_torch.tools.k5_bench import (DEVICE_CATS,  # noqa: E402
                                        PEAK_3XTF32_FLOPS, PEAK_BF16_FLOPS,
                                        PEAK_BYTES, PEAK_FLOPS, busy_us,
                                        bwd_bound_ms, graph_ms, sdpa_bwd_ms)
from gsgen_torch.tools.k5_bench import bound_ms as k5_bound  # noqa: E402

# K5 (and its lse) against its plain version: max abs error over max
# |plain output|; K6 / K7: the same over each gradient's max |plain|
FLASH_TOL = {"bfloat16": 2e-2, "float32": 1e-4}
# K5 bf16's lse at phase 3's widths: absolute, 2^-9 for the rounding of the
# P that l sums and the rest for ex2.approx
K5_BF16_LSE_TOL = 2.0 ** -8
# K5 bf16 at the IF-II levels, where each output averages thousands of keys
# (typical |out| ~ max/20, so a limit on max|out| is loose): each element
# within one bf16 step of the plain value (2^-7 |plain|) plus this share of
# the plain output's RMS
FLASH_BF16_RMS_TOL = 0.05
FLASH_BWD_TOL = {"bfloat16": 3e-2, "float32": 1e-4}
# K7 fp32 (3xTF32) at the VSD path's shape: within this share of max|dq|
K7_FP32_VSD_TOL = 1e-5
SD21_ATTN = (8, 4096, 5, 64)    # SD 2.1 level-0 self-attention [B, L, H, D]
VSD_ATTN = (4, 4096, 5, 64)     # the same under VSD's LoRA pass (batch 4)
# SD 1.5's `fused_attention: on` levels at batch 4: K6 / K7's bf16
# instances of widths 80 and 160
SD15_ON_BWD = {"level 1": (4, 1024, 8, 80), "level 2": (4, 256, 8, 160)}
# the IF-II upsampler (IF2_PIXEL, 8 heads on 128 / 256 channels) at a 256^2
# target, CFG batch 2 (B = 1): its two K5 levels
IF2_ATTN = {"IF-II level 1": (2, 16384, 8, 16),
            "IF-II level 2": (2, 4096, 8, 32)}
# TINY_SR level 0 in phase 14 d's fine-tune at a 256^2 target (CFG batch 2
# x 4 views); the plain version takes it one block of queries at a time
TINY_SR_ATTN = (8, 65536, 2, 16)
K5_QUERY_BLOCK = 2048
# head widths of K5's bf16 card checks: every P V width it is built for
# (40, 64, 80, 160) and widths below and between them, which round up to
# the next; at 96 and 128 the third TMA box of the 160 instance lies wholly
# past D (phase 3)
K5_BF16_WIDTHS = (16, 24, 40, 64, 72, 80, 96, 128, 136, 160)
SD21_K5_PER_FWD = 5   # SD 2.1's level 0: 2 down + 3 up transformer blocks
SDXL_ATTN = (8, 4096, 10, 64)   # SDXL level-1 self-attention (CFG batch 8)
# SDXL's 4,096-token level: 2 down + 3 up stacks of 2 transformer blocks,
# one CFG pass a step (its 1,024-token level takes the plain path)
SDXL_K5_PER_STEP = 10
SDXL_CONFIGS = ["base.yaml", "guidance/sdxl.yaml", "prompt/sd.yaml"]
SDXL_SDS = ["data.reso=[1024]", "trainer.batch_size=4",
            "init.num_points=4096", "init.capacity=65536"]
IF_CONFIGS = ["base.yaml", "guidance/if.yaml", "prompt/if.yaml"]
SLICE = ["guidance.backbone=sd_unet", "guidance.backbone_preset=sd21",
         "guidance.backbone_dtype=bfloat16"]
VSD_CONFIGS = ["base.yaml", "guidance/vsd.yaml", "prompt/vsd.yaml"]
VSD_FLASH = dict(flash_attn_fwd=15, flash_attn_bwd_dkv=5, flash_attn_bwd_dq=5)
# the 3xTF32 convolution a VSD step: three fp32 UNet passes, each of SD
# 2.1's 66 convolutions but conv_out (4 channels: cuDNN)
VSD_CONV = 3 * 65
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


def fail(msg):
    """Report a failed check on both streams: a caller that keeps only
    the end of one of them still reads why."""
    print(f"FAIL: {msg}", flush=True)
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)


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
        fail("torch.cuda.is_available() is false")
        return 1
    try:
        return run(torch)
    except SmokeFailure as e:
        fail(str(e))
        return 1


def run(torch) -> int:
    from gsgen_torch.config import build_trainer, load_config
    from gsgen_torch.models.init import InitConfig, initialize
    from gsgen_torch.models.scene import (RenderConfig, activate,
                                          render_view)
    from gsgen_torch.ops import (binning, conv, cuda_lib, cuda_raster,
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
    # K5 fp32 on wgmma: one kernel a P V width (16, 32, 64); K6 / K7 fp32
    # on wgmma: one kernel each; K6 / K7 bf16 above D = 64: one kernel a
    # width (80, 160); the 3xTF32 convolution: one kernel a kernel size (1,
    # 3); none spills, and ptxas serialised no wgmma in them (its C75xx
    # notes name the function)
    gated = ("tf32_wgmma", "_wide_kernel")
    require(not [f for f in spills if any(g in f for g in gated)],
            f"an fp32 or wide bf16 wgmma kernel spills: {spills}")
    serial = [ln.strip() for ln in cuda_lib.build_info["log"].splitlines()
              if "serialized" in ln and any(g in ln for g in gated)]
    require(not serial, f"ptxas serialised wgmma: {serial}")
    for what, needle, kind, want in (
            ("fp32 fwd", "fwd_tf32_wgmma", "tf32_wgmma", 3),
            ("fp32 bwd", "bwd_d", "tf32_wgmma", 2),
            ("bf16 bwd D 72-160", "bwd_d", "_wide_kernel", 4),
            ("fp32 conv", "conv_tf32_wgmma", "tf32_wgmma", 2)):
        gated_ptxas = {k: v for k, v in ptxas_lines(
            cuda_lib.build_info["log"], needle).items() if kind in k}
        require(len(gated_ptxas) == want, f"ptxas names "
                f"{len(gated_ptxas)} {what} wgmma kernels, expected {want}")
        print(f"phase 2 flash {what}: ok | " + " | ".join(
            f"{k}: {v}" for k, v in gated_ptxas.items()), flush=True)

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

    wrappers = dict(raster_fwd=cuda_raster.raster_fwd,
                    raster_bwd=cuda_raster.raster_bwd,
                    expansion_rank=expansion_rank.expansion_gid,
                    gid_repack=gid_repack.repack_gid,
                    flash_attn_fwd=flash_attention.flash_self_attention,
                    flash_attn_bwd_dkv=flash_attention.flash_bwd_dkv,
                    flash_attn_bwd_dq=flash_attention.flash_bwd_dq,
                    raster_fwd_compact=cuda_raster.raster_fwd_compact,
                    raster_bwd_compact=cuda_raster.raster_bwd_compact)

    def check_recorded(label, rec, trainer):
        """The first view a drive recorded (record_render_inputs) through
        K1-K4 against their plain versions, as kernel_checks holds them."""
        bargs, bkw = rec["bin"]
        ra, _ = rec["raster"]
        prep = dict(bin_args=tuple(bargs),
                    bin_kw={k: v for k, v in bkw.items() if k != "layout"},
                    mean2d=ra[0], conic=ra[1], alpha=ra[2], feats=ra[3],
                    geom=make_geom(ra[5], ra[6], dev),
                    intr=trainer.data.intrinsics(), rcfg=trainer.rcfg)
        notes.clear()
        kernel_checks(label, prep, SCALE_TOL)
        return notes[-1]

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
            ("one tile", (2, 128, 3, 64), "float32"),
            ("SD 1.5 width, TMA zero fill", (2, 1024, 8, 40), "float32"),
            ("whole ring, few CTAs", (1, 4096, 2, 64), "bfloat16"),
            ("one tile, TMA zero fill", (2, 128, 3, 40), "bfloat16"),
            *((label, shape, dtn) for label, shape in IF2_ATTN.items()
              for dtn in ("float32", "bfloat16")),
            ("TINY_SR level 0 (fine-tune)", TINY_SR_ATTN, "float32"),
            ("SDXL level 1", SDXL_ATTN, "bfloat16"))):
        dt = getattr(torch, dtn)
        q, k, v = qkv(shape, dt, 20 + i)
        scale = shape[-1] ** -0.5
        got = flash_attention.flash_self_attention(q, k, v, scale)
        torch.cuda.synchronize()
        require(got.shape == q.shape and got.dtype == dt,
                f"K5 {label} {dtn}: output {got.dtype} {tuple(got.shape)}")
        require(bool(torch.isfinite(got).all()),
                f"K5 {label} {dtn}: non-finite output")
        L = shape[1]
        # past L = 16,384 the plain version takes the first, a middle and
        # the last block of queries against all L keys
        rows = ([slice(None)] if L <= 16384 else
                [slice(s, s + K5_QUERY_BLOCK) for s in
                 (0, (L - K5_QUERY_BLOCK) // 2, L - K5_QUERY_BLOCK)])
        elementwise = label in IF2_ATTN and dtn == "bfloat16"
        err = top = rel = 0.0
        for r in rows:
            want = flash_attention.flash_self_attention_plain(
                q[:, r], k, v, scale).float()
            diff = (got[:, r].float() - want).abs()
            err, top = max(err, float(diff.max())), max(
                top, float(want.abs().max()))
            if elementwise:
                rms = float(want.square().mean().sqrt())
                rel = max(rel, float(((diff - 2 ** -7 * want.abs())
                                      / rms).max()))
            del want, diff
        tol = FLASH_TOL[dtn] * top
        require(err <= tol, f"K5 {label} {shape} {dtn}: max abs err "
                f"{err:.3e} above {tol:.3e}")
        require(rel <= FLASH_BF16_RMS_TOL,
                f"K5 {label} {shape} {dtn}: an output is {rel:.3e} x RMS "
                f"past one bf16 step of the plain value (limit "
                f"{FLASH_BF16_RMS_TOL})")
        errs["flash_attn_fwd"] = max(errs["flash_attn_fwd"], err)
        blocks = (f", query blocks {[(r.start, r.stop) for r in rows]}"
                  if len(rows) > 1 else "")
        bf16_rms = (f", past one bf16 step {rel:.2e} x RMS (tol "
                    f"{FLASH_BF16_RMS_TOL})" if elementwise else "")
        notes.append(f"K5 {label} {list(shape)} {dtn}: max abs err "
                     f"{err:.2e} (tol {tol:.2e}){bf16_rms}{blocks}")
        del q, k, v, got
        torch.cuda.empty_cache()

    # K5 bf16 and its lse at every built width and between them (rounded up
    # to the next instance), one tile of queries and keys to eight
    w_errs = []
    for D in K5_BF16_WIDTHS:
        for L in (128, 256, 1024):
            q, k, v = qkv((2, L, 2, D), torch.bfloat16, 3 * D + L)
            scale = D ** -0.5
            out, lse = flash_attention.flash_self_attention_lse(q, k, v,
                                                                scale)
            out_p, lse_p = flash_attention.flash_self_attention_plain_lse(
                q, k, v, scale)
            torch.cuda.synchronize()
            err = float((out.float() - out_p.float()).abs().max())
            e_lse = float((lse - lse_p).abs().max())
            top = float(out_p.float().abs().max())
            require(bool(torch.isfinite(out).all()) and err <= FLASH_TOL[
                "bfloat16"] * top and e_lse <= K5_BF16_LSE_TOL,
                f"K5 bf16 [2, {L}, 2, {D}] (instance "
                f"{flash_attention.fwd_tiles(torch.bfloat16, D)}): max abs "
                f"err {err:.3e} of max {top:.3e}, lse {e_lse:.3e}")
            errs["flash_attn_fwd"] = max(errs["flash_attn_fwd"], err)
            w_errs.append(f"D {D} L {L} {err:.1e}/{e_lse:.1e}")
    notes.append("K5 bf16 and lse at [2, L, 2, D] against plain (out / lse "
                 f"max abs err, tol {FLASH_TOL['bfloat16']} of max|out| / "
                 f"{K5_BF16_LSE_TOL:.2e}): "
                 + ", ".join(w_errs))
    del q, k, v, out, lse, out_p, lse_p
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
            ("SD 1.5 level 1 (on)", (2, 1024, 8, 80), "bfloat16"),
            ("SD 1.5 level 2 (on)", (2, 256, 8, 160), "bfloat16"),
            ("width 120, TMA zero fill", (2, 256, 2, 120), "bfloat16"),
            ("one tile, TMA zero fill", (2, 128, 3, 40), "bfloat16"),
            ("SD 1.5 width, TMA zero fill", (2, 1024, 8, 40), "float32"),
            ("one tile, one k-step", (2, 128, 3, 8), "float32"),
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
    conv_notes, errs["conv2d_3xtf32"] = conv_checks(torch, dev)
    notes += conv_notes
    print("phase 3 kernels: ok | " + " | ".join(notes), flush=True)

    # ---- phase 4: train configs/base.yaml (guidance.type=mock) ----
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
    k5_bd = k5_bound(B, L, H, D)
    times_flash = dict(
        ms=time_ms(lambda: flash_attention.flash_self_attention(
            q, k, v, scale), 20),
        plain_ms=time_ms(lambda: flash_attention.flash_self_attention_plain(
            q, k, v, scale), 3),
        library_ms=time_ms(lambda: F.scaled_dot_product_attention(
            qh, kh, vh, scale=scale), 20),
        bound_ms=k5_bd[0], bound_by=k5_bd[1])
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

    # K5 fp32 at the IF-II upsampler's two attention levels (the upsampler
    # runs fp32): its time, the plain version's, SDPA's in fp32 and the
    # bound (3xTF32 at 495/3 TFLOP/s, or the bytes of q, k, v and out)
    if2_times = {}
    for label, shp in IF2_ATTN.items():
        Bi, Li, Hi, Di = shp
        sc = Di ** -0.5
        q, k, v = qkv(shp, torch.float32, 31)
        qh, kh, vh = (x.transpose(1, 2) for x in (q, k, v))
        ops = 4.0 * Bi * Hi * Li * Li * Di
        b_ms = 1e3 * 4 * Bi * Li * Hi * Di * 4 / PEAK_BYTES
        o_ms = 1e3 * ops / PEAK_3XTF32_FLOPS
        if2_times[label] = dict(
            shape=list(shp), ops=ops,
            ms=time_ms(lambda: flash_attention.flash_self_attention(
                q, k, v, sc), 10),
            plain_ms=time_ms(
                lambda: flash_attention.flash_self_attention_plain(
                    q, k, v, sc), 2),
            library_ms=time_ms(lambda: F.scaled_dot_product_attention(
                qh, kh, vh, scale=sc), 10),
            bound_ms=max(b_ms, o_ms),
            bound_by="bytes" if b_ms >= o_ms else "operations")
        del q, k, v, qh, kh, vh
        torch.cuda.empty_cache()

    # K6 / K7 at the VSD path's [4, 4096, 5, 64] (fp32 on the path, bf16
    # beside it); the yardstick is SDPA's backward, one call computing all
    # three gradients; K5 with its lse at the same shape
    Bv, Lv, Hv, Dv = VSD_ATTN
    units = Bv * Hv * Lv * Lv * Dv
    times_bwd, k5_b4, sdpa_bwd = {}, {}, {}
    for dtn in ("float32", "bfloat16"):
        dt = getattr(torch, dtn)
        q, k, v, dout = qkvo(VSD_ATTN, dt, 70)
        out, lse = flash_attention.flash_self_attention_lse(q, k, v, scale)
        delta = flash_attention.attention_delta(out, dout)
        args = (q, k, v, dout, lse, delta, scale)
        k5_b4[dtn] = time_ms(lambda: flash_attention.flash_self_attention_lse(
            q, k, v, scale), 10)
        sdpa_bwd[dtn] = sdpa_bwd_ms(q, k, v, dout, scale)
        for name, kn, fn, fn_p in (
                ("flash_attn_bwd_dkv", "dkv", flash_attention.flash_bwd_dkv,
                 flash_attention.flash_bwd_dkv_plain),
                ("flash_attn_bwd_dq", "dq", flash_attention.flash_bwd_dq,
                 flash_attention.flash_bwd_dq_plain)):
            bd = bwd_bound_ms(*VSD_ATTN, dt, kn)
            # device_ms: the kernel alone, without the wrapper's host path
            times_bwd[(name, dtn)] = dict(
                ms=time_ms(lambda fn=fn: fn(*args), 10),
                device_ms=graph_ms(lambda fn=fn: fn(*args), 10, 3),
                plain_ms=time_ms(lambda fn_p=fn_p: fn_p(*args), 3),
                library_ms=sdpa_bwd[dtn], bound_ms=bd[0], bound_by=bd[1])
        del q, k, v, dout, out, lse, delta, args
        torch.cuda.empty_cache()
    # K6 / K7 bf16 at SD 1.5's `on` levels (the instances of widths 80 and
    # 160), device time, SDPA's whole backward beside them
    wide_bwd = {}
    for label, shp in SD15_ON_BWD.items():
        q, k, v, dout = qkvo(shp, torch.bfloat16, 71)
        sc = shp[-1] ** -0.5
        out, lse = flash_attention.flash_self_attention_lse(q, k, v, sc)
        delta = flash_attention.attention_delta(out, dout)
        args = (q, k, v, dout, lse, delta, sc)
        wide_bwd[label] = dict(
            shape=list(shp), sdpa_bwd_ms=sdpa_bwd_ms(q, k, v, dout, sc),
            **{kn: dict(device_ms=graph_ms(lambda fn=fn: fn(*args), 10, 3),
                        bound=bwd_bound_ms(*shp, torch.bfloat16, kn))
               for kn, fn in (("dkv", flash_attention.flash_bwd_dkv),
                              ("dq", flash_attention.flash_bwd_dq))})
        del q, k, v, dout, out, lse, delta, args
        torch.cuda.empty_cache()
    # K6 + K7 in device time beside SDPA's whole backward
    bwd_sum = {dtn: times_bwd[("flash_attn_bwd_dkv", dtn)]["device_ms"]
               + times_bwd[("flash_attn_bwd_dq", dtn)]["device_ms"]
               for dtn in sdpa_bwd}
    bwd_bound = {d: 1e3 * 10.0 * units / pk for d, pk in
                 (("float32", PEAK_FLOPS), ("bfloat16", PEAK_BF16_FLOPS))}
    # one row per K5 / K6 / K7 instance: ms, TFLOP/s, share of its bound
    # and the SDPA call beside it
    flash_rows = [
        ("K5 bf16 wgmma+TMA", list(SD21_ATTN), times_flash["ms"], flash_ops,
         times_flash["bound_ms"], times_flash["library_ms"]),
        ("K5 fp32 3xTF32 wgmma+TMA", list(SD21_ATTN), flash_fp32_ms,
         flash_ops, 1e3 * flash_ops / PEAK_3XTF32_FLOPS, sdpa_fp32["b8"]),
        ("K5 fp32 3xTF32 wgmma+TMA +lse", list(VSD_ATTN), k5_b4["float32"],
         4.0 * units, 1e3 * 4.0 * units / PEAK_3XTF32_FLOPS,
         sdpa_fp32["b4"]),
        ("K5 bf16 wgmma+TMA +lse", list(VSD_ATTN), k5_b4["bfloat16"],
         4.0 * units, k5_bound(*VSD_ATTN)[0], None)]
    flash_rows += [(f"K5 fp32 3xTF32 wgmma+TMA {label}", r["shape"],
                    r["ms"],
                    r["ops"], r["bound_ms"], r["library_ms"])
                   for label, r in if2_times.items()]
    for (name, dtn), v in times_bwd.items():
        design = {("flash_attn_bwd_dkv", "bfloat16"): "K6 bf16 wgmma+TMA",
                  ("flash_attn_bwd_dkv", "float32"): "K6 fp32 3xTF32 wgmma",
                  ("flash_attn_bwd_dq", "bfloat16"): "K7 bf16 wgmma+TMA",
                  ("flash_attn_bwd_dq", "float32"): "K7 fp32 3xTF32 wgmma"}
        ops = (8.0 if name == "flash_attn_bwd_dkv" else 6.0) * units
        flash_rows.append((design[(name, dtn)], list(VSD_ATTN),
                           v["device_ms"], ops, v["bound_ms"], sdpa_bwd[dtn]))
    for label, r in wide_bwd.items():
        B_, L_, H_, D_ = r["shape"]
        for kn, name, mult in (("dkv", "K6", 8.0), ("dq", "K7", 6.0)):
            flash_rows.append((
                f"{name} bf16 wgmma+TMA width {80 if D_ <= 80 else 160}",
                r["shape"], r[kn]["device_ms"],
                mult * B_ * H_ * L_ * L_ * D_, r[kn]["bound"][0],
                r["sdpa_bwd_ms"]))
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
          + " | K6 + K7 device: " + ", ".join(
              f"{d} {ms:.3f} ms against SDPA's whole backward "
              f"{sdpa_bwd[d]:.3f} ({ms / sdpa_bwd[d]:.2f}x)"
              for d, ms in bwd_sum.items())
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
    print(f"phase 5 if2: ok | card {card} | K5 fp32 at the IF-II "
          "upsampler's levels (256^2 target, B = 1): " + " | ".join(
              f"{k} {r['shape']}: {r['ms']:.4f} ms (plain "
              f"{r['plain_ms']:.3f}, SDPA fp32 {r['library_ms']:.4f}, bound "
              f"{r['bound_ms']:.4f} {r['bound_by']}, "
              f"{100.0 * r['bound_ms'] / r['ms']:.1f}% of it)"
              for k, r in if2_times.items()), flush=True)
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
    # phases 7 and 9 count the 3xTF32 convolution too: VSD_CONV a VSD
    # step, none in the bf16 SDS drives (the other phases run fp32 UNets
    # whose convolution counts no check predicts, so it is kept out of
    # wrappers there)
    counted = dict(wrappers, conv2d_3xtf32=conv.conv2d_3xtf32)
    sds = sds_phases(torch, dev, build_trainer, load_config, counted)
    launches = sds["launches"]

    # ---- phase 8: where an SDS step's device time goes ----
    sds_profile = profile_step(torch, sds.pop("trainer"),
                               cuda_lib.BUILD / "sds_step_trace.json", False)
    torch.cuda.empty_cache()

    # ---- phase 9: VSD on the SD 2.1 UNet (LoRA + camera), K6 / K7 ----
    vsd = vsd_phases(torch, dev, build_trainer, load_config, counted)
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

    # ---- phase 12: Point-E (the init and the aux guidance) ----
    point_e = point_e_phases(torch, dev, build_trainer, load_config,
                             wrappers, card)
    torch.cuda.empty_cache()

    # ---- phase 13: the rest of the render path ----
    extras = extras_phases(torch, dev, build_trainer, load_config, wrappers,
                           card)
    f8_times = {}
    for layout in ("padded", "compact"):
        rec, restore = record_render_inputs(torch)
        pens = {}

        def keep_penalties(tr, step, metrics):
            pens[step] = {n: float(metrics[f"pen_{n}"])
                          for n in PENALTY_NAMES}

        try:
            trainer, d = drive(
                torch, build_trainer, load_config, wrappers, "base.yaml",
                EXTRAS_PBR + EXTRAS_PENALTY
                + (COMPACT if layout == "compact" else []), 3, {},
                layout=layout, on_step=keep_penalties)
        finally:
            restore()
        require(set(trainer.state.scene.params) >= {"specular", "normal"},
                f"13 d {layout}: no PBR fields")
        require(all(math.isfinite(v) and v != 0.0
                    for p in pens.values() for v in p.values()),
                f"13 d {layout}: penalties {pens}")
        bg_mu = float(trainer.state.opt.mu["bg/bg_color"].abs().max())
        d.update(penalties=pens, bg_color_mu=bg_mu)
        bargs, bkw = rec["bin"]
        ra, _ = rec["raster"]
        prep = dict(bin_args=tuple(bargs),
                    bin_kw={k: v for k, v in bkw.items() if k != "layout"},
                    mean2d=ra[0], conic=ra[1], alpha=ra[2], feats=ra[3],
                    geom=make_geom(ra[5], ra[6], dev),
                    intr=trainer.data.intrinsics(), rcfg=trainer.rcfg)
        require(prep["feats"].shape[-1] == 8,
                f"13 d {layout}: F = {prep['feats'].shape[-1]}, expected 8")
        notes.clear()
        label = f"13 d {layout} step 0 view 0"
        r_pad = kernel_checks(label, prep, SCALE_TOL)
        r_cmp = compact_checks(label, prep, SCALE_TOL, r_pad)
        d["kernel_notes"] = list(notes)
        if layout == "padded":
            # F = 8 and the same scene's first 5 channels, in one call
            prep5 = dict(prep, feats=prep["feats"][:, :5].contiguous())
            r_pad5 = kernel_checks(label + " F=5", prep5, SCALE_TOL)
            r_cmp5 = compact_checks(label + " F=5", prep5, SCALE_TOL, r_pad5)
            for F, rp, rc in ((8, r_pad, r_cmp), (5, r_pad5, r_cmp5)):
                tk = kernel_times(rp, 20, 3)
                tk.update(compact_times(rc, 20, 3))
                f8_times[F] = {k: tk[k] for k in RASTER}
            d["f8_times"], d["f5_times"] = f8_times[8], f8_times[5]
        print(f"phase 13 d {layout}: ok | card {card} | {d['config']}: "
              f"{d['steps']} steps, batch {d['batch']}, {d['reso']}^2 | "
              f"losses {d['losses']} | ms/step "
              f"{[round(x, 2) for x in d['ms_per_step']]} | peak "
              f"{d['peak_gib']:.2f} GiB | launches {d['launches']} | "
              f"penalties at the last step {pens[2]} | bg_color max |mu| "
              f"{bg_mu:.3e} | F=8 through K1/K2 and K8/K9 against their "
              "plain versions: " + " | ".join(notes), flush=True)
        extras[f"d_{layout}"] = d
        del trainer, rec, prep
        torch.cuda.empty_cache()
    print(f"phase 13 d times: ok | card {card} | device time, a CUDA graph of "
          "50 calls, on the padded run's first view, F = 8 (colour, depth, "
          "z^2, normal) against its first 5 channels: " + " | ".join(
              f"{k}: F=8 {f8_times[8][k]['ms']:.4f} ms (bound "
              f"{f8_times[8][k]['bound_ms']:.4f} {f8_times[8][k]['bound_by']}, "
              f"plain {f8_times[8][k]['plain_ms']:.2f}), F=5 "
              f"{f8_times[5][k]['ms']:.4f} ms" for k in RASTER), flush=True)
    extras["e"] = extras_card_vs_cpu(torch, build_trainer, load_config)

    # ---- phase 14: guidance sampling and DeepFloyd IF ----
    sampling = sampling_phases(torch, dev, build_trainer, load_config,
                               wrappers, card)
    sampling["k5_launches"]["11 flagship guidance sample"] = \
        outputs["guidance_sample"]["launches"]["flash_attn_fwd"]
    torch.cuda.empty_cache()

    # ---- phase 15: image-to-3D ----
    image = image_phases(torch, dev, build_trainer, load_config, wrappers,
                         card, check_recorded)
    torch.cuda.empty_cache()

    # ---- phase 16: weights from model directories ----
    weights = weights_phases(torch, dev, build_trainer, load_config,
                             wrappers, card, check_recorded, time_ms)
    sampling["k5_launches"]["16 a sd15 sds steps"] = \
        weights["a"]["launches"]["flash_attn_fwd"]
    sampling["k5_launches"]["16 a sd15 sds steps, fused attention on"] = \
        weights["a_on"]["launches"]["flash_attn_fwd"]
    torch.cuda.empty_cache()

    # ---- phase 17: the tools around a trained scene ----
    tools = tools_phases(torch, dev, build_trainer, load_config, wrappers,
                         card, check_recorded)
    sampling["k5_launches"]["17 d rehearsal, 10 steps"] = \
        tools["d"]["launches"]["flash_attn_fwd"]
    torch.cuda.empty_cache()

    # ---- phase 18: tile-, data- and Gaussian-sharded rendering ----
    parallel = parallel_phases(torch, dev, build_trainer, load_config,
                               wrappers, card)
    torch.cuda.empty_cache()

    # ---- phase 19: c2f switches, densify presets, perp-neg ----
    c2f = c2f_phases(torch, build_trainer, load_config, wrappers, card)

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
            image_launches=image["b"]["launches"][k],
            max_abs_err=errs[k], ms=tb["ms"],
            plain_ms=tb["plain_ms"], bound_ms=tb["bound_ms"],
            bound_by=tb["bound_by"], library_ms=tb["library_ms"],
            **{h: tb[h] for h in ("host_loop_ms", "library_host_loop_ms",
                                  "floor_ms", "edge_case_ms") if h in tb},
            **({"design": RASTER_DESIGN[k[7:10]],
                "f8": dict(f8_times[8][k], f5_ms=f8_times[5][k]["ms"],
                           launches=extras["d_compact" if "compact" in k
                                           else "d_padded"]["launches"][k],
                           shapes="13 d: base.yaml + PBR render_normal, "
                                  "first view of step 0")}
               if k in RASTER else {}),
            **({"slab_launches": parallel["launches"][k]}
               if k in parallel["launches"] else {}),
            c2f_launches=c2f["a"]["launches"][k],
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
        image_launches=image["b"]["launches"]["flash_attn_fwd"],
        max_abs_err=errs["flash_attn_fwd"], **times_flash,
        shapes=f"SD 2.1 level-0 self-attention {list(SD21_ATTN)} bf16",
        fp32_ms=flash_fp32_ms, fp32_plain_ms=flash_fp32_plain_ms,
        fp32_library_ms=sdpa_fp32["b8"], fp32_b4_lse_ms=k5_b4["float32"],
        fp32_b4_library_ms=sdpa_fp32["b4"],
        fp32_bound_ms=1e3 * flash_ops / PEAK_3XTF32_FLOPS,
        if2_fp32=if2_times, path_launches=sampling["k5_launches"],
        sd15=weights["k5"],
        c2f_launches=c2f["a"]["launches"]["flash_attn_fwd"],
        design="bf16, every D: wgmma + TMA (2 consumer warpgroups, 128 "
               "queries a CTA, 3-stage K/V ring, P V as wide as D rounded "
               "up to 40/64/80/160; the warpgroups take the tensor core in "
               "turns, each issuing S of its next tile with P V of its "
               "last); fp32 D<=64: 3xTF32 on wgmma + TMA (a split pass "
               "writes K's and V^T's hi/lo planes once, V^T's columns in "
               "the order of P's A fragment; 2 consumer warpgroups, 128 "
               "queries a CTA, the planes of 64-key tiles through a TMA "
               "ring; S as SS wgmma against resident Q hi/lo planes, P in "
               "registers as the A operand of P V, 16/32/64 wide; each "
               "tile's P V folded into O by one FMA); fp32 D>64: 3xTF32 on "
               "mma.sync m16n8k8, cp.async double buffer"))
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
                   "fp32; library_ms: SDPA's backward (dQ, dK and dV), "
                   "device time from a profiler trace",
            design=("bf16 D<=64: wgmma + TMA (2 consumer warpgroups, 128 "
                    "keys a CTA, 3-stage Q/dO ring); bf16 D 72-160: "
                    "wgmma + TMA at widths 80 / 160 (64 keys a CTA, 3-stage "
                    "Q/dO ring; warpgroup 0 S^T, P^T, dV, warpgroup 1 dP^T, "
                    "dS^T, dK; P^T handed over in fp32); "
                    "fp32 D<=64: 3xTF32 on wgmma + TMA (64 keys a CTA, "
                    "3-stage Q/dO ring; warpgroup 0 S, P, dV^T = dO^T P, "
                    "warpgroup 1 dP, dS, dK^T = Q^T dS; P and dS as "
                    "[key][query] hi/lo planes); fp32 D>64: 3xTF32 on "
                    "mma.sync m16n8k8" if name == "flash_attn_bwd_dkv" else
                    "bf16 D<=64: wgmma + TMA (2 consumer warpgroups, 128 "
                    "queries a CTA, 3-stage K/V ring); bf16 D 72-160: "
                    "wgmma + TMA at widths 80 / 160 (64 queries a CTA, "
                    "3-stage K/V ring; warpgroup 0 S, P, warpgroup 1 dP, "
                    "dS, dQ; P handed over in fp32); "
                    "fp32 D<=64: 3xTF32 on wgmma + TMA (64 queries a CTA, "
                    "3-stage K/V ring; warpgroup 0 S^T, P^T, warpgroup 1 "
                    "dP^T, dS^T, dQ^T = K^T dS^T; dS as [query][key] hi/lo "
                    "planes); fp32 D>64: 3xTF32 on mma.sync m16n8k8"),
            bf16=times_bwd[(name, "bfloat16")]))
    conv_rows = conv_times(torch, dev)
    conv_top = next(iter(conv_rows.values()))
    kernels.append(dict(
        name="conv2d_3xtf32", route="cuda",
        source="gsgen_torch/csrc/conv_3xtf32.cu",
        replaces="none: XLA's convolution (nn.Conv in the JAX package's "
                 "guidance/unet2d.py)",
        launches=vsd_launches["conv2d_3xtf32"],
        sds_launches=launches["conv2d_3xtf32"],
        max_abs_err=errs["conv2d_3xtf32"],
        **{k: conv_top[k] for k in ("ms", "plain_ms", "bound_ms",
                                    "bound_by", "library_ms")},
        shapes=f"{next(iter(conv_rows))} (SD 2.1's UNet, the most work a "
               "VSD step); plain_ms: cuDNN IEEE fp32, cudnn.benchmark off "
               "(the port's route before); library_ms: cudnn.benchmark on "
               "in a fresh process",
        by_shape={k: {f: r[f] for f in ("ms", "plain_ms", "bound_ms",
                                        "library_ms")}
                  for k, r in conv_rows.items()},
        design="implicit GEMM in 3xTF32 on wgmma + TMA: 128 pixels x 160 "
               "channels a CTA of 256 threads; the weights' tile by TMA, "
               "its raw fp32 as hi and a lo plane split in shared memory; "
               "the activations gathered from NCHW, split and stored as "
               "K-major planes; three SS wgmma m64n160k8 a k-step, partial "
               "sums folded every 64 k; K split 2-8 ways where the tiles "
               "fill too few SMs, a reduce kernel adding the splits in "
               "order"))
    print(f"phase 20 conv: ok {len(conv_rows)} shapes at batch 8 | "
          + "; ".join(f"{k}: kernel {r['ms']:.4f} ms "
                      f"({100 * r['bound_ms'] / r['ms']:.1f}% of bound "
                      f"{r['bound_ms']:.4f}), cuDNN IEEE {r['plain_ms']:.4f}"
                      f", benchmark on {r['library_ms']:.4f}"
                      for k, r in conv_rows.items()), flush=True)
    print(json.dumps({"kernels": kernels, "render_fwd_bwd_ms": render,
                      "render_fwd_bwd_ms_compact": render_compact,
                      "render_fwd_bwd_ms_again": render_again,
                      "density": dens, "compact_layout": layout_stats,
                      "walked_lanes": walked,
                      "train_ms_per_step": step_ms, "build_s": build_s,
                      "train_profile": profile_info, "sds": sds,
                      "sds_profile": sds_profile, "vsd": vsd,
                      "vsd_profile": vsd_profile, "outputs": outputs,
                      "point_e": point_e, "render_extras": extras,
                      "sampling": sampling, "image": image,
                      "weights": {k: v for k, v in weights.items()
                                  if k != "k5"},
                      "tools": tools, "parallel": parallel,
                      "c2f_presets": c2f,
                      "flash_bwd_bound_ms": bwd_bound,
                      "flash_bwd_sum_device_ms": bwd_sum,
                      "flash_bwd_sdpa_ms": sdpa_bwd,
                      "flash_instances": flash_instances}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


# the 3xTF32 convolution against its plain version (cuDNN in IEEE fp32):
# (Cin, Cout, kernel, stride, pad, side, batch, VAE-style (0, 1) padding
# first).  The VSD path's own shapes at its batches (8 in the CFG passes,
# 4 in the LoRA pass), with each K split that ops/conv.py::split_k picks
# there: conv_in; the 64^2, 32^2 and 16^2 3x3 at batch 8, no split; 16^2
# at batch 4, 2 ways; 8^2 at batch 8, 4 ways, and at batch 4, 8 ways; 1x1
# shortcuts unsplit (64^2) and 4 ways (8^2); the stride-2 downsamples
# unsplit (64^2), 2 ways (32^2) and 8 ways (16^2 at batch 4)
CONV_CASES = [(4, 320, 3, 1, 1, 64, 8, False),
              (320, 320, 3, 1, 1, 64, 8, False),
              (640, 640, 3, 1, 1, 32, 8, False),
              (1280, 1280, 3, 1, 1, 16, 8, False),
              (1280, 1280, 3, 1, 1, 16, 4, False),
              (1280, 1280, 3, 1, 1, 8, 8, False),
              (2560, 1280, 3, 1, 1, 8, 4, False),
              (960, 320, 1, 1, 0, 64, 8, False),
              (2560, 1280, 1, 1, 0, 8, 8, False),
              (320, 320, 3, 2, 1, 64, 8, False),
              (640, 640, 3, 2, 1, 32, 8, False),
              (1280, 1280, 3, 2, 1, 16, 4, False)]
# off the VSD path: the VAE's (0, 1)-padded downsample (taken when a VAE
# runs in fp32), a Cout of 40 (a ragged channel tile) and 100 pixels (a
# ragged pixel tile)
CONV_EDGE_CASES = [(256, 256, 3, 2, 0, 64, 2, True),
                   (64, 40, 3, 1, 1, 16, 1, False),
                   (32, 64, 3, 1, 1, 10, 1, False)]
# each CONV_CASES entry's split: (M, Cout, K) as the wrapper sees them, on
# the H100's 132 SMs
CONV_SPLITS = [1, 1, 1, 1, 2, 4, 8, 1, 4, 1, 2, 8]
CONV_TOL = 1e-5     # of the output's largest value (both are about 1e-6)


def conv_checks(torch, dev):
    """Phase 3's convolution rows: the kernel against F.conv2d in fp32 at
    :data:`CONV_CASES` (each with the split :data:`CONV_SPLITS` names) and
    :data:`CONV_EDGE_CASES`, one launch each.  Returns the notes and the
    largest error over the output's largest value."""
    import torch.nn.functional as F

    from gsgen_torch.ops import conv
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    if sms == 132:
        got = [conv.split_k(B * conv.out_size(H + asym, R, st, pad) ** 2,
                            Cout, Cin * R * R, sms)
               for Cin, Cout, R, st, pad, H, B, asym in CONV_CASES]
        require(got == CONV_SPLITS, f"conv splits {got}, expected "
                f"{CONV_SPLITS}")
    gen = torch.Generator(device=dev)
    gen.manual_seed(70)
    errs = []
    for Cin, Cout, R, st, pad, H, B, asym in CONV_CASES + CONV_EDGE_CASES:
        x = torch.randn(B, Cin, H, H, generator=gen, device=dev)
        if asym:
            x = F.pad(x, (0, 1, 0, 1))
        w = torch.randn(Cout, Cin, R, R, generator=gen, device=dev) / (
            Cin * R * R) ** 0.5
        b = torch.randn(Cout, generator=gen, device=dev)
        n0 = conv.conv2d_3xtf32.launches
        got = conv.conv2d_3xtf32(x, w, b, st, pad)
        want = conv.conv2d_plain(x, w, b, st, pad)
        torch.cuda.synchronize()
        err = float((got - want).abs().max() / want.abs().max())
        require(conv.conv2d_3xtf32.launches == n0 + 1 and bool(
            torch.isfinite(got).all()) and err <= CONV_TOL,
            f"conv 3xTF32 {(Cin, Cout, R, st, pad, H, B, asym)}: err "
            f"{err:.2e} of max (tol {CONV_TOL})")
        errs.append(err)
    n = len(CONV_CASES) + len(CONV_EDGE_CASES)
    return [f"conv 3xTF32 vs plain at {n} shapes (splits "
            f"{sorted(set(CONV_SPLITS))}): max err {max(errs):.2e} of max "
            f"(tol {CONV_TOL})"], max(errs)


def conv_times(torch, dev):
    """The convolution kernel's timings for the kernels line: the device ms
    of the kernel and of its plain version (cuDNN in IEEE fp32,
    ``cudnn.benchmark`` off) and the bound at ``conv_bench``'s largest
    shapes at batch 8, and cuDNN with ``cudnn.benchmark`` on in a fresh
    process (the library's best, which the port never calls), by shape."""
    from gsgen_torch.tools import conv_bench

    todo = conv_bench.top_shapes(conv_bench.unet_shapes())
    rows = conv_bench.rows_for(todo, False, 20, dev)
    lib = conv_bench.cudnn_benchmark_rows()
    for name, r in rows.items():
        r["library_ms"] = lib[name]
    return rows


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

    from gsgen_torch.training import trainer as trainer_mod

    cfg_path = ROOT / "configs" / "flagship_rehearsal.yaml"
    overrides = ["trainer.eval_image_period=1", "trainer.eval_video_period=2",
                 "trainer.save_period=2", "trainer.guidance_eval_period=2",
                 "trainer.profile_steps=[1, 2]"]
    seconds, tune, stamps, saved, gsample = {}, {}, [], [], {}
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

    def sampled(fn):
        """The guidance-eval sample with every counter set to 0 just
        before it and read just after."""
        def call(self, step, **kw):
            torch.cuda.synchronize()
            for w in wrappers.values():
                w.launches = 0
            t0 = time.perf_counter()
            img = fn(self, step, **kw)
            torch.cuda.synchronize()
            gsample.update(step=step, seconds=time.perf_counter() - t0,
                           launches={k: w.launches
                                     for k, w in wrappers.items()},
                           steps=self.cfg.guidance_eval_steps,
                           shape=list(img.shape),
                           finite=bool(np.isfinite(img).all()))
            return img
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
    patch(trainer_mod.Trainer, "_guidance_sample", sampled)
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
                     "eval/eval_image_000002.png",
                     "eval/eval_guidance_sample_000002.png",
                     "profile/steps_1_2.json", "exports/scene.ply",
                     "exports/scene.splat", "exports/scene.obj"):
            require(need in files and files[need].stat().st_size > 0,
                    f"phase 11: {need} missing or empty in {sorted(files)}")
        video = [k for k in files if "orbit" in k]
        require(video, f"phase 11: no orbit video in {sorted(files)}")
        # the guidance-eval sample at step 2: SD 2.1 in bf16, 25 CFG steps
        # at batch 2, K5 five times a forward and no other kernel
        n_s = gsample.get("steps", 0)
        want_s = {k: SD21_K5_PER_FWD * n_s if k == "flash_attn_fwd" else 0
                  for k in wrappers}
        require(gsample.get("step") == 2 and n_s == 25
                and gsample["launches"] == want_s and gsample["finite"]
                and gsample["shape"] == [512, 512, 3],
                f"phase 11: guidance sample {gsample}, expected launches "
                f"{want_s}")
        # the profiler trace of step 1 holds the card's kernels
        trace = json.loads(files["profile/steps_1_2.json"].read_text())
        n_dev = sum(1 for e in trace.get("traceEvents", [])
                    if e.get("cat") in DEVICE_CATS)
        require(n_dev > 0, "phase 11: the profile trace holds no device op")
        del trace

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
            live=live, mesh_faces=faces, guidance_sample=gsample,
            profile_device_ops=n_dev,
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
          "trainer: every array equal | guidance sample at step 2: "
          f"{gsample['steps']} steps, {gsample['seconds']:.3f} s, K5 "
          f"{gsample['launches']['flash_attn_fwd']} launches | profile "
          f"trace of step 1: {n_dev} device ops", flush=True)
    return res


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
        # the kernel's name after the mangled namespace, with its template
        # argument
        short = re.search(r"((?:raster|flash)_\w+?kernel)(?:ILi(\d+)E)?",
                          func)
        key = func if not short else re.sub(
            r"^.*\d(?=[a-z])", "", short.group(1)) + (
            f"<{short.group(2)}>" if short.group(2) else "")
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
          n_steps, per_step, layout="padded", on_step=None,
          unread=(), prepare=None):
    """``n_steps`` training steps of a config (one file or a list merged in
    order) through build_trainer / fit with every kernel counter set to 0
    just before and read just after; losses finite and changing, every
    scene parameter and some trainable guidance leaf (if any) moved, the
    render kernels of ``layout`` (K1-K4, or K8, K9 and K3) once per view and
    no other render kernel, and each flash kernel and each kernel named in
    ``per_step`` ``per_step[name]`` (default 0) times a step.
    ``on_step(trainer, step, metrics)`` runs after each step.  ``unread``: scene fields the config's render does not
    read (normal_as_rgb's colour), which must stay exactly as they were.
    ``prepare(trainer)`` runs once after the build, before the counters
    are set to 0."""
    names = [cfg_names] if isinstance(cfg_names, str) else cfg_names
    label = " + ".join(names) + "".join(" " + o for o in overrides)
    trainer = build_trainer(load_config([ROOT / "configs" / n for n in names],
                                        overrides), device="cuda")
    if prepare is not None:
        prepare(trainer)
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
    require(all((m == 0) if k in unread else (m > 0)
                for k, m in moved.items()),
            f"{label}: params moved {moved}, expected all but {unread}")
    gp_moved = max((float((v - gp0[k]).abs().max())
                    for k, v in trainer.state.gp.items()), default=None)
    require(gp_moved is None or gp_moved > 0,
            f"{label}: no trainable guidance leaf moved")
    for k, c in launches.items():
        want = (per_step.get(k, 0) * n_steps
                if k.startswith("flash") or k in per_step
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
    # SDXL at its native 1024^2: the counters are set to 0 just before the
    # steps and every kernel's launches a step are required
    other, r = drive(torch, build_trainer, load_config, wrappers,
                     SDXL_CONFIGS, SDXL_SDS, 2,
                     dict(flash_attn_fwd=SDXL_K5_PER_STEP))
    del other
    torch.cuda.empty_cache()
    res["sdxl"] = r
    print(f"phase 7 sds: ok {r['config']}: 2 steps, batch {r['batch']}, "
          f"{r['reso']}^2 | losses {r['losses']} | ms/step "
          f"{[round(x, 2) for x in r['ms_per_step']]} | peak "
          f"{r['peak_gib']:.2f} GiB | launches {r['launches']}", flush=True)
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
                               VSD_CONFIGS, [], 3,
                               dict(VSD_FLASH, conv2d_3xtf32=VSD_CONV))
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


POINT_E_PROMPT = "A high quality photo of a furry corgi"   # corgi.yaml's


def point_e_checkpoints(torch, folder):
    """Seeded random-weight ``.pt`` state dicts of base40M-textvec and the
    upsampler at full width, ``output_proj`` filled (a fresh Point-E model
    predicts exactly 0)."""
    from gsgen_torch.guidance.point_e import (BASE40M_TEXTVEC, UPSAMPLE_CFG,
                                              PointEModel,
                                              PointEUpsamplerModel)
    paths = {}
    for i, (name, cls, cfg) in enumerate((
            ("base40M-textvec", PointEModel, BASE40M_TEXTVEC),
            ("upsample", PointEUpsamplerModel, UPSAMPLE_CFG))):
        model = cls(cfg, device="cpu", seed=40 + i)
        g = torch.Generator().manual_seed(50 + i)
        state = model.module.state_dict()
        for k in ("output_proj.weight", "output_proj.bias"):
            state[k] = torch.randn(state[k].shape, generator=g) * 0.02
        paths[name] = folder / f"{name}.pt"
        torch.save(state, paths[name])
    return paths


def point_e_phases(torch, dev, build_trainer, load_config, wrappers, card):
    """Phase 12: Point-E.  (a) card against CPU: FPS at capacity 65,536
    (4,096 active, 1,024 samples), one base40M-textvec forward at full
    width [2, 6, 1024], the aux loss and its mean gradient on TINY; the
    forward's device time at the aux batch [8, 6, 1024].  (b) the init:
    ``point_e_generate`` on seeded random-weight checkpoints (64 + 64
    Karras steps) into a temporary GSGEN_ASSET_DIR, then again from the
    cache.  (c) 3 steps of configs/corgi.yaml with the SD 2.1 overrides,
    ``init.type=point_e`` on those checkpoints and the aux guidance on
    base40M-textvec, with the launch counters read around them; the aux
    term's loss and mean gradient.  (d) one such step profiled, device
    time split with a point_e part (FPS + transformer).  (e) corgi.yaml
    as it ships (mock aux, MockUNet) for 2 steps."""
    import os
    import shutil
    import tempfile

    import numpy as np

    from gsgen_torch.guidance.point_e import (BASE40M_TEXTVEC, TINY_POINT_E,
                                              PointEModel)
    from gsgen_torch.guidance.point_e_aux import (PointEAuxConfig,
                                                  PointEAuxGuidance)
    from gsgen_torch.models.scene import activate
    from gsgen_torch.ops import cuda_lib
    from gsgen_torch.priors import point_e_generate
    from gsgen_torch.utils.ops import farthest_point_sampling

    res = {}
    cpu = torch.device("cpu")
    g = torch.Generator().manual_seed(60)

    # (a) FPS at the aux guidance's shape, card against CPU
    pts = torch.zeros(65536, 3)
    pts[:4096] = torch.randn(4096, 3, generator=g) * 0.8
    mask = torch.arange(65536) < 4096
    pts_d, mask_d = pts.to(dev), mask.to(dev)
    fps_ms = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        idx_d = farthest_point_sampling(pts_d, 1024, mask=mask_d)
        torch.cuda.synchronize()
        fps_ms.append(1e3 * (time.perf_counter() - t0))
    idx_d = idx_d.cpu()
    idx_c = farthest_point_sampling(pts, 1024, mask=mask)
    n_diff = int((idx_d != idx_c).sum())
    prof_err = 0.0
    if n_diff:
        pd, pc = fps_profile(torch, pts, idx_d), fps_profile(torch, pts, idx_c)
        prof_err = float(((pd - pc).abs() / pc.abs().clamp(min=1e-30))
                         .max())
        require(prof_err <= 1e-5, f"FPS card vs CPU: {n_diff} indices differ "
                f"and the min-distance profiles by {prof_err:.2e} relative")
    require(bool(mask[idx_d.long()].all()), "FPS picked a masked row")

    # (a) base40M-textvec at full width, card against CPU
    m_cpu = PointEModel(BASE40M_TEXTVEC, device="cpu", seed=61)
    with torch.no_grad():
        for p in (m_cpu.module.output_proj.weight,
                  m_cpu.module.output_proj.bias):
            p.copy_(torch.randn(p.shape, generator=g) * 0.02)
    m_dev = PointEModel(BASE40M_TEXTVEC, device=dev).load_weights(
        m_cpu.module.state_dict())
    x = torch.randn(2, 6, 1024, generator=g)
    tt = torch.tensor([10.0, 900.0])
    cond = torch.randn(2, 768, generator=g)
    with torch.no_grad():
        want = m_cpu.apply(x, tt, cond)
        got = m_dev.apply(x.to(dev), tt.to(dev), cond.to(dev)).cpu()
    fwd_err = float((got - want).abs().max() / want.abs().max())
    require(bool(torch.isfinite(got).all()) and fwd_err <= 1e-4,
            f"base40M forward card vs CPU: {fwd_err:.2e} of max")
    x8 = torch.randn(8, 6, 1024, device=dev)
    t8 = torch.randint(20, 1003, (8,), device=dev)
    with torch.no_grad():
        for _ in range(2):
            m_dev.predict_noise(x8, t8, None)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        for _ in range(10):
            m_dev.predict_noise(x8, t8, None)
        ev[1].record()
        torch.cuda.synchronize()
    fwd8_ms = ev[0].elapsed_time(ev[1]) / 10
    del m_cpu, m_dev

    # (a) the aux loss and its mean gradient on TINY, card against CPU
    acfg = PointEAuxConfig(num_points=256, batch_size=4, base_name="tiny")
    tiny = PointEModel(TINY_POINT_E, device="cpu", seed=62)
    with torch.no_grad():
        tiny.module.output_proj.weight.normal_(0.0, 0.3, generator=g)
    mean = torch.randn(4096, 3, generator=g)
    color = torch.rand(4096, 3, generator=g)
    act = torch.arange(4096) < 3000
    t_aux = torch.randint(20, 1003, (4,), generator=g)
    noise = torch.randn(4, 6, 256, generator=g)
    text = torch.randn(77, 1024, generator=g)
    aux_out = []
    for d in (cpu, dev):
        guid = PointEAuxGuidance(acfg, device=d, model=PointEModel(
            TINY_POINT_E, device=d).load_weights(tiny.module.state_dict()))
        m = mean.to(d).detach().requires_grad_(True)
        out = guid.loss(m, color.to(d), act.to(d), text.to(d),
                        t=t_aux.to(d), noise=noise.to(d))
        out["loss_aux"].backward()
        aux_out.append((float(out["loss_aux"].detach()), m.grad.cpu()))
    (l_c, g_c), (l_d, g_d) = aux_out
    aux_gerr = float((g_d - g_c).abs().max() / g_c.abs().max())
    require(abs(l_d - l_c) <= 1e-4 * abs(l_c) and aux_gerr <= 1e-4,
            f"TINY aux loss card {l_d} vs CPU {l_c}, mean grad {aux_gerr:.2e}")
    res["card_vs_cpu"] = dict(
        fps_indices_differing=n_diff, fps_profile_rel_err=prof_err,
        fps_host_ms=fps_ms, base40m_fwd_rel_err=fwd_err,
        base40m_fwd_b8_ms=fwd8_ms, aux_loss=[l_c, l_d],
        aux_grad_rel_err=aux_gerr)
    print(f"phase 12 point_e: ok | card {card} | FPS 65,536 rows (4,096 "
          f"active) x 1,024 samples: {n_diff} indices differ from the CPU's"
          f" (profile err {prof_err:.1e}), host ms "
          f"{[round(v, 2) for v in fps_ms]} | base40M-textvec [2, 6, 1024] "
          f"card vs CPU {fwd_err:.2e} of max; [8, 6, 1024] forward "
          f"{fwd8_ms:.3f} ms (CUDA events, fp32, TF32 off) | TINY aux loss "
          f"card {l_d:.6g} vs CPU {l_c:.6g}, mean grad err {aux_gerr:.1e}",
          flush=True)

    # (b) the text -> cloud init on random-weight checkpoints
    tmp = Path(tempfile.mkdtemp(prefix="gsgen_point_e_"))
    old_env = os.environ.get("GSGEN_ASSET_DIR")
    os.environ["GSGEN_ASSET_DIR"] = str(tmp / "assets")
    try:
        ckpts = point_e_checkpoints(torch, tmp)
        kw = dict(base_weights=str(ckpts["base40M-textvec"]),
                  upsample_weights=str(ckpts["upsample"]),
                  karras_steps=(64, 64), device="cuda")
        init_s = []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            xyz, rgb = point_e_generate(POINT_E_PROMPT, **kw)
            torch.cuda.synchronize()
            init_s.append(time.perf_counter() - t0)
            if len(init_s) == 1:
                first = (xyz, rgb)
        cache = list((tmp / "assets").glob("point_e_*.npz"))
        require(xyz.shape == (4096, 3) and np.isfinite(xyz).all()
                and np.isfinite(rgb).all(), f"init cloud {xyz.shape}")
        require(len(cache) == 1 and np.array_equal(xyz, first[0])
                and np.array_equal(rgb, first[1]),
                "the second point_e_generate did not read the cache")
        res["init"] = dict(seconds=init_s[0], cached_seconds=init_s[1],
                           points=int(xyz.shape[0]),
                           xyz_absmax=float(np.abs(xyz).max()),
                           rgb_mean=float(rgb.mean()))
        print(f"phase 12 point_e: ok | card {card} | init: point_e_generate "
              f"(base40M-textvec + upsample, 64 + 64 Karras steps, random "
              f"weights) {init_s[0]:.3f} s -> {xyz.shape[0]} finite points "
              f"(|xyz| max {res['init']['xyz_absmax']:.3f}); again from the "
              f"cache {init_s[1]:.4f} s", flush=True)

        # (c) corgi.yaml + SD 2.1 + Point-E init and aux at full width
        over = SLICE + [
            "init.type=point_e",
            f"init.point_e_base={ckpts['base40M-textvec']}",
            f"init.point_e_upsample={ckpts['upsample']}",
            "auxiliary.base_name=base40M-textvec",
            f"auxiliary.weights_path={ckpts['base40M-textvec']}"]
        aux_losses = []
        trainer, run = drive(
            torch, build_trainer, load_config, wrappers, "corgi.yaml", over,
            3, dict(flash_attn_fwd=5),
            on_step=lambda tr, s, m: aux_losses.append(float(m["loss_aux"])))
        require(all(math.isfinite(v) and v != 0.0 for v in aux_losses),
                f"corgi + SD 2.1 + Point-E: loss_aux {aux_losses}")
        sc = trainer.state.scene
        m = sc.params["mean"].detach().requires_grad_(True)
        col = activate({**sc.params, "mean": m}, trainer.rcfg)[3]
        ag = trainer.aux_guidance.loss(m, col, sc.active,
                                       trainer.prompt_processor().text,
                                       generator=trainer.generator)
        ag["loss_aux"].backward()
        aux_gmax = float(m.grad.abs().max())
        aux_rows = int((m.grad.abs().sum(-1) > 0).sum())
        require(aux_gmax > 0, "the aux term gave the mean no gradient")
        res["corgi_sd21"] = dict(run, loss_aux=aux_losses,
                                 aux_mean_grad_max=aux_gmax,
                                 aux_mean_grad_rows=aux_rows)
        print(f"phase 12 point_e: ok | card {card} | {run['config']}: "
              f"{run['steps']} steps, batch {run['batch']}, {run['reso']}^2 |"
              f" loss_aux {aux_losses} | aux mean grad max {aux_gmax:.3e} on "
              f"{aux_rows} rows | losses {run['losses']} | ms/step "
              f"{[round(v, 2) for v in run['ms_per_step']]} | peak "
              f"{run['peak_gib']:.2f} GiB | launches {run['launches']}",
              flush=True)

        # (d) one profiled step
        res["profile"] = profile_step(
            torch, trainer, cuda_lib.BUILD / "point_e_step_trace.json",
            False, phase="12 point_e")
        del trainer
        torch.cuda.empty_cache()
    finally:
        if old_env is None:
            os.environ.pop("GSGEN_ASSET_DIR", None)
        else:
            os.environ["GSGEN_ASSET_DIR"] = old_env
        shutil.rmtree(tmp, ignore_errors=True)

    # (e) corgi.yaml as it ships: mock aux on MockUNet
    mock_aux = []
    other, r = drive(torch, build_trainer, load_config, wrappers,
                     "corgi.yaml", [], 2, {},
                     on_step=lambda tr, s, m: mock_aux.append(
                         float(m["loss_aux"])))
    require(all(math.isfinite(v) and v != 0.0 for v in mock_aux),
            f"corgi.yaml: loss_aux {mock_aux}")
    r["loss_aux"] = mock_aux
    del other
    torch.cuda.empty_cache()
    res["corgi"] = r
    print(f"phase 12 point_e: ok | corgi.yaml as it ships (mock aux, "
          f"MockUNet): 2 steps, batch {r['batch']}, {r['reso']}^2 | losses "
          f"{r['losses']} | loss_aux {mock_aux} | ms/step "
          f"{[round(v, 2) for v in r['ms_per_step']]} | launches "
          f"{r['launches']}", flush=True)
    return res


# phase 13: the rest of the render path.  d: base.yaml with PBR (learned
# normals, a normal channel: F = 8 through K1/K2 or K8/K9), the
# learned_const background with random_aug, and every penalty at a nonzero
# weight; e: the same at a tiny size (mock guidance), card against CPU
EXTRAS_PBR = ["renderer.pbr=true", "renderer.normal_type=learned",
              "renderer.render_normal=true",
              "renderer.background.type=learned_const",
              "renderer.background.random_aug=true",
              "renderer.background.random_aug_prob=0.5"]
EXTRAS_PENALTY = ["trainer.penalty.alpha.value=0.01",
                  "trainer.penalty.mean.value=0.01",
                  "trainer.penalty.mean.type=weighted_l2",
                  "trainer.penalty.scale.value=10.0",
                  "trainer.penalty.NN.value=0.01",
                  "trainer.penalty.compat.value=0.01",
                  "trainer.penalty.compat.type=l2",
                  "trainer.penalty.move.value=0.01",
                  "trainer.penalty.specular.value=0.01"]
EXTRAS_TINY = ["init.num_points=96", "init.capacity=128", "data.reso=[32]",
               "renderer.tile_size=8", "renderer.chunk=128",
               "renderer.dup_cap=4096", "trainer.batch_size=2",
               "prompt.use_cache=false", "guidance.type=mock"]
PENALTY_NAMES = ("alpha", "mean", "scale", "NN", "compat", "move",
                 "specular")


def events_ms(torch, fn, iters=5):
    """Mean ms of ``fn`` between two CUDA events, after one warm-up."""
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


def record_render_inputs(torch):
    """Keep (detached) the inputs of the next render's first binning and
    compositing calls: the step's own tensors for phase 13 d's kernel
    checks.  Returns (record, restore)."""
    import gsgen_torch.models.scene as scene_mod

    rec = {}
    orig = scene_mod.bin_gaussians, scene_mod.rasterize_tiles_cuda

    def det(x):
        return x.detach() if torch.is_tensor(x) else x

    def keep(name, fn):
        def wrapped(*a, **kw):
            if name not in rec:
                rec[name] = ([det(x) for x in a],
                             {k: det(v) for k, v in kw.items()})
            return fn(*a, **kw)
        return wrapped

    scene_mod.bin_gaussians = keep("bin", orig[0])
    scene_mod.rasterize_tiles_cuda = keep("raster", orig[1])

    def restore():
        scene_mod.bin_gaussians, scene_mod.rasterize_tiles_cuda = orig

    return rec, restore


def extras_phases(torch, dev, build_trainer, load_config, wrappers, card):
    """Phase 13 a-c.  (a) base.yaml + renderer/mlp_bg.yaml on the SD 2.1
    slice (bf16): 2 steps with the launch counters read around them, the
    MLP's Adam moments non-zero, then one step profiled with a
    "background" part (the MLP forward over 262,144 rays a view; its
    backward follows the render's, under "backward") and the MLP's
    forward + backward for the step's 4 views timed alone.  (b)
    base.yaml + renderer/legacy.yaml (SH degree 1), mock guidance, 3
    steps.  (c) base.yaml + renderer/normal_as_rgb.yaml (estimated
    normals, k = 30 over capacity 65,536), mock guidance: 2 steps and one
    profiled with a "normals" part; knn_self and the batched 3x3 eigh
    (in batches of EIGH_BATCH: cuSOLVER refuses 32,768 at once) timed
    alone; the card's normals against the CPU's on a sphere."""
    from gsgen_torch.models.background import mlp_background
    from gsgen_torch.ops import cuda_lib
    from gsgen_torch.ops.camera import get_rays_d
    from gsgen_torch.utils.ops import (eigh_batched,
                                       estimate_pointcloud_normals, knn_self)

    res = {}
    # (a) the MLP background on the SDS slice
    trainer, a = drive(torch, build_trainer, load_config, wrappers,
                       ["base.yaml", "renderer/mlp_bg.yaml"], SLICE, 2,
                       dict(flash_attn_fwd=5))
    bg_mu = {k: float(trainer.state.opt.mu[f"bg/{k}"].abs().max())
             for k in trainer.state.bg}
    require(sorted(bg_mu) == ["b0", "b1", "b2", "w0", "w1", "w2"]
            and all(v > 0 for v in bg_mu.values()),
            f"13 a: the MLP background got no gradient: {bg_mu}")
    a["profile"] = profile_step(
        torch, trainer, cuda_lib.BUILD / "mlp_bg_step_trace.json", False,
        phase="13 a mlp_bg")
    intr = trainer.data.intrinsics()
    c2ws = torch.as_tensor(trainer.data.get_batch()["c2w"], device=dev)
    dirs = torch.stack([get_rays_d(c, intr) for c in c2ws])
    params = {k: v.detach().requires_grad_(True)
              for k, v in trainer.state.bg.items()}
    deg = trainer.bg_cfg.sh_degree

    def mlp_fwd_bwd():
        img = mlp_background(params, deg, dirs)
        torch.autograd.grad(img.sum(), list(params.values()))

    a["background_fwd_bwd_ms"] = events_ms(torch, mlp_fwd_bwd)
    a["background_fwd_ms"] = events_ms(
        torch, lambda: mlp_background(params, deg, dirs))
    a["rays"] = int(dirs.shape[0] * dirs.shape[1] * dirs.shape[2])
    print(f"phase 13 a mlp_bg: ok | card {card} | {a['config']}: "
          f"{a['steps']} steps + 1 profiled, batch {a['batch']}, "
          f"{a['reso']}^2 | losses {a['losses']} | ms/step "
          f"{[round(x, 2) for x in a['ms_per_step']]} | peak "
          f"{a['peak_gib']:.2f} GiB | launches {a['launches']} | the MLP "
          f"alone over {a['rays']} rays (4 views): forward "
          f"{a['background_fwd_ms']:.3f} ms, forward + backward "
          f"{a['background_fwd_bwd_ms']:.3f} ms (CUDA events)", flush=True)
    res["a"] = a
    del trainer, params, dirs
    torch.cuda.empty_cache()

    # (b) SH colour (degree 1)
    trainer, b = drive(torch, build_trainer, load_config, wrappers,
                       ["base.yaml", "renderer/legacy.yaml"],
                       ["guidance.type=mock"], 3, {})
    require(trainer.rcfg.sh_degree == 1, "13 b: sh_degree is not 1")
    print(f"phase 13 b legacy: ok {b['config']}: {b['steps']} steps | "
          f"losses {b['losses']} | ms/step "
          f"{[round(x, 2) for x in b['ms_per_step']]} | peak "
          f"{b['peak_gib']:.2f} GiB | launches {b['launches']}", flush=True)
    res["b"] = b
    del trainer
    torch.cuda.empty_cache()

    # (c) estimated normals as colour
    trainer, c = drive(torch, build_trainer, load_config, wrappers,
                       ["base.yaml", "renderer/normal_as_rgb.yaml"],
                       ["guidance.type=mock"], 2, {}, unread=("color",))
    c["profile"] = profile_step(
        torch, trainer, cuda_lib.BUILD / "normal_as_rgb_step_trace.json",
        False, phase="13 c normal_as_rgb")
    scene = trainer.state.scene
    k = trainer.rcfg.normal_neighborhood
    mean = scene.params["mean"].detach()
    with torch.no_grad():
        c["knn_ms"] = events_ms(torch, lambda: knn_self(mean, k,
                                                        scene.active), 3)
        _, idx = knn_self(mean, k, scene.active)
        nbr = mean[idx.long()]
        d = nbr - nbr.mean(1, keepdim=True)
        cov = torch.einsum("nki,nkj->nij", d, d) / k
        c["eigh_ms"] = events_ms(torch, lambda: eigh_batched(cov), 5)
        c["normals_ms"] = events_ms(
            torch, lambda: estimate_pointcloud_normals(mean, k, scene.active),
            3)
        gen = torch.Generator().manual_seed(0)
        v = torch.randn(4096, 3, generator=gen)
        sphere = v / v.norm(dim=-1, keepdim=True)
        n_cpu = estimate_pointcloud_normals(sphere, k)
        n_card = estimate_pointcloud_normals(sphere.to(dev), k).cpu()
        # rows whose k-th and (k+1)-th neighbours sit within rounding of
        # each other may pick another neighbour set on each device
        i_cpu = knn_self(sphere, k)[1].sort(1).values
        i_card = knn_self(sphere.to(dev), k)[1].cpu().sort(1).values
        rows = (i_cpu == i_card).all(1)
    err = float((n_card - n_cpu)[rows].abs().max())
    cos_min = float((n_card * n_cpu).sum(-1).min())
    n_other = int((~rows).sum())
    require(n_other <= 40 and err <= 1e-4 and cos_min > 0.99,
            f"13 c: card normals against the CPU's on a sphere of 4,096 "
            f"points: {n_other} rows with another neighbour set, max abs "
            f"{err:.3e} on the others, min cosine {cos_min:.6f}")
    c.update(capacity=int(mean.shape[0]), k=k, normals_card_vs_cpu=err,
             rows_other_neighbours=n_other, min_cosine=cos_min)
    print(f"phase 13 c normal_as_rgb: ok | card {card} | {c['config']}: "
          f"{c['steps']} steps + 1 profiled | losses {c['losses']} | "
          f"ms/step {[round(x, 2) for x in c['ms_per_step']]} | peak "
          f"{c['peak_gib']:.2f} GiB | launches {c['launches']} | capacity "
          f"{c['capacity']}, k {k}: knn_self {c['knn_ms']:.2f} ms, batched "
          f"3x3 eigh {c['eigh_ms']:.2f} ms, estimate_pointcloud_normals "
          f"{c['normals_ms']:.2f} ms (CUDA events) | sphere of 4,096: card "
          f"vs CPU max abs {err:.2e} on the {4096 - n_other} rows with the "
          f"same neighbours, {n_other} rows with another (min cosine "
          f"{cos_min:.6f})", flush=True)
    res["c"] = c
    del trainer, scene, mean, nbr, d, cov
    torch.cuda.empty_cache()
    return res


def extras_card_vs_cpu(torch, build_trainer, load_config):
    """Phase 13 e: one step of 13 d's configuration at a tiny size (RES 32,
    mock guidance) on the card and on the CPU from the same state, with the
    same injected background draws: the loss, each penalty and each
    field's gradient (Adam's first moment after one step) compared."""
    import numpy as np

    import gsgen_torch.training.trainer as trainer_mod
    from gsgen_torch.io.checkpoint import state_arrays
    from gsgen_torch.training.trainer import train_state_from_jax_arrays

    cfg = load_config(ROOT / "configs" / "base.yaml",
                      EXTRAS_TINY + EXTRAS_PBR + EXTRAS_PENALTY)
    t_cpu = build_trainer(cfg, device="cpu")
    t_card = build_trainer(cfg, device="cuda")
    t_card.state = train_state_from_jax_arrays(state_arrays(t_cpu.state),
                                               "cuda")
    u = np.random.default_rng(0).uniform(
        size=(t_cpu.cfg.batch_size, 6)).astype(np.float32)
    u[:, 3] = (0.25, 0.75)      # view 0 keeps bg_color, view 1 a random one
    orig = trainer_mod.apply_background
    out = {}
    for name, tr in (("cpu", t_cpu), ("card", t_card)):
        draws = [torch.as_tensor(x) for x in u]

        def injected(*a, **kw):
            return orig(*a, u=draws.pop(0), **kw)

        trainer_mod.apply_background = injected
        try:
            m = tr.train_step(0)
        finally:
            trainer_mod.apply_background = orig
        out[name] = ({k: float(v) for k, v in m.items() if v.dim() == 0},
                     {k: v.detach().cpu() for k, v in tr.state.opt.mu.items()})
    (m_c, mu_c), (m_d, mu_d) = out["cpu"], out["card"]
    rel = {}
    for k in ["loss_total"] + [f"pen_{n}" for n in PENALTY_NAMES]:
        rel[k] = abs(m_d[k] - m_c[k]) / max(abs(m_c[k]), 1e-12)
        require(rel[k] <= 1e-4, f"13 e: {k} card {m_d[k]!r} vs CPU "
                f"{m_c[k]!r}")
    for k, want in mu_c.items():
        got = mu_d[k]
        scale = float(want.abs().max())
        require(scale > 0, f"13 e: no gradient reached {k}")
        rel[f"grad {k}"] = float((got - want).abs().max()) / scale
        bad = (got - want).abs() > 2e-4 * scale + 2e-3 * want.abs()
        require(not bool(bad.any()), f"13 e: gradient of {k}: "
                f"{int(bad.sum())} values off, max rel "
                f"{rel[f'grad {k}']:.3e}")
    print("phase 13 e card vs cpu: ok tiny base.yaml + PBR + learned_const "
          "+ random_aug + every penalty, 1 step (RES 32, mock guidance): "
          "max |card - CPU| / max |CPU| " + ", ".join(
              f"{k} {v:.2e}" for k, v in rel.items()), flush=True)
    return dict(rel_err=rel, loss_cpu=m_c["loss_total"],
                loss_card=m_d["loss_total"])


def k5_per_forward(cfg, reso: int) -> int:
    """Self-attention blocks of a UNet config whose token count takes K5
    under "auto" (L >= 2048, L % 128 == 0) at a reso^2 input: 2 x
    layers_per_block + 1 at each attention level (down, then up), and the
    mid block's one at the last level."""
    def k5(L):
        return L >= 2048 and L % 128 == 0
    n = sum(2 * cfg.layers_per_block + 1
            for lvl, attn in enumerate(cfg.cross_attn_levels)
            if attn and k5((reso >> lvl) ** 2))
    return n + k5((reso >> (len(cfg.block_out_channels) - 1)) ** 2)


def sampling_phases(torch, dev, build_trainer, load_config, wrappers, card):
    """Phase 14: guidance sampling and DeepFloyd IF.  a: DDIM (eta 0 and
    0.5), PNDM and ancestral CFG samples on the TINY UNet (latent 32) on
    the card against the CPU from the same injected draws; b: VSD's
    ``sample`` (through the trainer's guidance-eval hook) and
    ``sample_lora`` at full width (SD 2.1 UNet fp32 + LoRA + camera, 25
    steps); c: guidance/if.yaml over base.yaml at full width (IF_PIXEL in
    bf16, 64^2 pixel space, batch 4, mock prompts at T5-XXL's width 4096):
    3 SDS steps and one guidance sample, no K5; the TINY IF loss and its
    render gradient on the card against the CPU; d: DiffusionUpsampler
    (IF2_PIXEL) at a 256^2 target on random weights, B = 1, 3 steps (cut
    from the config's 50 for the time limit), then the upsample fine-tune
    with make_diffusion_upsampler (TINY_SR, 3 steps) on 8 poses.  Each
    sub-phase: ms, peak GiB and launches, every counter set to 0 just
    before and read just after."""
    import copy
    import dataclasses as dc

    import numpy as np

    from gsgen_torch.guidance import samplers
    from gsgen_torch.guidance.diffusion import scaled_linear_schedule
    from gsgen_torch.guidance.sd_unet import IF_PIXEL, TINY, SDUNetBackbone
    from gsgen_torch.guidance.sds import SDSConfig, SDSGuidance
    from gsgen_torch.guidance.unet2d import set_fused_attention
    from gsgen_torch.guidance.upsampler import (IF2_PIXEL, TINY_SR,
                                                DiffusionUpsampler,
                                                UpsamplerConfig)
    from gsgen_torch.prompt import processors
    from gsgen_torch.training import upsample

    cpu = torch.device("cpu")
    res, k5 = {}, {}

    def counted(key, fn):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for w in wrappers.values():
            w.launches = 0
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        r = dict(ms=1e3 * (time.perf_counter() - t0),
                 peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                 launches={k: w.launches for k, w in wrappers.items()})
        k5[key] = r["launches"]["flash_attn_fwd"]
        return out, r

    def only_k5(key, r, n):
        want = {k: n if k == "flash_attn_fwd" else 0 for k in wrappers}
        require(r["launches"] == want,
                f"14 {key}: launches {r['launches']}, expected {want}")

    def image_ok(key, img, shape):
        img = torch.as_tensor(img)
        require(list(img.shape) == list(shape)
                and bool(torch.isfinite(img).all())
                and float(img.min()) >= 0.0 and float(img.max()) <= 1.0,
                f"14 {key}: image {list(img.shape)}, expected {shape} in "
                "[0, 1]")

    def line(key, r, extra=""):
        print(f"phase 14 {key}: ok | card {card} | {r['ms']:.1f} ms, peak "
              f"{r['peak_gib']:.2f} GiB, K5 launches "
              f"{r['launches']['flash_attn_fwd']}" + extra, flush=True)

    # a: the loops, card against CPU (TF32 off) on one set of draws
    g = torch.Generator(device="cpu").manual_seed(21)
    bb_cpu = SDUNetBackbone(TINY, latent_size=32, device="cpu")
    bb_dev = copy.deepcopy(bb_cpu).to(dev)
    text2 = torch.randn(4, 77, 1024, generator=g)
    x = torch.randn(2, 32, 32, 4, generator=g)
    loops = {}
    for kind, typ, eta, n in (("ddim", "ddim", 0.0, 3),
                              ("ddim eta 0.5", "ddim", 0.5, 3),
                              ("pndm", "pndm", 0.0, 5),
                              ("ancestral", "ancestral", 0.0, 3)):
        noise = torch.randn(n, *x.shape, generator=g)
        scfg = samplers.SamplerConfig(type=typ, num_steps=n, eta=eta)
        outs, r = {}, None
        for d, bb in ((cpu, bb_cpu), (dev, bb_dev)):
            def run_loop(d=d, bb=bb):
                return samplers.cfg_sample(
                    scfg, scaled_linear_schedule(), x.shape, 7.5,
                    lambda lat2, t2: bb.predict_noise(lat2, t2,
                                                      text2.to(d)),
                    device=d, x=x.to(d), noise=noise.to(d))
            if d.type == "cuda":
                out, r = counted(f"a {kind}", run_loop)
            else:
                out = run_loop()
            outs[d.type] = out.cpu()
        err = float((outs["cuda"] - outs["cpu"]).abs().max())
        top = float(outs["cpu"].abs().max())
        require(err <= 1e-4 * top, f"14 a {kind}: card vs CPU max abs err "
                f"{err:.3e} (max |CPU| {top:.3e})")
        only_k5(f"a {kind}", r, 0)
        loops[kind] = dict(steps=n, max_abs_err=err, **r)
    del bb_cpu, bb_dev
    res["a"] = loops
    print(f"phase 14 a loops: ok | card {card} | TINY latent 32, CFG 7.5, "
          "card against CPU from the same draws: " + " | ".join(
              f"{k} {v['steps']} steps: max abs err {v['max_abs_err']:.2e}, "
              f"{v['ms']:.1f} ms" for k, v in loops.items()), flush=True)

    # b: VSD's samples at full width (UNet fp32 + LoRA + camera)
    tr = build_trainer(load_config([ROOT / "configs" / n for n in
                                    VSD_CONFIGS]), device="cuda")
    gd = tr.guidance
    n_fwd = tr.cfg.guidance_eval_steps
    img, rb = counted("b vsd sample", lambda: tr._guidance_sample(1))
    image_ok("b sample", img, [512, 512, 3])
    only_k5("b vsd sample", rb, SD21_K5_PER_FWD * n_fwd)
    emb = tr.prompt_processor()
    pose = [torch.tensor([v], device=dev) for v in (15.0, 30.0, 2.5)]
    c2w = torch.as_tensor(tr.data.get_batch()["c2w"][:1],
                          dtype=torch.float32, device=dev)
    img_l, rl = counted("b vsd sample_lora", lambda: gd.sample_lora(
        emb, *pose, c2w, generator=torch.Generator(device=dev).manual_seed(3),
        num_steps=n_fwd, train=tr.state.gp))
    image_ok("b sample_lora", img_l, [1, 512, 512, 3])
    only_k5("b vsd sample_lora", rl, SD21_K5_PER_FWD * n_fwd)
    res["b"] = dict(steps=n_fwd, sample=rb, sample_lora=rl)
    line("b vsd sample", rb, f" | {n_fwd} steps, UNet fp32, through "
         "Trainer._guidance_sample")
    line("b vsd sample_lora", rl, f" | {n_fwd} steps, UNet fp32 + LoRA, "
         "camera against a zero camera")
    del tr, gd, emb
    torch.cuda.empty_cache()

    # c: if.yaml at full width, prompts at T5-XXL's width
    prompts = {}

    def t5_width(trainer):
        prompts["config"] = trainer.prompt_processor
        # no embedding cache: it holds the config's 1024-wide embeddings
        trainer.prompt_processor = processors.PromptProcessor(
            dc.replace(trainer.prompt_processor.cfg, use_cache=False),
            encode_fn=lambda t: processors.mock_encode(t, D=4096),
            device=dev)

    tr, c = drive(torch, build_trainer, load_config, wrappers, IF_CONFIGS,
                  [], 3, {}, prepare=t5_width)
    bb = tr.guidance.backbone
    require(bb.cfg == IF_PIXEL and bb.vae is None
            and bb.latent_size == 64 and tr.guidance.cfg.rgb_as_latents
            and all(p.dtype == torch.bfloat16 for p in bb.parameters()),
            "14 c: if.yaml did not build IF_PIXEL in bf16 without a VAE")
    require(k5_per_forward(IF_PIXEL, 64) == 0, "14 c: IF_PIXEL at 64^2 "
            "reaches K5")
    k5["c if sds steps"] = c["launches"]["flash_attn_fwd"]
    img, rc = counted("c if sample", lambda: tr._guidance_sample(3))
    image_ok("c sample", img, [64, 64, 3])
    only_k5("c if sample", rc, 0)
    # the TINY IF loss and its render gradient, card against CPU (level 0
    # at L = 256 with fused attention on: K5 fp32, three launches)
    tiny_if = dc.replace(TINY, in_channels=3, out_channels=6,
                         encoder_hid_dim=64)
    bb_c = SDUNetBackbone(tiny_if, latent_size=16, device="cpu",
                          use_vae=False)
    bb_d = copy.deepcopy(bb_c).to(dev)
    set_fused_attention(bb_d, "on")
    rgb = torch.rand(2, 40, 40, 3, generator=g)
    tt = torch.tensor([150, 800])
    noise = torch.randn(2, 16, 16, 3, generator=g)
    cams = (torch.tensor([10.0, 70.0]), torch.tensor([20.0, -160.0]),
            torch.tensor([2.5, 2.5]))
    got = {}
    for d, bbx in ((cpu, bb_c), (dev, bb_d)):
        guid = SDSGuidance(SDSConfig(rgb_as_latents=True,
                                     guidance_scale=20.0), bbx, device=d)
        emb = processors.PromptProcessor(
            processors.PromptProcessorConfig(use_cache=False),
            encode_fn=lambda t: processors.mock_encode(t, D=64),
            device=d)()
        xr = rgb.to(d).detach().requires_grad_(True)

        def tiny_loss(guid=guid, emb=emb, xr=xr, d=d):
            r = guid.loss(xr, emb, *(cc.to(d) for cc in cams), t=tt.to(d),
                          noise=noise.to(d))
            r["loss_sds"].backward()
            return float(r["loss_sds"].detach())

        if d.type == "cuda":
            loss, rt = counted("c tiny if loss", tiny_loss)
        else:
            loss = tiny_loss()
        got[d.type] = (loss, xr.grad.cpu())
    (l_c, g_c), (l_d, g_d) = got["cpu"], got["cuda"]
    only_k5("c tiny if loss", rt, 3)
    require(abs(l_d - l_c) <= 1e-3 * abs(l_c),
            f"14 c: TINY IF loss card {l_d} vs CPU {l_c}")
    g_err = float((g_d - g_c).abs().max())
    require(g_err <= 1e-3 * float(g_c.abs().max()),
            f"14 c: TINY IF rgb grad card vs CPU: max abs err {g_err:.3e}")
    res["c"] = dict(steps=c, sample=rc, tiny_card_vs_cpu=dict(
        loss=[l_c, l_d], grad_max_abs_err=g_err))
    print(f"phase 14 c if: ok | card {card} | {c['config']}: {c['steps']} "
          f"steps, batch {c['batch']}, render {c['reso']}^2 -> 64^2 pixel "
          f"space | losses {c['losses']} | ms/step "
          f"{[round(v, 2) for v in c['ms_per_step']]} | peak "
          f"{c['peak_gib']:.2f} GiB | launches {c['launches']} | guidance "
          f"sample {tr.cfg.guidance_eval_steps} steps {rc['ms']:.1f} ms, "
          f"peak {rc['peak_gib']:.2f} GiB, K5 0 | TINY IF loss card "
          f"{l_d:.6g} vs CPU {l_c:.6g}, rgb grad max abs err {g_err:.2e}, "
          "K5 3", flush=True)
    del bb_c, bb_d

    # d: the IF-II upsampler at full width, then the fine-tune on TINY_SR
    text2 = tr.prompt_processor().get_text_embedding(*pose, True)
    up = DiffusionUpsampler(UpsamplerConfig(reso=256, num_steps=3),
                            IF2_PIXEL, device=dev)
    gen = torch.Generator(device=dev).manual_seed(5)
    rgb64 = torch.rand(1, 64, 64, 3, generator=gen, device=dev)
    out, rd = counted("d IF2_PIXEL upsample", lambda: up.upsample_images(
        rgb64, text2, generator=gen))
    image_ok("d IF2_PIXEL", out, [1, 256, 256, 3])
    only_k5("d IF2_PIXEL upsample", rd,
            up.cfg.num_steps * k5_per_forward(IF2_PIXEL, 256))
    line("d IF2_PIXEL upsample", rd, " | 64^2 -> 256^2, B = 1, 3 steps "
         "(cut from 50), fp32; K5 at [2, 16384, 8, 16] and "
         "[2, 4096, 8, 32]")
    del up
    tr.prompt_processor = prompts["config"]      # TINY_SR's 1024-wide text
    ucfg = upsample.UpsampleTuneConfig(num_poses=8, batch_size=4, reso=256,
                                       epoch=1, use_cache=False)
    fn = upsample.make_diffusion_upsampler(tr, 256, num_steps=3)
    losses, rf = counted("d TINY_SR fine-tune", lambda:
                         upsample.tune_with_upsample(tr, ucfg,
                                                     upsample_fn=fn))
    views = ucfg.num_poses
    want = dict(raster_fwd=2 * views, raster_bwd=views,
                expansion_rank=2 * views, gid_repack=2 * views,
                flash_attn_fwd=views // ucfg.batch_size * 3
                * k5_per_forward(TINY_SR, 256))
    require(rf["launches"] == {k: want.get(k, 0) for k in wrappers},
            f"14 d: fine-tune launches {rf['launches']}, expected {want}")
    require(len(losses) == 2 and all(math.isfinite(v) for v in losses),
            f"14 d: fine-tune losses {losses}")
    res["d"] = dict(if2=rd, fine_tune=dict(losses=losses, **rf))
    line("d TINY_SR fine-tune", rf, f" | 8 poses at 256^2, batch 4, 3 "
         f"upsampler steps, 1 epoch: losses {losses}, launches "
         f"{rf['launches']}")
    del tr
    torch.cuda.empty_cache()
    res["k5_launches"] = k5
    return res


def fps_profile(torch, points, idx):
    """The squared distance of each farthest-point pick to the picks before
    it: what FPS maximises at each step, the same for two index orders
    that differ only where a last-ulp tie reordered them."""
    p = points[idx.long()]
    mind = torch.full((len(idx),), float("inf"))
    out = [torch.zeros(())]
    for k in range(1, len(idx)):
        mind = torch.minimum(mind, torch.sum((p - p[k - 1]) ** 2, dim=-1))
        out.append(mind[k])
    return torch.stack(out)


def profile_step(torch, trainer, trace, vsd, phase=None):
    """Phase 8 (SDS), the end of phase 9 (VSD) and phases 10-16: one step
    under torch.profiler, read by the program's own spans
    (``gsgen:<name>``, ``gsgen_torch/utils/profiling.py``).  Each device
    op goes to the innermost span open on the thread that launched it
    (the render, the VAE, the UNet, an attention core, a layer's backward
    on autograd's thread, the background, the normals, the Point-E
    auxiliary guidance and its FPS, a DPT estimator, Adam, ...), else to
    the latest-started span open on any thread (autograd's glue between
    the layers goes to ``backward``); a part's device ms is the union of
    its ops' spans."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.fit(1)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    prof.export_chrome_trace(str(trace))
    what = "a VSD step" if vsd else "a training step"
    ev = [e for e in json.loads(trace.read_text())["traceEvents"]
          if e.get("ph") == "X"]
    dev_ev = [e for e in ev if e.get("cat") in DEVICE_CATS]
    require(len(dev_ev) > 0, f"the profiler saw no device work in {what}")
    launch = {e["args"]["correlation"]: (e["ts"], e["tid"]) for e in ev
              if e.get("cat") in ("cuda_runtime", "cuda_driver")
              and "correlation" in e.get("args", {})}
    spans = sorted(((e["name"][6:], e["ts"], e["ts"] + e["dur"], e["tid"])
                    for e in ev if e.get("cat") == "cpu_op"
                    and e["name"].startswith("gsgen:")),
                   key=lambda s: s[1])

    def group(e):
        """The innermost span around the op's launch on its thread, else
        the latest-started one on any thread."""
        hit = launch.get(e.get("args", {}).get("correlation"))
        if hit is None:
            return "unattributed"
        ts, tid = hit
        inner = None
        for name, a, b, stid in spans:
            if a > ts:
                break
            if b >= ts and (stid == tid or inner is None
                            or inner[1] != tid):
                inner = (name, stid)
        return "other" if inner is None else inner[0]

    # a part's device ms is the union of its ops' spans: cuDNN runs some
    # fp32 convolutions on side streams, so kernel times overlap
    by_group, by_name, fps_ev = {}, {}, []
    for e in dev_ev:
        grp = group(e)
        if grp == "fps":
            fps_ev.append(e)
        by_group.setdefault(grp, []).append(e)
        key = (grp, kernel_key(e["name"]))
        by_name[key] = by_name.get(key, 0.0) + float(e["dur"]) / 1e3
    by_group = {k: busy_us(v) / 1e3 for k, v in by_group.items()}
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    busy_ms = busy_us(dev_ev) / 1e3
    streams = {e.get("args", {}).get("stream") for e in dev_ev}
    info = dict(traced_ms_per_step=wall_ms, device_busy_ms_per_step=busy_ms,
                device_idle_share=1.0 - busy_ms / wall_ms,
                k5_device_ms=sum(float(e["dur"]) / 1e3 for e in dev_ev
                                 if "flash_fwd" in e["name"]),
                k5_split_device_ms=sum(float(e["dur"]) / 1e3 for e in dev_ev
                                       if "flash_fwd_split" in e["name"]),
                k6_device_ms=sum(float(e["dur"]) / 1e3 for e in dev_ev
                                 if "flash_bwd_dkv" in e["name"]),
                k7_device_ms=sum(float(e["dur"]) / 1e3 for e in dev_ev
                                 if "flash_bwd_dq" in e["name"]),
                k5_launches=sum("flash_fwd" in e["name"]
                                and "split" not in e["name"]
                                for e in dev_ev),
                k5_split_launches=sum("flash_fwd_split" in e["name"]
                                      for e in dev_ev),
                k6_k7_launches=[sum(k in e["name"] for e in dev_ev)
                                for k in ("flash_bwd_dkv", "flash_bwd_dq")],
                device_ops_per_step=len(dev_ev), device_streams=len(streams),
                device_ms_by_part=by_group,
                top_device_ms=[[g, k, v] for (g, k), v in top])
    fps_note = ""
    fps_host = [(b - a) / 1e3 for name, a, b, _ in spans if name == "fps"]
    if fps_host:
        info.update(fps_device_ops_per_step=len(fps_ev),
                    fps_device_ms=busy_us(fps_ev) / 1e3,
                    fps_host_ms=sum(fps_host))
        fps_note = (f" | FPS: {len(fps_ev)} device ops, "
                    f"{info['fps_device_ms']:.2f} device ms, "
                    f"{info['fps_host_ms']:.2f} host ms in the step")
    if vsd:
        fps_note += (f" | K5 {info['k5_device_ms']:.2f} device ms in "
                     f"{info['k5_launches']} launches (its split pass "
                     f"{info['k5_split_device_ms']:.2f} in "
                     f"{info['k5_split_launches']}), unet "
                     f"{by_group.get('unet', 0.0):.2f}"
                     f" | K6 {info['k6_device_ms']:.2f} device ms in "
                     f"{info['k6_k7_launches'][0]} launches, K7 "
                     f"{info['k7_device_ms']:.2f} in "
                     f"{info['k6_k7_launches'][1]}, unet_bwd "
                     f"{by_group.get('unet_bwd', 0.0):.2f}, attn_bwd "
                     f"{by_group.get('attn_bwd', 0.0):.2f}")
    phase = phase or ("9 vsd" if vsd else "8 sds")
    print(f"phase {phase} profile: ok 1 "
          f"traced step, {wall_ms:.2f} ms, device "
          f"busy {busy_ms:.2f} ms (idle share "
          f"{info['device_idle_share']:.3f}), {len(dev_ev)} device ops on "
          f"{len(streams)} streams | by part (device ms, union of its "
          "ops' spans): " + ", ".join(
              f"{k} {v:.2f}" for k, v in sorted(by_group.items(),
                                                 key=lambda kv: -kv[1]))
          + fps_note + " | top (summed kernel ms): " + "; ".join(
              f"[{g}] {k} {v:.3f} ms" for (g, k), v in top), flush=True)
    return info


# phase 15: image-to-3D (base.yaml + data/sit3d.yaml, 378², batch 4)
IMAGE_CONFIGS = ["base.yaml", "data/sit3d.yaml"]
# the random-weight DPT's depth is a clamped [0, 1] map: the reference's
# scale 100 (for omnidata's metric-like range) would put the lifted points
# up to 100 units off, so the phase scales it by 1
IMAGE_DEPTH = ["image.depth_scale=1.0"]
IMAGE_TINY = ["data.reso=[32]", "renderer.dup_cap=16384",
              "init.num_points=64", "init.capacity=256",
              "trainer.batch_size=4", "prompt.use_cache=false",
              "guidance.backbone=sd_unet", "guidance.backbone_preset=tiny",
              "renderer.background.type=fixed",
              "image.original_view_prob=0.5"]


def seeded_state(torch, module, seed):
    """A state dict of ``module``'s names drawn from a seeded generator:
    weights ~ N(0, 1/fan_in), norm scales 1 + N(0, 0.1²), biases and
    embeddings N(0, 0.1²); transformers' ``position_ids`` left out."""
    g = torch.Generator().manual_seed(seed)
    sd = {}
    for k, v in module.state_dict().items():
        if "position_ids" in k:
            continue
        n = torch.randn(v.shape, generator=g)
        if v.dim() >= 2 and "embedding" not in k and \
                not k.endswith(("cls_token", "pos_embed")):
            sd[k] = n / math.sqrt(v[0].numel())
        elif "norm" in k and k.endswith("weight"):
            sd[k] = 1.0 + 0.1 * n
        else:
            sd[k] = 0.1 * n
    return sd


def dpt_state(torch, cfg, seed):
    """A random-weight DPT-hybrid state dict whose head sits inside (0, 1)
    (its last conv a tenth of the rest, bias 0.8), so the estimator's clamp
    passes gradient."""
    from gsgen_torch.priors.dpt import DPTHybrid
    sd = seeded_state(torch, DPTHybrid(cfg), seed)
    sd["scratch.output_conv.4.weight"] *= 0.1
    sd["scratch.output_conv.4.bias"] += 0.8
    return sd


def sphere_png(folder, size):
    """A ``size``² RGB PNG: a shaded sphere on white (auto_matte mattes
    it)."""
    import numpy as np

    from gsgen_torch.io.logging import write_png
    yy, xx = np.mgrid[:size, :size]
    r2 = ((xx - size / 2) ** 2 + (yy - size / 2) ** 2) / (0.3 * size) ** 2
    shade = np.sqrt(np.clip(1.0 - r2, 0.0, 1.0))[..., None]
    img = np.where(r2[..., None] < 1.0,
                   np.array([0.8, 0.3, 0.2]) * (0.3 + 0.7 * shade), 1.0)
    path = folder / f"sphere{size}.png"
    write_png(path, img.astype(np.float32))
    return path


def dpt_alone(torch, dev, est, batch, reso):
    """The depth estimator's forward and backward (into the rgb) on
    ``batch`` views at ``reso``², timed alone between CUDA events."""
    x = torch.rand(batch, reso, reso, 3, device=dev, requires_grad=True)

    def fwd_bwd():
        est.estimate(x).sum().backward()

    ms = events_ms(torch, fwd_bwd, iters=3)
    print(f"phase 15 b dpt alone: ok forward + backward into the rgb, "
          f"{batch} views at {reso}^2 -> 384^2: {ms:.2f} ms", flush=True)
    return dict(ms=ms)


def image_phases(torch, dev, build_trainer, load_config, wrappers, card,
                 check_view):
    """Phase 15: image-to-3D.  (a) card against CPU at TINY sizes from one
    state and one set of draws: an image-to-3D step at RES 32 (TINY SD, a
    TINY DPT depth estimator, the grad mask on; the losses and each field's
    gradient), the TINY CLIP text and vision towers, ``encode_grid``'s
    cubic resize, the TINY grid Point-E forward and Make-It-3D's
    ``clip_ref_loss``.  (b) the slice: base.yaml + data/sit3d.yaml (378²,
    batch 4) on a shaded-sphere PNG (auto-matted), its depth from a
    random-weight full-width DPT-hybrid omnidata ``.ckpt``, the DPT depth
    estimator on every render, SD 2.1 bf16: 3 steps with the counters read
    (K1-K4 once a view, K5 5 a step), every loss finite, the frozen front
    rows bitwise unchanged and the others moved, the first view through
    K1-K4 against their plain versions; then one step profiled (render,
    vae, unet, dpt, other).  (c) the normal estimator (3-channel DPT,
    mock guidance): 2 steps, F = 8 through K1/K2.  (d) init.type=
    point_e_image on random-weight base40M-image, upsample and ViT-L/14
    ``.pt`` checkpoints (64 + 64 Karras steps), then a cache hit.  (e)
    Make-It-3D at full width: a random ViT-B/16 tower on the SD 2.1 bf16
    backbone, 4 views at 378², 2 of them original."""
    import copy
    import os
    import shutil
    import tempfile

    import numpy as np

    import gsgen_torch.priors as priors_mod
    from gsgen_torch.guidance import make_it_3d
    from gsgen_torch.guidance.point_e import (BASE40M_IMAGE, TINY_POINT_E_GRID,
                                              UPSAMPLE_CFG,
                                              PointEImageGridModel,
                                              PointEUpsamplerModel)
    from gsgen_torch.io.checkpoint import state_arrays
    from gsgen_torch.priors.dpt import (TINY_DPT, DPTConfig, DPTEstimator,
                                        load_dpt)
    from gsgen_torch.prompt import clip
    from gsgen_torch.prompt.clip_vision import (TINY_VISION, VIT_B16,
                                                VIT_L14, CLIPImageEncoder,
                                                CLIPVisionModelWithProjection)
    from gsgen_torch.training.trainer import train_state_from_jax_arrays

    res = {}
    folder = Path(tempfile.mkdtemp(prefix="gsgen_image_"))
    old_assets = os.environ.get("GSGEN_ASSET_DIR")
    os.environ["GSGEN_ASSET_DIR"] = str(folder / "assets")

    def counted(fn):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for w in wrappers.values():
            w.launches = 0
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, dict(ms=1e3 * (time.perf_counter() - t0),
                         peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                         launches={k: w.launches
                                   for k, w in wrappers.items()})

    def rel(a, b):
        return abs(a - b) / max(abs(b), 1e-12)

    try:
        # ---- a: card against CPU at TINY sizes ----
        png32 = sphere_png(folder, 32)
        rng = np.random.default_rng(0)
        np.save(folder / "depth32.npy",
                rng.uniform(2.3, 2.7, (32, 32)).astype(np.float32))
        over = IMAGE_TINY + [f"image.path={png32}",
                             f"image.depth={folder / 'depth32.npy'}"]
        cfg = load_config([ROOT / "configs" / n for n in IMAGE_CONFIGS],
                          over)
        sd_tiny = dpt_state(torch, TINY_DPT, 1)
        t_cpu = build_trainer(cfg, device="cpu")
        t_card = build_trainer(cfg, device="cuda")
        # one set of TINY UNet / VAE weights (each build draws its own)
        t_card.guidance.backbone = copy.deepcopy(
            t_cpu.guidance.backbone).to(dev)
        B = t_cpu.cfg.batch_size
        g = torch.Generator().manual_seed(3)
        draws = dict(t=torch.tensor([150, 800, 400, 600])[:B],
                     noise=torch.randn(B, 8, 8, 4, generator=g))
        # anisotropic, rotated Gaussians (the image init's isotropic ones
        # have a rotation gradient of rounding noise only)
        sc = t_cpu.state.scene.params
        sc["qvec"] = torch.randn(sc["qvec"].shape, generator=g)
        sc["svec"] = torch.log(0.05 * (0.5 + torch.rand(
            sc["svec"].shape, generator=g)))
        t_card.state = train_state_from_jax_arrays(
            state_arrays(t_cpu.state), "cuda")
        out = {}
        for name, tr in (("cpu", t_cpu), ("card", t_card)):
            d = torch.device("cpu") if name == "cpu" else dev
            tr.estimators = {"depth": DPTEstimator(
                load_dpt(sd_tiny, TINY_DPT, device=d), "depth")}
            orig = tr.guidance.loss

            def injected(*a, _orig=orig, _d=d, **kw):
                kw.update({k: v.to(_d) for k, v in draws.items()})
                return _orig(*a, **kw)

            tr.guidance.loss = injected
            m = tr.train_step(0)
            out[name] = ({k: float(v) for k, v in m.items()
                          if v.dim() == 0},
                         {k: v.detach().cpu()
                          for k, v in tr.state.opt.mu.items()},
                         {k: v.detach().cpu()
                          for k, v in tr.state.scene.params.items()})
        (m_c, mu_c, p_c), (m_d, mu_d, p_d) = out["cpu"], out["card"]
        errs = {}
        for k in ("loss_image", "loss_depth", "loss_est_depth", "loss_sds",
                  "loss_total"):
            require(math.isfinite(m_d[k]) and m_c[k] != 0.0,
                    f"15 a: {k} card {m_d[k]} CPU {m_c[k]}")
            errs[k] = rel(m_d[k], m_c[k])
            require(errs[k] <= 1e-4, f"15 a: {k} card {m_d[k]!r} vs CPU "
                    f"{m_c[k]!r}")
        n_front = int(t_card.grad_mask.sum())
        for k, want in mu_c.items():
            got = mu_d[k]
            scale = float(want.abs().max())
            require(scale > 0, f"15 a: no gradient reached {k}")
            errs[f"grad {k}"] = float((got - want).abs().max()) / scale
            bad = (got - want).abs() > 2e-4 * scale + 2e-3 * want.abs()
            require(not bool(bad.any()), f"15 a: gradient of {k}: "
                    f"{int(bad.sum())} values off")
            if k in p_d:
                require(not bool(got[:n_front].any()),
                        f"15 a: a frozen row of {k} got a moment")
        del t_cpu, t_card

        # the TINY towers, encode_grid, the grid Point-E, clip_ref_loss
        gen = torch.Generator().manual_seed(4)
        sd_text = seeded_state(torch, clip.CLIPTextModelWithProjection(
            clip.TINY_TEXT, 16), 5)
        sd_vis = seeded_state(torch, CLIPVisionModelWithProjection(
            TINY_VISION, 16), 6)
        ids = torch.randint(0, 128, (3, 16), generator=gen)
        img = torch.rand(2, 50, 50, 3, generator=gen)
        ref = torch.rand(40, 40, 3, generator=gen)
        xg = torch.randn(2, 6, 32, generator=gen)
        tg = torch.tensor([3.0, 700.0])
        grid = torch.randn(2, 256, 16, generator=gen)
        grid_sd = PointEImageGridModel(TINY_POINT_E_GRID, "cpu", seed=7
                                       ).module.state_dict()
        grid_sd["output_proj.weight"] = torch.randn(
            grid_sd["output_proj.weight"].shape, generator=gen) * 0.05
        towers = {}
        for where, d in (("cpu", torch.device("cpu")), ("card", dev)):
            text = clip.load_clip_textvec(sd_text, clip.TINY_TEXT, 16,
                                          device=d)
            enc = CLIPImageEncoder.from_state_dict(sd_vis, TINY_VISION, 16,
                                                   device=d)
            pe_grid = PointEImageGridModel(TINY_POINT_E_GRID, d
                                           ).load_weights(grid_sd)
            g3d = make_it_3d.MakeIt3DGuidance(
                make_it_3d.MakeIt3DConfig(backbone_latent_size=8),
                image_encoder=enc, ref_image=ref.to(d), device=d)
            with torch.no_grad():
                towers[where] = dict(
                    text=text(ids.to(d)).cpu(),
                    encode=enc.encode(img.to(d)).cpu(),
                    encode_grid=enc.encode_grid(img.to(d)).cpu(),
                    grid_point_e=pe_grid.apply(xg.to(d), tg.to(d),
                                               grid.to(d)).cpu(),
                    clip_ref_loss=g3d.clip_ref_loss(
                        img.to(d), torch.tensor([0.0, 0.0],
                                                device=d)).cpu())
        for k, want in towers["cpu"].items():
            got = towers["card"][k]
            e = float((got - want).abs().max()) / max(
                float(want.abs().max()), 1e-12)
            errs[k] = e
            require(e <= 1e-4 and bool(torch.isfinite(got).all()),
                    f"15 a: {k} card vs CPU: max rel err {e:.3e}")
        res["a"] = dict(rel_err=errs)
        print("phase 15 a card vs cpu: ok tiny base.yaml + data/sit3d.yaml "
              "image step (RES 32, TINY SD, TINY DPT depth estimator, grad "
              f"mask on {n_front} rows), TINY CLIP text / vision, "
              "encode_grid (cubic), TINY grid Point-E, clip_ref_loss: max "
              "|card - CPU| / max |CPU| " + ", ".join(
                  f"{k} {v:.2e}" for k, v in errs.items()), flush=True)

        # ---- b: the slice at 378² ----
        png = sphere_png(folder, 378)
        for mode, seed in (("depth", 8), ("normal", 9)):
            cfg_d = DPTConfig(num_channels=1 if mode == "depth" else 3)
            torch.save({"state_dict": {
                "model." + k: v for k, v in dpt_state(torch, cfg_d,
                                                      seed).items()}},
                folder / f"dpt_{mode}.ckpt")
        over = SLICE + IMAGE_DEPTH + [
            f"image.path={png}",
            f"image.dpt_checkpoint={folder / 'dpt_depth.ckpt'}",
            "trainer.estimators.depth.enabled=true",
            f"trainer.estimators.depth.checkpoint={folder / 'dpt_depth.ckpt'}"]
        rec, restore = record_render_inputs(torch)
        snap = {}

        def keep(tr):
            snap["p0"] = {k: v.detach().clone()
                          for k, v in tr.state.scene.params.items()}
            snap["n_front"] = int(tr.grad_mask.sum())

        terms = []

        def losses(tr, step, metrics):
            terms.append({k: float(metrics[k]) for k in (
                "loss_sds", "loss_image", "loss_depth", "loss_est_depth",
                "loss_total")})

        try:
            trainer, b = drive(torch, build_trainer, load_config, wrappers,
                               IMAGE_CONFIGS, over, 3,
                               dict(flash_attn_fwd=5), prepare=keep,
                               on_step=losses)
        finally:
            restore()
        require(all(math.isfinite(v) for t_ in terms for v in t_.values()),
                f"15 b: loss terms {terms}")
        require(any(t_["loss_image"] > 0 for t_ in terms),
                f"15 b: no original view in 3 steps: {terms}")
        n = snap["n_front"]
        frozen, moved = {}, {}
        for k, v in trainer.state.scene.params.items():
            frozen[k] = bool(torch.equal(v[:n], snap["p0"][k][:n]))
            moved[k] = float((v[n:] - snap["p0"][k][n:]).abs().max())
        require(all(frozen.values()), f"15 b: front rows moved: {frozen}")
        require(all(m > 0 for m in moved.values()),
                f"15 b: other rows did not move: {moved}")
        b["kernel_note"] = check_view("15 b step 0 view 0", rec, trainer)
        b.update(loss_terms=terms, n_front=n, other_rows_moved=moved)
        print(f"phase 15 b image: ok | card {card} | {b['config']}: "
              f"{b['steps']} steps, batch {b['batch']}, {b['reso']}^2 | "
              f"loss terms {terms} | ms/step "
              f"{[round(x, 2) for x in b['ms_per_step']]} | peak "
              f"{b['peak_gib']:.2f} GiB | launches {b['launches']} | "
              f"{n} front rows bitwise frozen, the other rows moved "
              f"(max {moved}) | first view through K1-K4 against plain: "
              f"{b['kernel_note']}", flush=True)
        b["profile"] = profile_step(
            torch, trainer, ROOT / "gsgen_torch" / "_build" /
            "image_step_trace.json", vsd=False, phase="15 b")
        b["dpt_alone"] = dpt_alone(torch, dev, trainer.estimators["depth"],
                                   b["batch"], b["reso"])
        res["b"] = b

        # ---- e: Make-It-3D at full width on (b)'s SD 2.1 backbone ----
        bb = trainer.guidance.backbone
        emb = trainer.prompt_processor()
        enc = CLIPImageEncoder.from_state_dict(
            seeded_state(torch, CLIPVisionModelWithProjection(VIT_B16, 512),
                         10), VIT_B16, 512, device=dev)
        ref = trainer.image_target.image
        g3d = make_it_3d.MakeIt3DGuidance(make_it_3d.MakeIt3DConfig(), bb,
                                          image_encoder=enc, ref_image=ref,
                                          device=dev)
        gen = torch.Generator(device=dev).manual_seed(11)
        rgb = torch.rand(4, 378, 378, 3, generator=gen, device=dev)
        cams = [torch.tensor(v, device=dev) for v in
                ([0.0, 20.0, 0.0, -10.0], [0.0, 90.0, 0.0, 200.0],
                 [2.0] * 4)]
        is_orig = torch.tensor([1.0, 0.0, 1.0, 0.0], device=dev)
        sched = trainer.sched_scalars(0)

        def m3d_step():
            x = rgb.detach().requires_grad_(True)
            r = g3d.loss(x, emb, *cams, generator=gen, sched=sched,
                         batch_is_original=is_orig)
            (r["loss_sds"] + r["loss_clip"]).backward()
            return r, x.grad

        m3d_step()
        (r_e, grad_e), e = counted(m3d_step)
        vals = {k: float(r_e[k].detach()) for k in ("loss_sds", "loss_clip")}
        gnorm = float(grad_e.norm())
        require(all(math.isfinite(v) for v in vals.values())
                and vals["loss_clip"] > 0 and math.isfinite(gnorm)
                and gnorm > 0, f"15 e: Make-It-3D {vals}, |grad| {gnorm}")
        require(e["launches"] == {k: 5 if k == "flash_attn_fwd" else 0
                                  for k in wrappers},
                f"15 e: launches {e['launches']}")
        res["e"] = dict(losses=vals, rgb_grad_norm=gnorm, **e)
        print(f"phase 15 e make_it_3d: ok | card {card} | SD 2.1 bf16 + "
              "random ViT-B/16 CLIP tower, 4 views at 378^2 (2 original) | "
              f"{vals} | rgb grad norm {gnorm:.4e} | {e['ms']:.1f} ms, peak "
              f"{e['peak_gib']:.2f} GiB, launches {e['launches']}",
              flush=True)
        del trainer, bb, g3d, enc, emb
        torch.cuda.empty_cache()

        # ---- c: the normal estimator, F = 8 through K1/K2 ----
        rec, restore = record_render_inputs(torch)
        try:
            trainer, c = drive(
                torch, build_trainer, load_config, wrappers, IMAGE_CONFIGS,
                ["guidance.type=mock", f"image.path={png}",
                 "trainer.estimators.normal.enabled=true",
                 "trainer.estimators.normal.checkpoint="
                 f"{folder / 'dpt_normal.ckpt'}"], 2, {})
        finally:
            restore()
        F = rec["raster"][0][3].shape[-1]
        require(trainer.rcfg.render_normal and F == 8,
                f"15 c: render_normal {trainer.rcfg.render_normal}, F {F}")
        c["kernel_note"] = check_view("15 c step 0 view 0 F=8", rec, trainer)
        print(f"phase 15 c normal estimator: ok | card {card} | "
              f"{c['config']}: {c['steps']} steps, batch {c['batch']}, "
              f"{c['reso']}^2 | losses {c['losses']} | ms/step "
              f"{[round(x, 2) for x in c['ms_per_step']]} | peak "
              f"{c['peak_gib']:.2f} GiB | launches {c['launches']} | F = 8 "
              f"through K1/K2 against plain: {c['kernel_note']}", flush=True)
        res["c"] = c
        del trainer
        torch.cuda.empty_cache()

        # ---- d: init.type=point_e_image ----
        ck = {}
        sd = seeded_state(torch, CLIPVisionModelWithProjection(VIT_L14, 768),
                          12)
        ck["clip"] = folder / "vit_l14.pt"
        torch.save(sd, ck["clip"])
        for i, (name, model) in enumerate((
                ("base40M-image", PointEImageGridModel(BASE40M_IMAGE, "cpu",
                                                       seed=13)),
                ("upsample", PointEUpsamplerModel(UPSAMPLE_CFG, "cpu",
                                                  seed=14)))):
            state = model.module.state_dict()
            gen = torch.Generator().manual_seed(15 + i)
            for k in ("output_proj.weight", "output_proj.bias"):
                state[k] = torch.randn(state[k].shape, generator=gen) * 0.02
            ck[name] = folder / f"{name}.pt"
            torch.save(state, ck[name])
        del sd
        over = ["guidance.type=mock", "init.type=point_e_image",
                f"init.image={png}", f"init.point_e_image_base="
                f"{ck['base40M-image']}",
                f"init.point_e_upsample={ck['upsample']}",
                f"init.clip_vision_dir={ck['clip']}"]
        cfg = load_config(ROOT / "configs" / "base.yaml", over)
        tr, d1 = counted(lambda: build_trainer(cfg, device="cuda"))
        mean = tr.state.scene.params["mean"][tr.state.scene.active]
        require(mean.shape[0] == 4096 and bool(torch.isfinite(mean).all()),
                f"15 d: init cloud {tuple(mean.shape)}")
        cached = priors_mod._asset_path(priors_mod._image_key(str(png)),
                                        "point_e_image")
        require(cached.exists(), f"15 d: no cached cloud at {cached}")
        del tr
        tr, d2 = counted(lambda: build_trainer(load_config(
            ROOT / "configs" / "base.yaml",
            over[:3] + ["init.point_e_image_base=/nonexistent.pt"]),
            device="cuda"))
        require(d2["ms"] < d1["ms"], f"15 d: cache hit {d2['ms']} ms vs "
                f"sampling {d1['ms']} ms")
        res["d"] = dict(sample=d1, cache_hit=d2)
        print(f"phase 15 d point_e_image: ok | card {card} | random-weight "
              "base40M-image + upsample + ViT-L/14 .pt, 64 + 64 Karras "
              f"steps at CFG 3, build_trainer {d1['ms'] / 1e3:.3f} s (peak "
              f"{d1['peak_gib']:.2f} GiB), then from the cache "
              f"{d2['ms'] / 1e3:.3f} s", flush=True)
        del tr
        torch.cuda.empty_cache()
    finally:
        if old_assets is None:
            os.environ.pop("GSGEN_ASSET_DIR", None)
        else:
            os.environ["GSGEN_ASSET_DIR"] = old_assets
        shutil.rmtree(folder, ignore_errors=True)
    return res


# phase 16: weights from model directories
SD15_CONFIGS = ["base.yaml", "guidance/sd.yaml", "prompt/sd.yaml"]
SD15_ATTN = (8, 4096, 8, 40)    # SD 1.5 level 0 under "auto" (CFG batch 8)
# the self-attention levels fused_attention "on" also sends to K5 (L % 128
# == 0); the mid block's [8, 64, 8, 160] is not eligible in either package
SD15_ON_ATTN = {"level 1": (8, 1024, 8, 80), "level 2": (8, 256, 8, 160)}
SAFETENSORS_CODES = {"float32": "F32", "float16": "F16", "bfloat16": "BF16",
                     "int64": "I64", "int32": "I32"}
T5_PAD, T5_EOS, T5_UNK = 0, 1, 2
SHAP_E_PROMPT = "a shap-e corgi"


def write_safetensors(torch, path, tensors):
    """A ``.safetensors`` file (the card's machine has no safetensors
    package): an 8-byte header length, the JSON header padded to 8 bytes,
    then each tensor's bytes in order."""
    header, at = {}, 0
    for name, v in tensors.items():
        n = v.numel() * v.element_size()
        header[name] = {"dtype": SAFETENSORS_CODES[str(v.dtype)[6:]],
                        "shape": list(v.shape), "data_offsets": [at, at + n]}
        at += n
    head = json.dumps(header).encode()
    head += b" " * (-len(head) % 8)
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    with open(path, "wb") as f:
        f.write(len(head).to_bytes(8, "little") + head)
        for v in tensors.values():
            f.write(v.detach().cpu().contiguous().view(torch.uint8)
                    .numpy().tobytes())


# the words that the script's tokenizer vocabularies are first made of:
# the shipped configs' prompts, their view prompts and the debiasing probe
TOKENIZER_CORPUS = (
    "a corgi, side view; a corgi, front view; a corgi, back view; a corgi, "
    "overhead view; side view of a corgi; front view of a corgi; backside "
    "view of a corgi; overhead view of a corgi; a high quality photo of a "
    "furry corgi; a highly detailed stone bust of theodoros kolokotronis; "
    "michelangelo style statue of dog reading news on a cellphone; a test "
    "blob; this image is depicting a view of; a shap-e corgi")
CLIP_MERGES = 49152 - 256 - 2      # 48,894: CLIP's merges.txt
CLIP_BOS, CLIP_EOS = 49406, 49407
T5_PIECES = 32000
BERT_VOCAB = 30522
BERT_UNK, BERT_CLS, BERT_SEP, BERT_MASK = 100, 101, 102, 103


def corpus_words():
    """TOKENIZER_CORPUS's words (CLIP's split on lower-case ASCII), by
    count, then in order."""
    words = re.findall(r"[a-z]+|[0-9]|[^\sa-z0-9]+", TOKENIZER_CORPUS)
    return sorted(dict.fromkeys(words), key=lambda w: -words.count(w))


def clip_tokenizer_files(folder, pad):
    """``folder/tokenizer`` of CLIP's size and layout: 49,408 ids (the 256
    byte symbols in GPT-2's table order, their 256 ``</w>`` forms, one
    token a merge, ``<|startoftext|>`` 49406, ``<|endoftext|>`` 49407) and
    48,894 merges in a fixed order: pairs by count over TOKENIZER_CORPUS's
    words first, then pairs of byte symbols in table order, each making a
    token that is not yet in the vocabulary; SD 1.5's tokenizer_config
    (``pad`` "<|endoftext|>") or SD 2.1's (``pad`` "!").  Returns the
    vocabulary."""
    from gsgen_torch.prompt.tokenizer_files import bytes_to_unicode

    table = bytes_to_unicode()
    syms = list(table.values())
    vocab = {s: i for i, s in enumerate(syms)}
    vocab.update({s + "</w>": 256 + i for i, s in enumerate(syms)})
    merges = []

    def merge(a, b):
        merges.append((a, b))
        vocab[a + b] = len(vocab)

    seqs = {w: [table[b] for b in w.encode()] for w in corpus_words()}
    for seq in seqs.values():
        seq[-1] += "</w>"
    counts = {w: TOKENIZER_CORPUS.count(w) for w in seqs}
    while True:
        pairs = {}
        for w, seq in seqs.items():
            for pair in zip(seq, seq[1:]):
                if "".join(pair) not in vocab:
                    pairs[pair] = pairs.get(pair, 0) + counts[w]
        if not pairs:
            break
        a, b = max(pairs, key=lambda pr: (pairs[pr], pr))
        merge(a, b)
        for w, seq in seqs.items():
            out, i = [], 0
            while i < len(seq):
                if seq[i:i + 2] == [a, b]:
                    out.append(a + b)
                    i += 2
                else:
                    out.append(seq[i])
                    i += 1
            seqs[w] = out
    for a in syms:
        for b in syms + [s + "</w>" for s in syms]:
            if len(merges) == CLIP_MERGES:
                break
            if a + b not in vocab:
                merge(a, b)
    vocab["<|startoftext|>"] = CLIP_BOS
    vocab["<|endoftext|>"] = CLIP_EOS
    require(len(vocab) == 49408 and len(merges) == CLIP_MERGES,
            f"CLIP vocabulary {len(vocab)} ids, {len(merges)} merges")
    d = Path(folder) / "tokenizer"
    d.mkdir(parents=True, exist_ok=True)
    (d / "vocab.json").write_text(json.dumps(vocab))
    (d / "merges.txt").write_text("#version: 0.2\n" + "\n".join(
        f"{a} {b}" for a, b in merges) + "\n")
    special = {k: {"__type": "AddedToken", "content": v, "lstrip": False,
                   "normalized": True, "rstrip": False, "single_word": False}
               for k, v in (("bos_token", "<|startoftext|>"),
                            ("eos_token", "<|endoftext|>"),
                            ("unk_token", "<|endoftext|>"))}
    special["pad_token"] = pad
    (d / "tokenizer_config.json").write_text(json.dumps(dict(
        special, add_prefix_space=False, do_lower_case=True,
        model_max_length=77, tokenizer_class="CLIPTokenizer")))
    (d / "special_tokens_map.json").write_text(json.dumps(special))
    return vocab


def clip_decode(vocab, ids):
    """The words of CLIP ids between the start and end tokens: each
    pre-token's symbols (up to ``</w>``) back through GPT-2's byte
    table."""
    from gsgen_torch.prompt.tokenizer_files import bytes_to_unicode

    inv = {v: k for k, v in vocab.items()}
    back = {c: b for b, c in bytes_to_unicode().items()}
    ids = list(ids)
    text = "".join(inv[i] for i in ids[1:ids.index(CLIP_EOS)])
    return " ".join(bytes(back[c] for c in w).decode()
                    for w in text.split("</w>") if w)


def pb_varint(n):
    n &= (1 << 64) - 1
    out = bytearray()
    while True:
        b, n = n & 0x7F, n >> 7
        out.append(b | (0x80 if n else 0))
        if not n:
            return bytes(out)


def pb_field(num, wire, payload):
    """One protobuf field: a varint (wire 0), a float32 (wire 5) or
    length-delimited bytes (wire 2)."""
    key = pb_varint(num << 3 | wire)
    if wire == 0:
        return key + pb_varint(payload)
    if wire == 5:
        return key + struct.pack("<f", payload)
    return key + pb_varint(len(payload)) + payload


def t5_tokenizer_files(folder):
    """``folder/tokenizer/spiece.model`` of T5 v1.1's size and layout,
    written by the script's own protobuf writer: 32,000 Unigram pieces
    (``<pad>`` 0 and ``</s>`` 1 control, ``<unk>`` 2), ``"▁" + word`` for
    TOKENIZER_CORPUS's words, printable ASCII and ``"▁"``, then ``"▁" +``
    two- and three-letter strings in a fixed order, scores falling with
    the id; trainer spec unk 2, eos 1, pad 0; no precompiled charsmap; and
    a tokenizer_config with T5's 100 extra ids (ids 32,000-32,099).
    Returns the pieces."""
    import itertools
    import string

    pieces = [("<pad>", 0.0, 3), ("</s>", 0.0, 3), ("<unk>", 0.0, 2),
              ("▁", -2.0, 1)]
    seen = {p for p, _, _ in pieces}

    def add(p, score):
        if p not in seen and len(pieces) < T5_PIECES:
            seen.add(p)
            pieces.append((p, score, 1))

    for i, w in enumerate(corpus_words()):
        add("▁" + w, -5.0 - 0.01 * i)
    for i, c in enumerate(string.ascii_letters + string.digits
                          + string.punctuation):
        add(c, -12.0 - 0.01 * i)
    letters = string.ascii_lowercase
    for n in (2, 3):
        for i, t in enumerate(itertools.product(letters, repeat=n)):
            add("▁" + "".join(t), -8.0 - n - 1e-5 * i)
            add("".join(t), -9.0 - n - 1e-5 * i)
    require(len(pieces) == T5_PIECES, f"T5 pieces {len(pieces)}")
    proto = b"".join(pb_field(1, 2, pb_field(1, 2, p.encode())
                              + pb_field(2, 5, s) + pb_field(3, 0, t))
                     for p, s, t in pieces)
    proto += pb_field(2, 2, pb_field(3, 0, 1) + pb_field(4, 0, T5_PIECES)
                      + pb_field(40, 0, 2) + pb_field(41, 0, -1)
                      + pb_field(42, 0, 1) + pb_field(43, 0, 0))
    proto += pb_field(3, 2, pb_field(1, 2, b"identity") + pb_field(3, 0, 1)
                      + pb_field(4, 0, 1) + pb_field(5, 0, 1))
    d = Path(folder) / "tokenizer"
    d.mkdir(parents=True, exist_ok=True)
    (d / "spiece.model").write_bytes(proto)
    (d / "tokenizer_config.json").write_text(json.dumps(
        {"tokenizer_class": "T5Tokenizer", "extra_ids": 100,
         "model_max_length": 77}))
    return pieces


def bert_tokenizer_files(folder):
    """``folder/vocab.txt`` of 30,522 entries in bert-base-uncased's
    layout: ``[PAD]`` 0, ``[unused0-98]``, ``[UNK]`` 100, ``[CLS]`` 101,
    ``[SEP]`` 102, ``[MASK]`` 103, ``[unused99-993]``, printable ASCII and
    its ``##`` forms, TOKENIZER_CORPUS's words, then two- and three-letter
    words and their ``##`` forms in a fixed order; do_lower_case.
    Returns the vocabulary list."""
    import itertools
    import string

    words = (["[PAD]"] + [f"[unused{i}]" for i in range(99)]
             + ["[UNK]", "[CLS]", "[SEP]", "[MASK]"]
             + [f"[unused{i}]" for i in range(99, 994)])
    seen = set(words)
    chars = [c for c in string.printable[:94] if not c.isupper()]
    for w in (chars + ["##" + c for c in chars] + corpus_words()
              + ["".join(t) for n in (2, 3)
                 for t in itertools.product(string.ascii_lowercase,
                                            repeat=n)]
              + ["##" + "".join(t) for n in (2, 3)
                 for t in itertools.product(string.ascii_lowercase,
                                            repeat=n)]):
        if w not in seen and len(words) < BERT_VOCAB:
            seen.add(w)
            words.append(w)
    require(len(words) == BERT_VOCAB, f"BERT vocabulary {len(words)}")
    Path(folder).mkdir(parents=True, exist_ok=True)
    (Path(folder) / "vocab.txt").write_text("\n".join(words) + "\n")
    (Path(folder) / "tokenizer_config.json").write_text(json.dumps(
        {"tokenizer_class": "BertTokenizer", "do_lower_case": True}))
    return words


def timed_tokenizer():
    """Wrap the port's ``Tokenizer.__call__``: each call's host ms, its
    texts, ids and masks are kept.  Returns (calls, restore)."""
    from gsgen_torch.prompt import tokenizer_files

    calls = []
    orig = tokenizer_files.Tokenizer.__call__

    def call(self, texts, max_length):
        texts = list(texts)
        t0 = time.perf_counter()
        ids, mask = orig(self, texts, max_length)
        calls.append(dict(ms=1e3 * (time.perf_counter() - t0), texts=texts,
                          ids=ids, mask=mask, path=self.path))
        return ids, mask
    tokenizer_files.Tokenizer.__call__ = call
    return calls, lambda: setattr(tokenizer_files.Tokenizer, "__call__",
                                  orig)


def sd_directory(torch, folder, dev, preset="sd15"):
    """A random diffusers directory of ``preset`` (sd15 | sd21): unet/ in
    fp16, vae/ in fp32, text_encoder/ the preset's CLIP text tower in fp32
    (ViT-L/14 or OpenCLIP ViT-H/14, config.json beside) and tokenizer/ at
    CLIP's full size (clip_tokenizer_files: SD 1.5 pads with
    <|endoftext|>, SD 2.1 with "!"); for SD 1.5 also clip_textvec/: the
    same tower with a text_projection (Point-E's and Shap-E's text
    vector).  Returns the tensors written and the vocabulary."""
    from gsgen_torch.guidance.sd_unet import SD15, SD21, SDUNetBackbone
    from gsgen_torch.prompt import clip

    gen = torch.Generator(device=dev).manual_seed(40)
    bb = SDUNetBackbone(dict(sd15=SD15, sd21=SD21)[preset], latent_size=64,
                        device=dev, generator=gen)
    written = {}
    for name, dt in (("unet", torch.float16), ("vae", torch.float32)):
        written[name] = {k: v.to(dt).cpu() for k, v in
                         getattr(bb, name).state_dict().items()}
        write_safetensors(torch, folder / name /
                          "diffusion_pytorch_model.safetensors",
                          written[name])
    del bb
    vocab = clip_tokenizer_files(
        folder, "<|endoftext|>" if preset == "sd15" else "!")
    c = clip.SD15_TEXT if preset == "sd15" else clip.SD21_TEXT
    hf = dict(vocab_size=c.vocab_size, hidden_size=c.hidden_size,
              intermediate_size=c.intermediate_size,
              num_hidden_layers=c.num_hidden_layers,
              num_attention_heads=c.num_attention_heads,
              max_position_embeddings=c.max_position_embeddings,
              hidden_act=c.hidden_act)
    with torch.device("meta"):
        shapes = clip.CLIPTextModel(c)
    text = seeded_state(torch, shapes, 41)
    written["text_encoder"] = text
    towers = [("text_encoder", "CLIPTextModel", {})]
    if preset == "sd15":
        towers.append(("clip_textvec/text_encoder",
                       "CLIPTextModelWithProjection",
                       {"text_projection.weight": torch.randn(
                           768, 768, generator=torch.Generator().manual_seed(
                               42)) / math.sqrt(768)}))
    for sub, arch, extra in towers:
        write_safetensors(torch, folder / sub / "model.safetensors",
                          {**text, **extra})
        (folder / sub / "config.json").write_text(json.dumps(dict(
            hf, architectures=[arch], projection_dim=768)))
    return written, vocab


def k5_row(torch, q, k, v, time_ms):
    """K5 on [B, L, H, D] bf16 inputs against its plain version (within
    FLASH_TOL of the plain output's largest value), then its device time
    (a CUDA graph of 50 calls), SDPA's the same way on [B, H, L, D] views,
    the plain version's (host loop, 3 calls) and the bound (k5_bound,
    k5_bench.bound_ms)."""
    import torch.nn.functional as F

    from gsgen_torch.ops import flash_attention as fa
    B, L, H, D = q.shape
    scale = D ** -0.5
    got = fa.flash_self_attention(q, k, v, scale).float()
    want = fa.flash_self_attention_plain(q, k, v, scale).float()
    err, top = float((got - want).abs().max()), float(want.abs().max())
    del got, want
    tol = FLASH_TOL["bfloat16"] * top
    require(err <= tol, f"K5 {[B, L, H, D]}: max abs err "
            f"{err:.3e} above {tol:.3e}")
    qh, kh, vh = (x.transpose(1, 2) for x in (q, k, v))
    ms = graph_ms(lambda: fa.flash_self_attention(q, k, v, scale))
    bound, by = k5_bound(B, L, H, D, q.dtype)
    require(bound <= ms, f"K5 {[B, L, H, D]}: {ms:.4f} ms reads under its "
            f"{bound:.4f} ms {by} bound")
    return dict(shape=[B, L, H, D], dtype="bfloat16", max_abs_err=err,
                tol=tol, ms=ms, bound_ms=bound, bound_by=by,
                instance=list(fa.fwd_tiles(q.dtype, D)),
                pct_of_bound=100.0 * bound / ms,
                plain_ms=time_ms(lambda: fa.flash_self_attention_plain(
                    q, k, v, scale), 3),
                library_ms=graph_ms(lambda: F.scaled_dot_product_attention(
                    qh, kh, vh, scale=scale)))


def k5_note(r):
    return (f"{r['shape']}: {r['ms']:.4f} ms ({r['pct_of_bound']:.1f}% of "
            f"its {r['bound_ms']:.4f} ms {r['bound_by']} bound), plain "
            f"{r['plain_ms']:.3f} ms, SDPA {r['library_ms']:.4f} ms, max abs "
            f"err {r['max_abs_err']:.2e} (tol {r['tol']:.2e})")


def icosphere_obj(path, levels=3):
    """A unit icosphere (``levels`` subdivisions) as an .obj; returns its
    vertex count."""
    import numpy as np
    t = (1.0 + 5 ** 0.5) / 2
    verts = [[-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0], [0, -1, t],
             [0, 1, t], [0, -1, -t], [0, 1, -t], [t, 0, -1], [t, 0, 1],
             [-t, 0, -1], [-t, 0, 1]]
    faces = [[0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
             [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
             [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
             [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1]]
    for _ in range(levels):
        mid, out = {}, []

        def half(a, b):
            key = (min(a, b), max(a, b))
            if key not in mid:
                mid[key] = len(verts)
                verts.append([(x + y) / 2 for x, y in zip(verts[a],
                                                          verts[b])])
            return mid[key]
        for a, b, c in faces:
            ab, bc, ca = half(a, b), half(b, c), half(c, a)
            out += [[a, ab, ca], [b, bc, ab], [c, ca, bc], [ab, bc, ca]]
        faces = out
    v = np.asarray(verts, np.float64)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    Path(path).write_text("".join(f"v {x} {y} {z}\n" for x, y, z in v)
                          + "".join(f"f {a + 1} {b + 1} {c + 1}\n"
                                    for a, b, c in faces))
    return len(v)


def shap_e_decoder_state(torch, seed, d_latent=1024, hidden=255,
                         n_out=12):
    """A random Shap-E vector decoder at the latent's full size: four meta
    layers (NeRF-encoded positions -> 255 -> 255 -> 255 -> 255, each a
    weight and a bias: 4 x 256 = 1,024 latent rows of 1,024) with
    LayerNorm projections, and a plain last layer to 12 outputs.  The
    first layer's LayerNorm and bias scale the encoding's frequency 2^k by
    2^-k, so that the field is smooth, as a trained decoder's is."""
    g = torch.Generator().manual_seed(seed)
    # input channel -> its frequency k in posenc_nerf's layout [x (3) |
    # sin(x 2^k) (45) | cos (45)], k-major within each half
    freq = torch.tensor([0] * 3 + [(c % 45) // 3 for c in range(90)],
                        dtype=torch.float32)

    def rnd(*shape):
        return torch.randn(*shape, generator=g)
    dims = [(93, hidden)] + [(hidden, hidden)] * 3
    state = {}
    for i, (inn, out) in enumerate(dims):
        for kind, (vec, c) in (("weight", (out, inn)), ("bias", (1, out))):
            pre = f"params_proj.projections.nerstf__mlp__{i}__{kind}"
            state[f"{pre}.proj.weight"] = rnd(vec * c, d_latent) / math.sqrt(
                d_latent)
            damp = 0.5 ** freq if (i, kind) == (0, "weight") else 1.0
            state[f"{pre}.proj.bias"] = 0.1 * (rnd(vec, c) * damp).reshape(
                -1) / math.sqrt(c)
            state[f"{pre}.norm.weight"] = (1 + 0.1 * rnd(c)) * damp / \
                math.sqrt(c)
            state[f"{pre}.norm.bias"] = 0.1 * rnd(c) * damp / math.sqrt(c)
    state["renderer.nerstf.mlp.4.weight"] = rnd(n_out, hidden) / math.sqrt(
        hidden)
    state["renderer.nerstf.mlp.4.bias"] = 0.1 * rnd(n_out)
    return state


def weights_phases(torch, dev, build_trainer, load_config, wrappers, card,
                   check_view, time_ms):
    """Phase 16: the port's loaders on random weights the script writes
    (module docstring, item 16)."""
    import os
    import shutil
    import tempfile

    import numpy as np

    import gsgen_torch.guidance.unet2d as unet_mod
    from gsgen_torch import priors
    from gsgen_torch.guidance import convert
    from gsgen_torch.guidance.point_e import PointEConfig, PointEModel
    from gsgen_torch.guidance.sd_unet import SD15
    from gsgen_torch.guidance.unet2d import IF_PIXEL
    from gsgen_torch.priors.shap_e import ShapEDecoder, sample_shap_e_latent
    from gsgen_torch.prompt import bert, debias, encoders, processors, t5

    from gsgen_torch.prompt import tokenizer_files

    res = {}
    folder = Path(tempfile.mkdtemp(prefix="gsgen_weights_"))
    old_assets = os.environ.get("GSGEN_ASSET_DIR")
    os.environ["GSGEN_ASSET_DIR"] = str(folder / "assets")
    calls, restore_tok = timed_tokenizer()

    def tokenized(since, label):
        """The tokenizer calls after ``since``: one at least; their host
        ms and texts."""
        made = calls[since:]
        require(made, f"16 {label}: the port's tokenizer was not called")
        return dict(ms=[round(c["ms"], 3) for c in made],
                    texts=sum(len(c["texts"]) for c in made))

    try:
        # ---- a: SD 1.5 through guidance.weights_path ----
        t0 = time.perf_counter()
        sd_dir = folder / "sd15"
        written, vocab = sd_directory(torch, sd_dir, dev)
        write_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        clip_tok = tokenizer_files.load_tokenizer(str(sd_dir / "tokenizer"))
        clip_load_ms = 1e3 * (time.perf_counter() - t0)
        t0 = time.perf_counter()
        n_read = 0
        for name in ("unet", "vae", "text_encoder"):
            back = convert.load_safetensors(sd_dir / name)
            require(list(back) == sorted(written[name]),
                    f"16 a: {name} keys read back differ")
            for k, v in written[name].items():
                require(back[k].dtype == v.dtype and torch.equal(back[k], v),
                        f"16 a: {name} {k} not bitwise the one written")
                n_read += 1
        read_s = time.perf_counter() - t0

        def prepare(tr):
            bb = tr.guidance.backbone
            require(bb.cfg == SD15 and all(
                p.dtype == torch.bfloat16 for p in bb.parameters()),
                "16 a: guidance/sd.yaml did not build SD 1.5 in bf16")
            for name in ("unet", "vae"):
                mine = getattr(bb, name).state_dict()
                for k, v in written[name].items():
                    require(torch.equal(mine[k].cpu(),
                                        v.float().to(torch.bfloat16)),
                            f"16 a: backbone {name} {k} is not the file's")
            pcfg = tr.prompt_processor.cfg
            require(pcfg.model_id == str(sd_dir) and not pcfg.use_cache,
                    f"16 a: prompt.model_id {pcfg.model_id!r}")

        kept = {}
        orig_k5 = unet_mod.flash_self_attention

        def keep_qkv(q, k, v, scale):
            # the step's first q, k, v at each head width K5 sees
            if q.shape[-1] not in kept:
                kept[q.shape[-1]] = tuple(x.detach().clone()
                                          for x in (q, k, v))
            return orig_k5(q, k, v, scale)

        sd_over = ["prompt.use_cache=false", f"prompt.model_id={sd_dir}",
                   f"guidance.weights_path={sd_dir}"]
        rec, restore = record_render_inputs(torch)
        unet_mod.flash_self_attention = keep_qkv
        n_calls = len(calls)
        try:
            trainer, a = drive(
                torch, build_trainer, load_config, wrappers, SD15_CONFIGS,
                sd_over, 3, dict(flash_attn_fwd=5), prepare=prepare)
        finally:
            unet_mod.flash_self_attention = orig_k5
            restore()
        emb = trainer.prompt_processor()
        require(tuple(emb.text.shape) == (77, 768) and bool(
            torch.isfinite(emb.text_vd).all()),
            f"16 a: prompt embedding {tuple(emb.text.shape)}")
        # the path's own texts (prompt, negative, view prompts) through the
        # port's tokenizer: start and end tokens, <|endoftext|> padding, the
        # words back from the ids, one id a word (TOKENIZER_CORPUS's words
        # are merged whole)
        a["tokenize"] = tokenized(n_calls, "a")
        call = calls[n_calls]
        for text, row, m in zip(call["texts"], call["ids"], call["mask"]):
            n = int(m.sum())
            words = " ".join(re.findall(r"[a-z]+|[0-9]|[^\sa-z0-9]+",
                                        text.lower()))
            require(row[0] == CLIP_BOS and row[n - 1] == CLIP_EOS
                    and (row[n:] == CLIP_EOS).all()
                    and clip_decode(vocab, row) == words
                    and n == len(words.split()) + 2,
                    f"16 a: {text!r} tokenized as {row[:n].tolist()}")
        prompt_ids = call["ids"][0][:int(call["mask"][0].sum())].tolist()
        a["kernel_note"] = check_view("16 a step 0 view 0", rec, trainer)
        require(list(kept) == [SD15_ATTN[-1]],
                f"16 a: K5 saw head widths {list(kept)} under auto")
        q, k, v = kept.pop(SD15_ATTN[-1])
        require(tuple(q.shape) == SD15_ATTN and q.dtype == torch.bfloat16,
                f"16 a: K5 took {tuple(q.shape)} {q.dtype}")
        a.update(write_s=write_s, read_s=read_s, tensors_read=n_read)
        print(f"phase 16 a sd15: ok | card {card} | {a['config']}: "
              f"{a['steps']} steps, batch {a['batch']}, {a['reso']}^2, "
              f"bf16, padded | a random SD 1.5 diffusers directory written "
              f"in {write_s:.1f} s (unet fp16, vae and text_encoder fp32), "
              f"{n_read} tensors read back bitwise in {read_s:.1f} s, the "
              "backbone's weights bitwise the file's in bf16 | prompt "
              "embeddings through prompt.model_id: the text and its view "
              "prompts through the port's CLIP tokenizer (49,408 ids, "
              f"48,894 merges; load {clip_load_ms:.1f} ms, tokenize "
              f"{a['tokenize']['ms']} ms host for {a['tokenize']['texts']} "
              f"texts; {prompt_ids} for {call['texts'][0]!r}) and the "
              "ViT-L/14 text tower | "
              f"losses {a['losses']} | ms/step "
              f"{[round(x, 2) for x in a['ms_per_step']]} | peak "
              f"{a['peak_gib']:.2f} GiB | launches {a['launches']} | first "
              f"view through K1-K4 against plain: {a['kernel_note']}",
              flush=True)
        a["profile"] = profile_step(
            torch, trainer, ROOT / "gsgen_torch" / "_build" /
            "sd15_step_trace.json", vsd=False, phase="16 a")
        del trainer
        torch.cuda.empty_cache()
        k5 = dict(path=k5_row(torch, q, k, v, time_ms),
                  path_launches_per_step=a["launches"]["flash_attn_fwd"]
                  // a["steps"])
        del q, k, v

        # the same directory under fused_attention on: K5 also at levels 1
        # and 2 (5 launches each a step), each level's own q, k, v held
        # against the plain version and timed
        unet_mod.flash_self_attention = keep_qkv
        n_calls = len(calls)
        try:
            trainer, a_on = drive(
                torch, build_trainer, load_config, wrappers, SD15_CONFIGS,
                sd_over + ["guidance.fused_attention=on"], 2,
                dict(flash_attn_fwd=15), prepare=prepare)
        finally:
            unet_mod.flash_self_attention = orig_k5
        del written
        a_on["tokenize"] = tokenized(n_calls, "a on")
        widths = {shp[-1]: shp for shp in (SD15_ATTN,
                                           *SD15_ON_ATTN.values())}
        require(sorted(kept) == sorted(widths),
                f"16 a on: K5 saw head widths {sorted(kept)}")
        print(f"phase 16 a sd15 on: ok | card {card} | {a_on['config']}: "
              f"{a_on['steps']} steps | the same texts through a new "
              f"tokenizer of the directory: tokenize "
              f"{a_on['tokenize']['ms']} ms host | losses "
              f"{a_on['losses']} | ms/step "
              f"{[round(x, 2) for x in a_on['ms_per_step']]} | peak "
              f"{a_on['peak_gib']:.2f} GiB | launches {a_on['launches']}",
              flush=True)
        a_on["profile"] = profile_step(
            torch, trainer, ROOT / "gsgen_torch" / "_build" /
            "sd15_on_step_trace.json", vsd=False, phase="16 a on")
        del trainer, rec
        torch.cuda.empty_cache()
        k5["on_launches_per_step"] = (a_on["launches"]["flash_attn_fwd"]
                                      // a_on["steps"])
        for D, shp in widths.items():
            q, k, v = kept.pop(D)
            require(tuple(q.shape) == shp and q.dtype == torch.bfloat16,
                    f"16 a on: K5 took {tuple(q.shape)} {q.dtype}")
            label = next((lb for lb, s2 in SD15_ON_ATTN.items()
                          if s2 == shp), "on level 0")
            k5[label] = k5_row(torch, q, k, v, time_ms)
            del q, k, v
        res["a"], res["a_on"], res["k5"] = a, a_on, k5
        print(f"phase 16 a k5: ok | card {card} | K5 bf16 at SD 1.5's "
              f"shapes, {k5['path_launches_per_step']} launches a step "
              f"under auto, {k5['on_launches_per_step']} under on | auto, "
              f"the step's own q, k, v {k5_note(k5['path'])} | "
              "fused_attention on, the step's own q, k, v: "
              + " | ".join(f"{lb} {k5_note(k5[lb])}"
                           for lb in ("on level 0", *SD15_ON_ATTN))
              + f" | K5 device ms in the profiled step: auto "
              f"{a['profile']['k5_device_ms']:.3f}, on "
              f"{a_on['profile']['k5_device_ms']:.3f} | the mid block's "
              "[8, 64, 8, 160] is not eligible (L % 128), in either package",
              flush=True)
        torch.cuda.empty_cache()

        # the same directory the way a user starts a scene
        args = ["-m", "gsgen_torch.main", "--steps", "2", "--no-log",
                *[a for n in SD15_CONFIGS for a in ("--config",
                                                    f"configs/{n}")],
                *sd_over]
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, *args], cwd=ROOT,
                              capture_output=True, text=True, timeout=600)
        main_s = time.perf_counter() - t0
        losses = [float(x) for x in re.findall(
            r"^step +\d+ \| loss (\S+)", proc.stdout, re.M)]
        require(proc.returncode == 0 and len(losses) == 2
                and all(math.isfinite(x) for x in losses),
                f"16 a main: exit code {proc.returncode}, losses {losses}: "
                + (proc.stdout + proc.stderr)[-1500:])
        res["a_main"] = dict(s=main_s, losses=losses)
        print(f"phase 16 a main: ok | card {card} | python "
              f"{' '.join(args)}: 2 steps from the prompt's text in "
              f"{main_s:.1f} s (process start, build and weights included) "
              f"| losses {losses}", flush=True)

        # ---- b: T5-XXL as if.yaml's prompt encoder ----
        torch.cuda.reset_peak_memory_stats()
        torch.manual_seed(70)
        t0 = time.perf_counter()
        with torch.device(dev):
            holder = {"t5": t5.T5EncoderModel(t5.T5_XXL)}
        holder["t5"].requires_grad_(False).eval()
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        n_params = sum(p.numel() for p in holder["t5"].parameters())
        enc = {}
        pieces = t5_tokenizer_files(folder / "t5")
        t0 = time.perf_counter()
        t5_tokenize = encoders.tokenizer(str(folder / "t5"), 77)
        t5_load_ms = 1e3 * (time.perf_counter() - t0)
        n_calls = len(calls)

        def t5_encode(texts):
            ids, mask = t5_tokenize(texts)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            out = encoders.encode_ids(holder["t5"], ids, mask)
            enc.update(ms=1e3 * (time.perf_counter() - t1), n=len(texts),
                       peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                       pad_zero=bool(not out[~mask].any()),
                       finite=bool(np.isfinite(out).all()))
            return out

        def t5_prompts(tr):
            tr.prompt_processor = processors.PromptProcessor(
                dataclasses.replace(tr.prompt_processor.cfg,
                                    use_cache=False),
                encode_fn=t5_encode, device=dev)
            holder.clear()
            torch.cuda.empty_cache()

        tr, b = drive(torch, build_trainer, load_config, wrappers,
                      IF_CONFIGS, ["prompt.use_cache=false"], 2, {},
                      prepare=t5_prompts)
        emb = tr.prompt_processor()
        require(tr.guidance.backbone.cfg == IF_PIXEL
                and tuple(emb.text.shape) == (77, 4096),
                f"16 b: if.yaml on {tuple(emb.text.shape)} embeddings")
        require(enc["pad_zero"] and enc["finite"],
                f"16 b: T5 output {enc}")
        # if.yaml's texts through the spiece.model: no <unk>, </s> then
        # <pad>, the pieces joined give the text back
        b["tokenize"] = tokenized(n_calls, "b")
        call = calls[n_calls]
        for text, row, m in zip(call["texts"], call["ids"], call["mask"]):
            n = int(m.sum())
            back = "".join(pieces[i][0] for i in row[:n - 1]).replace(
                "▁", " ").strip()
            require(row[n - 1] == T5_EOS and (row[n:] == T5_PAD).all()
                    and T5_UNK not in row[:n] and back == " ".join(
                        text.split()),
                    f"16 b: {text!r} tokenized as {row[:n].tolist()}")
        t5_prompt_ids = call["ids"][0][:int(call["mask"][0].sum())].tolist()
        b.update(t5_params=n_params, t5_build_s=build_s, encode=enc)
        res["b"] = b
        print(f"phase 16 b t5: ok | card {card} | T5 v1.1 XXL encoder "
              f"({n_params / 1e9:.3f} B parameters, fp32, random on the "
              f"card in {build_s:.1f} s): {enc['n']} prompts tokenized by "
              "the port from a spiece.model of 32,000 pieces + 100 extra "
              f"ids (load {t5_load_ms:.1f} ms, tokenize "
              f"{b['tokenize']['ms']} ms host; {t5_prompt_ids} for "
              f"{call['texts'][0]!r}), 77 ids each encoded in "
              f"{enc['ms']:.1f} ms, peak {enc['peak_gib']:.2f} GiB, zeros "
              "at padded rows | freed, then "
              f"{b['config']}: {b['steps']} steps, batch {b['batch']} | "
              f"losses {b['losses']} | ms/step "
              f"{[round(x, 2) for x in b['ms_per_step']]} | peak "
              f"{b['peak_gib']:.2f} GiB | launches {b['launches']}",
              flush=True)
        del tr, emb
        torch.cuda.empty_cache()

        # ---- c: BERT-base debiasing ----
        bert_dir = folder / "bert"
        c_ = bert.BERT_BASE
        write_safetensors(torch, bert_dir / "model.safetensors",
                          seeded_state(torch, bert.BertForMaskedLM(c_), 71))
        (bert_dir / "config.json").write_text(json.dumps(
            dataclasses.asdict(c_)))
        bert_words = bert_tokenizer_files(bert_dir)
        prompt = load_config(ROOT / "configs" / "corgi.yaml")["prompt"][
            "prompt"]
        words = prompt.split(" ")
        variants = [prompt] + [" ".join(words[:i] + words[i + 1:])
                               for i in range(len(words))]
        t0 = time.perf_counter()
        tokenizer_files.load_tokenizer(str(bert_dir))
        bert_load_ms = 1e3 * (time.perf_counter() - t0)
        n_calls = len(calls)
        t0 = time.perf_counter()
        fill_mask = debias.bert_fill_mask(str(bert_dir), device=dev)
        build_ms = 1e3 * (time.perf_counter() - t0)
        probe_ms = events_ms(torch, lambda: fill_mask(variants), 5)
        c_tok = tokenized(n_calls, "c")
        # the probe's texts: [CLS] ... [SEP], [MASK] once and kept whole,
        # no [UNK], the words back from the pieces
        call = calls[n_calls]
        for text, row, m in zip(call["texts"], call["ids"], call["mask"]):
            n = int(m.sum())
            toks = [bert_words[i] for i in row[1:n - 1]]
            back = " ".join(toks).replace(" ##", "")
            want = " ".join(re.findall(r"\[MASK\]|[a-z0-9]+|[^\sa-z0-9]",
                                       text.replace("[MASK]", "\0").lower()
                                       )).replace("\0", "[MASK]")
            require(row[0] == BERT_CLS and row[n - 1] == BERT_SEP
                    and list(row).count(BERT_MASK) == 1
                    and BERT_UNK not in row and (back == want if n < 16
                                                 else want.startswith(back)),
                    f"16 c: {text!r} tokenized as {row[:n].tolist()}")
        views = debias.get_debiased_prompt(prompt, str(bert_dir), device=dev)
        pp = processors.PromptProcessor(processors.PromptProcessorConfig(
            prompt=prompt, use_prompt_debiasing=True, use_cache=False,
            debiasing_model_id=str(bert_dir)), device=dev)
        require(bool(torch.isfinite(pp().text_vd).all()) and len(views) == 4,
                f"16 c: debiased prompts {views}")
        probs = fill_mask(variants)
        require(np.allclose(probs.sum(-1), 1.0, atol=1e-5),
                f"16 c: view probabilities {probs}")
        res["c"] = dict(prompt=prompt, views=views, probe_ms=probe_ms,
                        variants=len(variants), tokenize=c_tok,
                        build_ms=build_ms, tokenizer_load_ms=bert_load_ms)
        print(f"phase 16 c debias: ok | card {card} | BERT-base MLM "
              "(random, from a written safetensors directory) and the "
              "port's WordPiece tokenizer of its vocab.txt (30,522 entries; "
              f"load {bert_load_ms:.1f} ms) built in {build_ms:.1f} ms, as "
              "the fill-mask probe of "
              f"{len(variants)} variants of {prompt!r}: {probe_ms:.2f} ms a "
              f"probe (tokenizing included), tokenize {c_tok['ms'][0]} ms "
              f"host for {len(call['texts'])} texts | per-view prompts "
              "(side, front, back, overhead) through "
              f"get_debiased_prompt(model_dir=...): {views}", flush=True)
        del fill_mask, pp
        torch.cuda.empty_cache()

        # ---- d: the asset inits ----
        d = {}
        build_s = {}

        def timed_build(label):
            def build(cfg, device):
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                tr = build_trainer(cfg, device=device)
                torch.cuda.synchronize()
                build_s[label] = time.perf_counter() - t1
                return tr
            return build

        rng = np.random.default_rng(72)
        xyz = rng.standard_normal((4096, 3))
        xyz = (0.5 * xyz / np.linalg.norm(xyz, axis=1, keepdims=True)
               ).astype(np.float32)
        rec_dt = np.dtype([("x", "<f4"), ("y", "<f4"), ("z", "<f4"),
                           ("red", "u1"), ("green", "u1"), ("blue", "u1")])
        cloud = np.zeros(4096, rec_dt)
        for i, n in enumerate("xyz"):
            cloud[n] = xyz[:, i]
        for n in ("red", "green", "blue"):
            cloud[n] = rng.integers(0, 256, 4096)
        ply = folder / "cloud.ply"
        ply.write_bytes(
            b"ply\nformat binary_little_endian 1.0\nelement vertex 4096\n"
            + b"".join(f"property float {n}\n".encode() for n in "xyz")
            + b"".join(f"property uchar {n}\n".encode()
                       for n in ("red", "green", "blue"))
            + b"end_header\n" + cloud.tobytes())
        n_ico = icosphere_obj(folder / "ico.obj")

        # Shap-E: text300M at full width on (a)'s projected text vector
        t300 = PointEConfig(input_channels=1024, output_channels=2048,
                            n_ctx=1024, width=1024, layers=24, heads=16,
                            clip_feature_dim=768)
        state = PointEModel(t300, device="cpu", seed=73).module.state_dict()
        g = torch.Generator().manual_seed(74)
        for key in ("output_proj.weight", "output_proj.bias"):
            state[key] = 0.02 * torch.randn(state[key].shape, generator=g)
        write_safetensors(torch, folder / "text300m.safetensors", state)
        del state
        vec_tower = encoders.load_clip_textvec_dir(
            str(sd_dir / "clip_textvec"), device=dev)
        textvec = torch.as_tensor(encoders.encode_ids(
            vec_tower, clip_tok([SHAP_E_PROMPT], 77)[0])[0], device=dev)
        del vec_tower
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        latent = sample_shap_e_latent(
            str(folder / "text300m.safetensors"), textvec,
            torch.Generator(device=dev).manual_seed(75), karras_steps=64,
            guidance_scale=15.0, device=dev)
        torch.cuda.synchronize()
        sample_s = time.perf_counter() - t0
        require(tuple(latent.shape) == (1024 * 1024,)
                and bool(torch.isfinite(latent).all()),
                f"16 d: text300M latent {tuple(latent.shape)}")
        np.save(folder / "latent.npy", latent.cpu().numpy())
        dec_state = shap_e_decoder_state(torch, 76)
        dec = ShapEDecoder.from_state_dict(dec_state, device=dev)
        require(dec.latent_ctx == 1024 and dec.d_latent == 1024,
                f"16 d: decoder latent {dec.latent_ctx} x {dec.d_latent}")
        field = dec.sdf_grid(dec.mlp_params(latent), 128)
        shift = 0.0
        if not (field.max() > 0.0 > field.min()):
            # a random decoder whose level set misses the grid: move the
            # SDF head's bias by the median pre-activation
            pre = np.arctanh(np.clip(field, -1 + 1e-6, 1 - 1e-6))
            shift = -float(np.median(pre))
            dec_state["renderer.nerstf.mlp.4.bias"][0] += shift
        del dec, field
        write_safetensors(torch, folder / "decoder.safetensors", dec_state)
        del dec_state
        torch.cuda.empty_cache()

        for label, over, note in (
                ("point_cloud", ["init.type=point_cloud",
                                 f"init_asset={ply}"], "4096 points"),
                ("mesh", ["init.type=mesh", f"init.mesh={folder / 'ico.obj'}"],
                 f"icosphere of {n_ico} vertices"),
                ("shap_e", ["init.type=shap_e",
                            f"init.shap_e_latent={folder / 'latent.npy'}",
                            f"init.shap_e_decoder="
                            f"{folder / 'decoder.safetensors'}",
                            "init.grid_size=128",
                            f"prompt.prompt={SHAP_E_PROMPT}"], "")):
            tr, r = drive(torch, timed_build(label), load_config, wrappers,
                          "base.yaml", ["guidance.type=mock", *over], 2, {})
            sc = tr.state.scene
            n_live = int(sc.active.sum())
            require(sc.params["mean"].shape[0] == 65536 and n_live > 0,
                    f"16 d {label}: capacity {sc.params['mean'].shape[0]}, "
                    f"live {n_live}")
            r.update(init_s=build_s[label], live=n_live)
            if label == "shap_e":
                z = np.load(priors._asset_path(SHAP_E_PROMPT, "shap_e"))
                r.update(vertices=int(z["xyz"].shape[0]),
                         text300m_sample_s=sample_s, sdf_bias_shift=shift)
                note = (f"text300M (width 1024, 24 layers, 16 heads, n_ctx "
                        f"1024) 64 Karras steps at CFG 15 in {sample_s:.2f} "
                        f"s on the projected text vector of (a)'s tower, "
                        f"decoded at grid 128: {r['vertices']} vertices"
                        + (f" (SDF head bias moved by {shift:+.4f} so that "
                           "the random decoder's level set crosses the grid)"
                           if shift else ""))
            d[label] = r
            print(f"phase 16 d {label}: ok | card {card} | init "
                  f"{build_s[label]:.3f} s, {note}, {n_live} live | "
                  f"{r['steps']} mock steps at capacity 65,536: losses "
                  f"{r['losses']} | ms/step "
                  f"{[round(x, 2) for x in r['ms_per_step']]} | peak "
                  f"{r['peak_gib']:.2f} GiB", flush=True)
            del tr, sc
            torch.cuda.empty_cache()
        res["d"] = d
        loaded = [m for m in ("transformers", "tokenizers")
                  if m in sys.modules]
        require(not loaded, f"phase 16: {loaded} imported")
    finally:
        restore_tok()
        if old_assets is None:
            os.environ.pop("GSGEN_ASSET_DIR", None)
        else:
            os.environ["GSGEN_ASSET_DIR"] = old_assets
        shutil.rmtree(folder, ignore_errors=True)
    return res


# phase 17: the tools around a trained scene
DEMO_STEPS = 400
DEMO_GATE_DB = 29.0      # the JAX package's chip bar (test_quality_gate.py)
TOOLS_PROMPT = "a corgi"    # base.yaml's prompt: the checkpoint's run name
SWEEP_SPEC = {"init.num_points": [128, 256]}


def lpips_files(torch, folder, seed):
    """Random-weight LPIPS files: a torchvision-AlexNet-shaped state dict
    and an lpips ``alex.pth``.  Returns their paths."""
    from gsgen_torch.utils.metrics import _ALEX, _ALEX_FEATURES
    g = torch.Generator().manual_seed(seed)
    alex, lin, in_ch = {}, {}, 3
    for i, (fidx, (out_ch, k, _, _, _)) in enumerate(zip(_ALEX_FEATURES,
                                                         _ALEX)):
        fan = in_ch * k * k
        alex[f"features.{fidx}.weight"] = torch.randn(
            out_ch, in_ch, k, k, generator=g) * math.sqrt(2.0 / fan)
        alex[f"features.{fidx}.bias"] = torch.randn(out_ch, generator=g) * 0.01
        lin[f"lin{i}.model.1.weight"] = torch.rand(1, out_ch, 1, 1,
                                                   generator=g) * 0.1
        in_ch = out_ch
    paths = folder / "alexnet.pth", folder / "alex.pth"
    torch.save(alex, paths[0])
    torch.save(lin, paths[1])
    return [str(p) for p in paths]


def tools_phases(torch, dev, build_trainer, load_config, wrappers, card,
                 check_view):
    """Phase 17: the tools around a trained scene, each at its own full
    size (module docstring, item 17)."""
    import concurrent.futures
    import os
    import shutil
    import tempfile
    import threading
    import types
    import urllib.request

    import numpy as np

    import gsgen_torch.io.viewer as viewer_mod
    import gsgen_torch.tools.relight as relight_mod
    import gsgen_torch.tools.snapshot as snapshot_mod
    from gsgen_torch import main as main_mod
    from gsgen_torch.io.logging import read_png
    from gsgen_torch.models.scene import scene_normals
    from gsgen_torch.ops.camera import CameraIntrinsics
    from gsgen_torch.tools import demo_recon, rehearsal, undistort
    from gsgen_torch.training import adan
    from gsgen_torch.utils import metrics, sweep

    res = {}
    folder = Path(tempfile.mkdtemp(prefix="gsgen_tools_"))
    procs = []

    def zero():
        torch.cuda.synchronize()
        for w in wrappers.values():
            w.launches = 0

    def counts():
        torch.cuda.synchronize()
        return {k: w.launches for k, w in wrappers.items() if w.launches}

    def render_launches(n_fwd, n_bwd=0, k5=0):
        """K1, K3, K4 once a render, K2 once a backward, K5 as given."""
        want = dict(raster_fwd=n_fwd, expansion_rank=n_fwd, gid_repack=n_fwd,
                    raster_bwd=n_bwd, flash_attn_fwd=k5)
        return {k: v for k, v in want.items() if v}

    def shim(intr, rcfg):
        """What check_view reads of a trainer, for a render outside one."""
        return types.SimpleNamespace(
            data=types.SimpleNamespace(intrinsics=lambda: intr), rcfg=rcfg)

    n_dups = []

    def dup_checked(mod):
        """Wrap ``mod.render_view``: every render's n_dup <= dup_cap."""
        orig = mod.render_view

        def call(params, active, c2w, intr, cfg, *a, **kw):
            out = orig(params, active, c2w, intr, cfg, *a, **kw)
            n = int(out["n_dup"])
            n_dups.append(n)
            require(n <= cfg.dup_cap, f"phase 17: a {intr.w}^2 render needs "
                    f"{n} duplicates, over dup_cap {cfg.dup_cap}")
            return out
        mod.render_view = call
        return lambda: setattr(mod, "render_view", orig)

    def spawn(label, args, env=None):
        log = open(folder / f"{label}.log", "w")
        p = subprocess.Popen([sys.executable, *args], cwd=ROOT, stdout=log,
                             stderr=subprocess.STDOUT,
                             env={**os.environ, **(env or {})})
        procs.append((label, p, log, time.perf_counter()))

    def reap():
        out = {}
        for label, p, log, t0 in procs:
            rc = p.wait(timeout=600)
            out[label] = dict(rc=rc, s=time.perf_counter() - t0)
            log.close()
            text = (folder / f"{label}.log").read_text()
            require(rc == 0, f"phase 17 {label}: exit code {rc}: "
                    + text[-1500:])
            out[label]["log"] = text
        procs.clear()
        return out

    try:
        # ---- a: demo_recon, the full recipe, against the 29 dB gate ----
        held = {}
        demo_trainer = demo_recon.Trainer

        class Recorded(demo_trainer):
            """The demo's Trainer, recording step 0's first view."""

            def train_step(self, step):
                if step:
                    return super().train_step(step)
                rec, restore = record_render_inputs(torch)
                try:
                    return super().train_step(step)
                finally:
                    restore()
                    held.update(rec=rec, trainer=self)

        demo_recon.Trainer = Recorded
        try:
            zero()
            t0 = time.perf_counter()
            psnr = demo_recon.main(str(folder / "demo_recon.png"),
                                   steps=DEMO_STEPS, device="cuda")
            torch.cuda.synchronize()
            demo_s = time.perf_counter() - t0
        finally:
            demo_recon.Trainer = demo_trainer
        launches = counts()
        renders = 3 * 6 + 2 * 4 * DEMO_STEPS   # strips; views + targets
        want = render_launches(renders, 4 * DEMO_STEPS)
        require(launches == want, f"17 a: launches {launches}, expected "
                f"{want}")
        tr = held["trainer"]
        live = int(tr.state.scene.active.sum())
        note = check_view("17 a demo step 0 view 0", held["rec"], tr)
        require(math.isfinite(psnr) and psnr >= DEMO_GATE_DB,
                f"17 a: orbit PSNR {psnr:.2f} dB < {DEMO_GATE_DB} dB")
        strip = read_png(folder / "demo_recon.png")
        require(strip.shape == (3 * 96, 6 * 96, 3),
                f"17 a: strip {strip.shape}")
        res["a"] = dict(psnr_db=psnr, s=demo_s, steps=DEMO_STEPS,
                        ms_per_step=1e3 * demo_s / DEMO_STEPS, live=live,
                        launches=launches, kernel_note=note)
        print(f"phase 17 a demo_recon: ok | card {card} | {DEMO_STEPS} "
              f"steps at 64^2, batch 4, capacity 16,384, densify and prune "
              f"at 100/200/300: orbit PSNR {psnr:.2f} dB (gate "
              f"{DEMO_GATE_DB}) in {demo_s:.2f} s "
              f"({res['a']['ms_per_step']:.2f} ms/step, strips included), "
              f"{live} live | launches {launches} | first view through "
              f"K1-K4 against plain: {note}", flush=True)
        del held, tr
        torch.cuda.empty_cache()

        # ---- b: a base.yaml checkpoint through gsgen_torch.main ----
        t0 = time.perf_counter()
        rc = main_mod.main(["--config", str(ROOT / "configs" / "base.yaml"),
                            "--steps", "3", "--log-root", str(folder / "runs"),
                            "guidance.type=mock"])
        ckpt_s = time.perf_counter() - t0
        require(rc == 0, f"17 b: gsgen_torch.main returned {rc}")
        ckpts = sorted(folder.glob("runs/*/*/*/ckpts/step_3"))
        require(len(ckpts) == 1, f"17 b: checkpoints {ckpts}")
        ckpt = str(ckpts[0])

        # the CLIs as subprocesses, side by side: stills, the spiral, a
        # Point-E asset, a sweep (they overlap the CPU work below)
        tool = ["-m", "gsgen_torch.tools.snapshot"]
        spawn("photos", [*tool, "photos", ckpt, "--reso", "1024", "--out",
                         str(folder / "stills")])
        spawn("spiral", [*tool, "spiral", ckpt, "--frames", "90", "--reso",
                         "512", "--out", str(folder / "spiral.mp4")])
        pe = point_e_checkpoints(torch, folder)
        assets = folder / "assets"
        spawn("make_init_asset", [
            "-m", "gsgen_torch.tools.make_init_asset", "point_e",
            POINT_E_PROMPT, "--base", str(pe["base40M-textvec"]),
            "--upsample", str(pe["upsample"])],
            env={"GSGEN_ASSET_DIR": str(assets)})
        cfg_paths = sweep.generate_sweep_configs(
            str(ROOT / "configs" / "smoke.yaml"), SWEEP_SPEC,
            out_dir=str(folder / "sweep"))
        sweep_out = {}

        def run_sweep():
            t = time.perf_counter()
            sweep_out["results"] = sweep.run_sweep_scheduled(
                cfg_paths, slots=[{"CUDA_VISIBLE_DEVICES": "0",
                                   "PYTHONPATH": str(ROOT)}],
                steps=2, log_root=str(folder / "sweep_runs"), poll_s=0.25)
            sweep_out["s"] = time.perf_counter() - t

        sweep_thread = threading.Thread(target=run_sweep)
        sweep_thread.start()

        # CPU references while the subprocesses run: f, g, h
        gen = torch.Generator().manual_seed(17)
        lp = lpips_files(torch, folder, 17)
        pred = torch.rand(512, 512, 3, generator=gen)
        target = torch.clamp(pred + 0.1 * torch.randn(512, 512, 3,
                                                      generator=gen), 0, 1)
        m_cpu = metrics.Metrics(lpips_weights_path=":".join(lp))(pred, target)
        uv = (torch.rand(1 << 20, 2, generator=gen) - 0.5) * 1.2
        rt = torch.tensor([0.1, -0.05, 0.01, -0.02, 0.01, 0.02, -0.01,
                           0.005])
        fish = torch.tensor([0.05, -0.01, 0.004, -0.001])
        und_fns = dict(
            rt=(undistort.opencv_lens_distortion,
                undistort.opencv_lens_undistortion, rt),
            fisheye=(undistort.opencv_lens_distortion_fisheye,
                     undistort.opencv_lens_undistortion_fisheye, fish))
        und_cpu = {}
        for k, (dist, inv, p) in und_fns.items():
            d = dist(uv, p)
            und_cpu[k] = (d, inv(d, p))

        trainer = build_trainer(load_config(ROOT / "configs" / "base.yaml",
                                            ["guidance.type=mock"]),
                                device="cuda")
        step = trainer.load(ckpt)
        require(step == 3, f"17 b: the checkpoint is step {step}")
        scene, rcfg = trainer.state.scene, trainer.rcfg
        cap = scene.params["mean"].shape[0]
        require(cap == 65536, f"17 b: capacity {cap}")
        fields = {k: v.detach().cpu() for k, v in scene.params.items()}
        grads = {k: torch.randn(v.shape, generator=gen)
                 for k, v in fields.items()}
        adan_cpu = adan.adan_update(grads, adan.adan_init(fields), fields,
                                    1e-3, weight_decay=0.01)
        runs = reap()
        sweep_thread.join(timeout=600)
        require(not sweep_thread.is_alive(), "17 i: the sweep did not end")

        # the CLIs' outputs
        stills = sorted(p.name for p in (folder / "stills").iterdir())
        require(stills == sorted(f"{n}_{k}.png" for n in
                                 ("front", "left", "right")
                                 for k in ("rgb", "depth")),
                f"17 b: stills {stills}")
        front_cli = read_png(folder / "stills" / "front_rgb.png")
        require(front_cli.shape == (1024, 1024, 4),
                f"17 b: front still {front_cli.shape}")
        spiral = folder / "spiral"
        frames = sorted(spiral.iterdir()) if spiral.is_dir() else []
        if frames:       # no imageio: PNG frames
            require(len(frames) == 90 and read_png(frames[0]).shape ==
                    (512, 1024, 3), f"17 b: spiral {len(frames)} frames")
        else:
            require((folder / "spiral.mp4").exists()
                    or (folder / "spiral.gif").exists(),
                    "17 b: no spiral written")

        # in process: launches, n_dup, K1 against plain, times
        restores = [dup_checked(m) for m in (snapshot_mod, relight_mod,
                                             viewer_mod)]
        try:
            zero()
            rec, restore = record_render_inputs(torch)
            try:
                t0 = time.perf_counter()
                shots = snapshot_mod.take_photos(scene, rcfg, reso=1024)
                torch.cuda.synchronize()
                photos_s = time.perf_counter() - t0
            finally:
                restore()
            t0 = time.perf_counter()
            frames = snapshot_mod.take_spiral(scene, rcfg, n_frames=90,
                                              reso=512)
            spiral_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            relit = relight_mod.relight_frames(scene, rcfg, n_frames=30,
                                               reso=512)
            relight_s = time.perf_counter() - t0
            launches = counts()
            want = render_launches(3 + 90 + 30)
            require(launches == want, f"17 b: launches {launches}, expected "
                    f"{want}")
            normals_ms = events_ms(torch, lambda: scene_normals(
                scene.params, scene.active, rcfg), iters=3)
            note = check_view("17 b front still 1024^2", rec,
                              shim(CameraIntrinsics.from_reso(1024), rcfg))
            front = np.clip(shots["front"]["rgb"], 0, 1)
            diff = int(np.abs((front * 255).astype(np.uint8).astype(int)
                              - front_cli).max())
            require(diff <= 1, f"17 b: the CLI's front still differs by "
                    f"{diff} of 255 from the in-process one")
            require(frames.shape == (90, 512, 1024, 3) and relit.shape ==
                    (30, 512, 512, 3) and np.isfinite(relit).all(),
                    f"17 b: spiral {frames.shape}, relit {relit.shape}")
            require(float(np.abs(relit[0] - relit[7]).max()) > 1e-3,
                    "17 b: the relit frames do not change with the light")
            b_dups = list(n_dups)
            res["b"] = dict(
                ckpt_s=ckpt_s, photos_s=photos_s,
                s_per_still=photos_s / 3, spiral_s=spiral_s,
                spiral_fps=90 / spiral_s, relight_s=relight_s,
                relight_fps=30 / relight_s, normals_ms=normals_ms,
                n_dup_max=max(b_dups), dup_cap=rcfg.dup_cap,
                launches=launches, kernel_note=note, cli_s={
                    k: round(v["s"], 2) for k, v in runs.items()})
            print(f"phase 17 b snapshot relight: ok | card {card} | base.yaml "
                  f"checkpoint (capacity 65,536, mock, 3 steps) through "
                  f"gsgen_torch.main in {ckpt_s:.2f} s | CLIs photos 1024^2 / "
                  f"spiral 90 frames 512^2 rc 0 in {runs['photos']['s']:.1f} "
                  f"/ {runs['spiral']['s']:.1f} s (side by side, process "
                  f"start included); the CLI's front still within "
                  f"{diff}/255 of the in-process one | in process: "
                  f"{res['b']['s_per_still']:.3f} s a 1024^2 still, spiral "
                  f"{res['b']['spiral_fps']:.1f} frames/s, relight 30 frames "
                  f"{res['b']['relight_fps']:.1f} frames/s, normals "
                  f"{normals_ms:.1f} ms once a call | n_dup max "
                  f"{max(b_dups)} of dup_cap {rcfg.dup_cap} | launches "
                  f"{launches} | first still through K1-K4 against plain: "
                  f"{note}", flush=True)

            # ---- c: the viewer ----
            n_dups.clear()
            viewer = viewer_mod.SceneViewer(scene, rcfg, port=0)
            viewer.update_state(scene, step=step)
            viewer.serve(blocking=False)
            base = f"http://localhost:{viewer.port}"
            # straight to the local server, whatever proxy the environment
            # names
            opener = urllib.request.build_opener(
                urllib.request.ProxyHandler({}))

            def get(path):
                t = time.perf_counter()
                with opener.open(base + path, timeout=120) as r:
                    body, ctype = r.read(), r.headers["Content-Type"]
                return body, ctype, 1e3 * (time.perf_counter() - t)

            def decode(body, ctype, reso):
                if ctype == "image/png":
                    p = folder / "view.png"
                    p.write_bytes(body)
                    img = read_png(p)
                else:
                    require(ctype == "image/jpeg" and body[:2] == b"\xff\xd8",
                            f"17 c: {ctype}")
                    import io

                    from PIL import Image
                    img = np.array(Image.open(io.BytesIO(body)))
                require(img.shape == (reso, reso, 3) and img.max() > 0,
                        f"17 c: image {img.shape}")

            try:
                zero()
                page, _, page_ms = get("/")
                require(b"gsgen-torch viewer" in page, "17 c: the page")
                req_ms = {}
                for reso in (256, 512, 1024):
                    body, ctype, ms = get(f"/render?azimuth=30&elevation=20"
                                          f"&distance=2.5&reso={reso}")
                    decode(body, ctype, reso)
                    req_ms[reso] = ms
                t0 = time.perf_counter()
                with concurrent.futures.ThreadPoolExecutor(4) as ex:
                    outs = list(ex.map(lambda az: get(
                        f"/render?azimuth={az}&elevation=10&distance=2.5"
                        "&reso=512"), (0, 45, 90, 135)))
                conc_s = time.perf_counter() - t0
                for body, ctype, _ in outs:
                    decode(body, ctype, 512)
                stats = json.loads(get("/stats")[0])
                require(stats == {"num_gaussians": int(scene.active.sum()),
                                  "step": 3}, f"17 c: stats {stats}")
                launches = counts()
                want = render_launches(7)
                require(launches == want, f"17 c: launches {launches}, "
                        f"expected {want}")
            finally:
                viewer.httpd.shutdown()
                viewer.httpd.server_close()
            res["c"] = dict(content_type=ctype, page_ms=page_ms,
                            render_ms=req_ms,
                            concurrent_ms=[o[2] for o in outs],
                            concurrent_wall_s=conc_s,
                            n_dup_max=max(n_dups), launches=launches)
            print(f"phase 17 c viewer: ok | card {card} | port "
                  f"{viewer.port}, {ctype} | / {page_ms:.1f} ms | /render "
                  + ", ".join(f"{r}^2 {ms:.1f} ms" for r, ms in req_ms.items())
                  + f" | 4 concurrent at 512^2: "
                  f"{[round(o[2], 1) for o in outs]} ms, {conc_s:.3f} s "
                  f"wall | /stats {stats} | n_dup max {max(n_dups)} | "
                  f"launches {launches}", flush=True)
        finally:
            for r in restores:
                r()

        # ---- f, g, h: card against the CPU ----
        m_card = metrics.Metrics(lpips_weights_path=":".join(lp))(
            pred.to(dev), target.to(dev))
        m_err = {k: abs(float(m_card[k]) - float(m_cpu[k])) for k in m_cpu}
        require(m_err["psnr"] <= 1e-4 and m_err["ssim"] <= 1e-5 and
                m_err["lpips"] <= 1e-4 * abs(float(m_cpu["lpips"])),
                f"17 f: card vs CPU {m_err}")
        params = metrics.load_lpips_params(*lp)
        lpips_ms = events_ms(torch, lambda: metrics.lpips(
            pred.to(dev), target.to(dev), params))
        res["f"] = dict(cpu={k: float(v) for k, v in m_cpu.items()},
                        err=m_err, lpips_ms=lpips_ms)
        print(f"phase 17 f metrics: ok | card {card} | 512^2, random "
              f"LPIPS .pth files: psnr {float(m_cpu['psnr']):.4f}, ssim "
              f"{float(m_cpu['ssim']):.6f}, lpips "
              f"{float(m_cpu['lpips']):.6f} on the CPU; card errors "
              f"{ {k: f'{v:.2e}' for k, v in m_err.items()} } (limits 1e-4 "
              f"dB, 1e-5, rel 1e-4) | LPIPS {lpips_ms:.3f} ms on the card",
              flush=True)

        und = {}
        uv_d = uv.to(dev)
        for k, (dist, inv, p) in und_fns.items():
            d_cpu, u_cpu = und_cpu[k]
            d = dist(uv_d, p.to(dev))
            u = inv(d, p.to(dev))
            e_d = float((d.cpu() - d_cpu).abs().max())
            e_u = float((u.cpu() - u_cpu).abs().max())
            r_t = float((u.cpu() - uv).abs().max())
            require(e_d <= 1e-6 and e_u <= 1e-5 and r_t <= 1e-4,
                    f"17 g {k}: card vs CPU {e_d:.2e} / {e_u:.2e}, round "
                    f"trip {r_t:.2e}")
            ms = events_ms(torch, lambda: inv(dist(uv_d, p.to(dev)),
                                              p.to(dev)))
            und[k] = dict(err_distort=e_d, err_undistort=e_u,
                          round_trip=r_t, ms=ms)
        res["g"] = und
        print(f"phase 17 g undistort: ok | card {card} | 2^20 points: "
              + " | ".join(f"{k}: card vs CPU {v['err_distort']:.1e} / "
                           f"{v['err_undistort']:.1e}, round trip "
                           f"{v['round_trip']:.1e}, distort + 10 Newton "
                           f"steps {v['ms']:.3f} ms" for k, v in und.items()),
              flush=True)

        fields_d = {k: v.to(dev) for k, v in fields.items()}
        grads_d = {k: v.to(dev) for k, v in grads.items()}
        new_d, st_d = adan.adan_update(grads_d, adan.adan_init(fields_d),
                                       fields_d, 1e-3, weight_decay=0.01)
        a_err = max(float(((new_d[k].cpu() - adan_cpu[0][k]).abs()
                           / (1.0 + adan_cpu[0][k].abs())).max())
                    for k in fields)
        require(a_err <= 1e-6, f"17 h: Adan card vs CPU {a_err:.2e} "
                "(relative to 1 + |p|)")
        st0 = adan.adan_init(fields_d)
        adan_ms = events_ms(torch, lambda: adan.adan_update(
            grads_d, st0, fields_d, 1e-3, weight_decay=0.01))
        res["h"] = dict(err=a_err, ms=adan_ms, fields=sorted(fields))
        print(f"phase 17 h adan: ok | card {card} | one step over "
              f"{sorted(fields)} at capacity 65,536: card vs CPU "
              f"{a_err:.1e} | {adan_ms:.3f} ms", flush=True)
        del trainer, scene, fields_d, grads_d, new_d, st_d, st0
        torch.cuda.empty_cache()

        # ---- e: make_init_asset, then init.type=point_e from the asset --
        import hashlib
        name = ("point_e_" + hashlib.md5(POINT_E_PROMPT.encode()).hexdigest()
                [:16] + ".npz")
        require(sorted(p.name for p in assets.iterdir()) == [name],
                f"17 e: assets {sorted(assets.iterdir())}")
        require(f"wrote {assets / name}" in runs["make_init_asset"]["log"],
                "17 e: the CLI named another file")
        old_assets = os.environ.get("GSGEN_ASSET_DIR")
        os.environ["GSGEN_ASSET_DIR"] = str(assets)
        try:
            t0 = time.perf_counter()
            tr = build_trainer(load_config(
                ROOT / "configs" / "base.yaml",
                ["guidance.type=mock", "init.type=point_e",
                 f"prompt.prompt={POINT_E_PROMPT}"]), device="cuda")
            init_s = time.perf_counter() - t0
        finally:
            if old_assets is None:
                os.environ.pop("GSGEN_ASSET_DIR", None)
            else:
                os.environ["GSGEN_ASSET_DIR"] = old_assets
        live = int(tr.state.scene.active.sum())
        require(live > 0, "17 e: the point_e init has no live Gaussian")
        res["e"] = dict(cli_s=runs["make_init_asset"]["s"], file=name,
                        init_s=init_s, live=live)
        print(f"phase 17 e make_init_asset: ok | card {card} | point_e on "
              f"seeded random base40M-textvec + upsample .pt (64 + 64 "
              f"Karras steps) in {runs['make_init_asset']['s']:.1f} s "
              f"(process start included) -> {name}; init.type=point_e "
              f"from it with no checkpoint in {init_s:.2f} s, {live} live",
              flush=True)
        del tr
        torch.cuda.empty_cache()

        # ---- i: the sweep ----
        got = sweep_out["results"]
        require(sorted(r["config"] for r in got) == sorted(cfg_paths)
                and all(r["returncode"] == 0 for r in got),
                f"17 i: sweep results {got}")
        runs_i = sorted((folder / "sweep_runs").glob("*/*/*/scalars.jsonl"))
        require(len(runs_i) == 2 and all(math.isfinite(json.loads(
            p.read_text().splitlines()[0])["loss_total"]) for p in runs_i),
            f"17 i: sweep run logs {runs_i}")
        res["i"] = dict(s=sweep_out["s"], returncodes=[r["returncode"]
                                                       for r in got])
        print(f"phase 17 i sweep: ok | card {card} | 2 configs of "
              f"configs/smoke.yaml ({SWEEP_SPEC}), 2 steps each, one slot "
              f"(CUDA_VISIBLE_DEVICES=0): return codes "
              f"{res['i']['returncodes']} in {sweep_out['s']:.1f} s "
              f"(side by side with b's CLIs)", flush=True)

        # ---- d: the rehearsal on a random SD 2.1 directory ----
        t0 = time.perf_counter()
        _, vocab = sd_directory(torch, folder / "sd21", dev, preset="sd21")
        write_s = time.perf_counter() - t0
        cfg = rehearsal.build_rehearsal_config(
            "a corgi", 10, sd_path=folder / "sd21", clip_path=folder / "sd21",
            reso=512)
        cfg["prompt"]["use_cache"] = False
        out = folder / "rehearsal"
        calls, restore_tok = timed_tokenizer()
        zero()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        try:
            losses = rehearsal.run(cfg, out, eval_every=5,
                                   log=lambda *a: None, device="cuda")
        finally:
            restore_tok()
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        # --clip: the prompt through the port's tokenizer of the SD 2.1
        # directory, padded with "!" (id 0) after <|endoftext|>
        require(len(calls) == 1, f"17 d: {len(calls)} tokenizer calls")
        for text, row, m in zip(calls[0]["texts"], calls[0]["ids"],
                                calls[0]["mask"]):
            n = int(m.sum())
            require(row[0] == CLIP_BOS and row[n - 1] == CLIP_EOS
                    and (row[n:] == vocab["!"]).all() and vocab["!"] == 0
                    and clip_decode(vocab, row) == " ".join(re.findall(
                        r"[a-z]+|[0-9]|[^\sa-z0-9]+", text.lower())),
                    f"17 d: {text!r} tokenized as {row.tolist()}")
        launches = counts()
        want = render_launches(4 * 10 + 2, 4 * 10, k5=5 * 10)
        require(launches == want, f"17 d: launches {launches}, expected "
                f"{want}")
        lines = [json.loads(x) for x in
                 (out / "scalars.jsonl").read_text().splitlines()]
        require(len(lines) == 10 and all(
            math.isfinite(x["loss"]) and math.isfinite(x["grad_norm"])
            and x["grad_norm"] > 0 for x in lines),
            f"17 d: scalars {lines}")
        evals = sorted(p.name for p in out.glob("eval_*.png"))
        require(evals == ["eval_00005.png", "eval_00010.png"],
                f"17 d: eval images {evals}")
        res["d"] = dict(write_s=write_s, run_s=run_s, losses=losses,
                        tokenize_ms=calls[0]["ms"],
                        grad_norms=[x["grad_norm"] for x in lines],
                        peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                        launches=launches)
        print(f"phase 17 d rehearsal: ok | card {card} | a random SD 2.1 "
              "diffusers directory (text_encoder/ the OpenCLIP ViT-H/14 "
              "text tower, tokenizer/ at CLIP's size padding with \"!\") "
              f"written in {write_s:.1f} s; --sd and --clip on it (tokenize "
              f"{calls[0]['ms']:.3f} ms host for "
              f"{len(calls[0]['texts'])} texts), "
              f"512^2, batch 4, bf16, 10 steps, eval every 5 in "
              f"{run_s:.2f} s (build and weights included) | losses "
              f"{[round(x, 5) for x in losses]} | grad norms "
              f"{[round(x['grad_norm'], 4) for x in lines]} | peak "
              f"{res['d']['peak_gib']:.2f} GiB | launches {launches} (K5 "
              f"5 a step)", flush=True)
    finally:
        for _, p, log, _ in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
        shutil.rmtree(folder, ignore_errors=True)
    return res



def sharded_vs_one(torch, scene, c2w, intr, rcfg, tmesh, gmesh, wrappers):
    """One view rendered tile-sharded over ``tmesh`` and Gaussian-sharded
    over ``gmesh`` (the scene interleaved, then this rank's shard), each
    with the gradients of mean(rgb^2) + mean(T), against the unsharded
    render on this process: image errors, gradient errors over each
    field's largest gradient, the kernels' launches of each sharded
    render (forward and backward) and its duplicates."""
    from gsgen_torch.models.scene import render_view
    from gsgen_torch.parallel import gaussian_sharded as gs
    from gsgen_torch.parallel import mesh as pm
    from gsgen_torch.parallel import sharded_render as sr

    bg = torch.ones(3, device=c2w.device)

    def run(render, params):
        p = {k: v.detach().clone().requires_grad_(True)
             for k, v in params.items()}
        out = render(p)
        loss = torch.mean(out["rgb"] ** 2) + torch.mean(out["T"])
        g = torch.autograd.grad(loss, list(p.values()))
        torch.cuda.synchronize()
        return out, dict(zip(p, g))

    def counted(render, params):
        torch.cuda.synchronize()
        for w in wrappers.values():
            w.launches = 0
        out, g = run(render, params)
        return out, g, {k: w.launches for k, w in wrappers.items()}

    def errors(out, g, ref_out, ref_g, keys):
        e = {k: float((out[k] - ref_out[k]).detach().abs().max())
             for k in keys}
        e.update({f"grad_{k}": float((g[k] - ref_g[k]).abs().max()
                                     / ref_g[k].abs().max().clamp_min(1e-30))
                  for k in g})
        return e

    ref_out, ref_g = run(lambda p: render_view(p, scene.active, c2w, intr,
                                               rcfg, bg), scene.params)
    res = dict(n_dup=int(ref_out["n_dup"]))
    out, g, n = counted(lambda p: sr.render_view_tile_sharded(
        p, scene.active, c2w, intr, rcfg, bg, tmesh), scene.params)
    res["tile"] = dict(errors(out, g, ref_out, ref_g,
                              ("rgb", "T", "depth", "radii2d")),
                       launches=n, n_dup=int(out["n_dup"]),
                       visible_equal=bool(torch.equal(out["visible"],
                                                      ref_out["visible"])))
    D, d = pm.axis_size(gmesh, "gauss"), pm.axis_rank(gmesh, "gauss")
    sh = gs.shard_scene(gs.interleave_shards(scene, D), gmesh)
    own = {k: pm.shard_rows(v, D, d) for k, v in
           gs.interleave_shards(ref_g, D).items()}
    ref_rows = dict(ref_out, radii2d=pm.shard_rows(gs.interleave_shards(
        ref_out["radii2d"], D), D, d))
    out, g, n = counted(lambda p: gs.render_view_gaussian_sharded(
        p, sh.active, c2w, intr, rcfg, bg, gmesh), sh.params)
    res["gauss"] = dict(errors(out, g, ref_rows, own,
                               ("rgb", "T", "depth", "radii2d")),
                        launches=n, n_dup=int(out["n_dup"]))
    return res


def _slab_rank(rank, folder, device):
    """Phase 18 b on one of two ranks sharing ``device`` (gloo): the bench
    scene's 512^2 view, this rank's 256-row slab through K1-K4, checked
    against the unsharded render; the slab's forward and backward device
    time; 4 Gaussian-sharded steps with a densify and a prune event."""
    import torch

    from gsgen_torch.models.density import DensifyConfig, PruneConfig
    from gsgen_torch.models.init import InitConfig, initialize
    from gsgen_torch.models.scene import RenderConfig, render_view
    from gsgen_torch.ops import cuda_raster, expansion_rank, gid_repack
    from gsgen_torch.ops.camera import CameraIntrinsics
    from gsgen_torch.parallel import collectives as col
    from gsgen_torch.parallel import gaussian_sharded as gs
    from gsgen_torch.parallel import mesh as pm
    from gsgen_torch.parallel import sharded_render as sr
    from gsgen_torch.training.optimizer import adam_init
    from gsgen_torch.utils.precision import exact_fp32

    exact_fp32()
    dev = torch.device(device)
    wrappers = dict(raster_fwd=cuda_raster.raster_fwd,
                    raster_bwd=cuda_raster.raster_bwd,
                    expansion_rank=expansion_rank.expansion_gid,
                    gid_repack=gid_repack.repack_gid)
    rcfg = RenderConfig(**PARALLEL_RENDER)
    intr = CameraIntrinsics.from_reso(512)
    c2w = torch.tensor(C2W_FRONT, device=dev)
    scene = anisotropic(torch, initialize(
        InitConfig(**PARALLEL_SCENE), rcfg,
        torch.Generator(device=dev).manual_seed(0), dev), 1)
    tmesh = pm.make_mesh(2, ("tile",))
    gmesh = pm.make_mesh(2, ("gauss",))
    res = sharded_vs_one(torch, scene, c2w, intr, rcfg, tmesh, gmesh,
                         wrappers)
    # broadcast (replicate): rank 0's values on both
    res["replicated"] = pm.replicate(
        torch.full((4,), float(rank), device=dev), tmesh).tolist()

    # the slab alone, and the whole view, on this rank: forward and
    # backward spans between events (the other rank shares the card)
    slab_h, slab_intr = sr.slab_intrinsics(intr, rcfg, 2)
    bg = torch.ones(3, device=dev)
    p = {k: v.detach().clone().requires_grad_(True)
         for k, v in scene.params.items()}

    def spans(view_intr, **kw):
        fwd_ms, bwd_ms = [], []
        for i in range(6):
            s0, s1, s2 = (torch.cuda.Event(enable_timing=True)
                          for _ in range(3))
            torch.cuda.synchronize()
            s0.record()
            out = render_view(p, scene.active, c2w, view_intr, rcfg, bg,
                              **kw)
            loss = torch.mean(out["rgb"] ** 2) + torch.mean(out["T"])
            s1.record()
            torch.autograd.grad(loss, list(p.values()))
            s2.record()
            torch.cuda.synchronize()
            if i:                   # the first is a warm-up
                fwd_ms.append(s0.elapsed_time(s1))
                bwd_ms.append(s1.elapsed_time(s2))
        return dict(n_dup=int(out["n_dup"]), fwd_ms=fwd_ms, bwd_ms=bwd_ms)

    res["slab"] = dict(spans(slab_intr, cull_intr=intr,
                             pixel_offset_y=rank * slab_h),
                       rows=[rank * slab_h, (rank + 1) * slab_h])
    res["full_view"] = spans(intr)

    # 4 Gaussian-sharded steps; a densify event after step 1 (every live
    # Gaussian a clone candidate), a prune event after step 2
    st = gs.shard_scene(gs.interleave_shards(scene, 2), gmesh)
    opt = gs.shard_scene(gs.interleave_shards(adam_init(scene.params), 2),
                         gmesh)
    step = gs.gaussian_sharded_train_step(gmesh, intr, rcfg)
    densify = gs.sharded_density_step(
        gmesh, DensifyConfig(mean2d_thresh=1e-4, split_thresh=1e9,
                             use_legacy=False), PruneConfig(), rcfg)
    prune = gs.sharded_density_step(
        gmesh, DensifyConfig(enabled=False),
        PruneConfig(enabled=True, alpha_thresh=0.5, radii2d_thresh=0.0),
        rcfg)
    group = pm.axis_group(gmesh, "gauss")

    def live():
        return int(col.all_reduce(st.active.sum().reshape(1), group))

    steps = dict(live=[live()], ms=[], losses=[], events={})
    for s in range(4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, loss = step(st.params, st.active, opt, c2w, bg)
        torch.cuda.synchronize()
        steps["ms"].append(1e3 * (time.perf_counter() - t0))
        st = dataclasses.replace(st, params=params)
        steps["losses"].append(float(loss))
        if s in (1, 2):
            if s == 1:
                st = dataclasses.replace(
                    st, grad_accum=torch.full_like(st.grad_accum, 10.0),
                    grad_cnt=torch.ones_like(st.grad_cnt))
            st, opt, info = (densify if s == 1 else prune)(st, opt, 0.0,
                                                           0.5)
            steps["events"][s] = info
            steps["live"].append(live())
    steps["moments_rows"] = int(opt.mu["mean"].shape[0])
    res["steps"] = steps
    (Path(folder) / f"rank{rank}.json").write_text(json.dumps(res))


def anisotropic(torch, scene, seed):
    """``scene`` with seeded random rotations, per-axis scales (times
    U(0.5, 1.5)) and opacities (logit U(-1, 2)) on its live rows: an
    isotropic scene's rotation gradient is rounding noise."""
    dev = scene.active.device
    gen = torch.Generator(device=dev).manual_seed(seed)
    idx = scene.active.nonzero()[:, 0]
    n = idx.shape[0]
    p = {k: v.clone() for k, v in scene.params.items()}
    p["qvec"][idx] = torch.randn(n, 4, generator=gen, device=dev)
    p["svec"][idx] += torch.log(0.5 + torch.rand(n, 3, generator=gen,
                                                 device=dev))
    p["alpha"][idx] = 3.0 * torch.rand(n, generator=gen, device=dev) - 1.0
    return dataclasses.replace(scene, params=p)


C2W_FRONT = [[1.0, 0, 0, 0], [0, 1.0, 0, 0], [0, 0, 1.0, -2.5]]
# PERF.md's bench scene (100K Gaussians at 512^2) with free capacity for
# the density events, rendered as configs/base.yaml renders (tile 16,
# chunk 256, dup_cap 2^20)
PARALLEL_SCENE = dict(num_points=100_000, capacity=131_072, mean_std=0.6,
                      svec_val=0.01, alpha_val=0.8)
PARALLEL_RENDER = dict(tile_size=16, chunk=256, dup_cap=1 << 20)


def parallel_phases(torch, dev, build_trainer, load_config, wrappers, card):
    """Phase 18: the parallel layouts on the card (module docstring, item
    18): (a) one process, NCCL at world size 1; (b) two ranks on the one
    card over gloo; (c) dryrun_multichip on every card there is."""
    import os
    import tempfile

    from gsgen_torch.models.init import InitConfig, initialize
    from gsgen_torch.models.scene import RenderConfig, render_view
    from gsgen_torch.ops.camera import CameraIntrinsics
    from gsgen_torch.parallel import gaussian_sharded as gs
    from gsgen_torch.parallel import mesh as pm
    from gsgen_torch.parallel import sharded_render as sr
    from gsgen_torch.parallel.dryrun import dryrun_multichip
    from gsgen_torch.training.optimizer import adam_init, adam_update

    res = {}
    raster = {k: wrappers[k] for k in PER_VIEW["padded"]}
    rcfg = RenderConfig(**PARALLEL_RENDER)
    intr = CameraIntrinsics.from_reso(512)
    c2w = torch.tensor(C2W_FRONT, device=dev)
    bench = anisotropic(torch, initialize(
        InitConfig(**PARALLEL_SCENE), rcfg,
        torch.Generator(device=dev).manual_seed(0), dev), 1)
    cfg = load_config(ROOT / "configs" / "base.yaml", ["guidance.type=mock"])
    probe = build_trainer(cfg, device="cuda")
    cam = probe.data.get_batch()
    base = anisotropic(torch, probe.state.scene, 2)
    base_c2w = torch.as_tensor(cam["c2w"][0], device=dev)

    def within(r, img_tol, grad_tol, label):
        for layout in ("tile", "gauss"):
            e = {k: v for k, v in r[layout].items()
                 if isinstance(v, float)}
            require(all(v <= (grad_tol if k.startswith("grad") else img_tol)
                        for k, v in e.items()),
                    f"{label} {layout}: errors {e}")
            require(r[layout]["n_dup"] == r["n_dup"],
                    f"{label} {layout}: n_dup {r[layout]['n_dup']} against "
                    f"{r['n_dup']}")
            n = r[layout]["launches"]
            require(all(n[k] >= 1 for k in PER_VIEW["padded"]),
                    f"{label} {layout}: launches {n}")
        require(r["tile"]["visible_equal"], f"{label} tile: visible")

    # ---- a: one process, NCCL at world size 1 ----
    tmp = tempfile.mkdtemp(prefix="gsgen_nccl1_")
    t0 = time.perf_counter()
    require(pm.init_distributed(f"file://{os.path.join(tmp, 'store')}", 1, 0,
                                backend="nccl"), "18 a: no process group")
    try:
        tmesh = pm.make_mesh(1, ("tile",))
        gmesh = pm.make_mesh(1, ("gauss",))
        dtmesh = pm.make_mesh(1, ("data", "tile"), shape=(1, 1))
        a = {}
        for label, scene, view in (("base.yaml", base, base_c2w),
                                   ("bench 100K", bench, c2w)):
            r = sharded_vs_one(torch, scene, view, intr, rcfg, tmesh, gmesh,
                               raster)
            within(r, 1e-6, 1e-5, f"18 a {label}")
            a[label] = r
        # the 2-D data x tile render of the trainer's 4 views
        c2ws = torch.as_tensor(cam["c2w"], device=dev)
        bgs = torch.ones(len(c2ws), 3, device=dev)
        with torch.no_grad():
            rgb = sr.render_batch_data_tile_sharded(
                base.params, base.active, c2ws, intr, rcfg, bgs, dtmesh)
            want = torch.stack([render_view(base.params, base.active, c,
                                            intr, rcfg, b, rgb_only=True)
                                ["rgb"] for c, b in zip(c2ws, bgs)])
        a["data x tile rgb err"] = float((rgb - want).abs().max())
        require(a["data x tile rgb err"] == 0.0,
                f"18 a data x tile: {a['data x tile rgb err']}")
        # train steps: one Gaussian-sharded and one gauss x tile Adam step
        # against the same step unsharded; the trainer with tile_mesh
        bg = torch.ones(3, device=dev)
        p = {k: v.detach().clone().requires_grad_(True)
             for k, v in bench.params.items()}
        out = render_view(p, bench.active, c2w, intr, rcfg, bg)
        loss = torch.mean(out["rgb"] ** 2) + torch.mean(out["T"])
        g = dict(zip(p, torch.autograd.grad(loss, list(p.values()))))
        want, _ = adam_update(g, adam_init(bench.params), bench.params, 1e-2)
        gtmesh = pm.make_mesh(1, ("gauss", "tile"), shape=(1, 1))
        for name, step in (
                ("gaussian-sharded", gs.gaussian_sharded_train_step(
                    gmesh, intr, rcfg)),
                ("gauss x tile", gs.gauss_tile_train_step(
                    gtmesh, intr, rcfg))):
            got, _, l_got = step(bench.params, bench.active,
                                 adam_init(bench.params), c2w, bg)
            moved = {k: float((got[k] - want[k]).abs().max()) for k in got}
            a[f"{name} step"] = dict(loss=float(l_got),
                                     loss_unsharded=float(loss.detach()),
                                     param_max_diff=moved)
            l_one = float(loss.detach())
            require(abs(float(l_got) - l_one) <= 1e-6 * abs(l_one)
                    and all(v <= 2e-2 for v in moved.values()),
                    f"18 a {name} step: loss {float(l_got)} against "
                    f"{l_one}, params {moved}")
        one = build_trainer(cfg, device="cuda")
        sharded = build_trainer(cfg, device="cuda")
        sharded.tile_mesh = tmesh
        for w in wrappers.values():
            w.launches = 0
        m_s = [sharded.train_step(s) for s in range(2)]
        launches = {k: wrappers[k].launches for k in PER_VIEW["padded"]}
        m_1 = [one.train_step(s) for s in range(2)]
        l_s = [float(m["loss_total"]) for m in m_s]
        l_1 = [float(m["loss_total"]) for m in m_1]
        a["trainer with tile_mesh"] = dict(losses=l_s, unsharded=l_1,
                                           launches=launches)
        require(all(abs(x - y) <= 1e-5 * abs(y) for x, y in zip(l_s, l_1))
                and launches["raster_fwd"] == 8
                and launches["raster_bwd"] == 8,
                f"18 a trainer with tile_mesh: {a['trainer with tile_mesh']}")
    finally:
        torch.distributed.destroy_process_group()
    a["s"] = time.perf_counter() - t0
    res["a"] = a
    del probe, one, sharded
    torch.cuda.empty_cache()
    print(f"phase 18 a nccl world 1: ok | card {card} | "
          + " | ".join(f"{k}: {v}" for k, v in a.items()), flush=True)

    # ---- b: two ranks on the one card (gloo) ----
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="gsgen_slabs_") as folder:
        pm.spawn_ranks(_slab_rank, 2, folder, str(dev), device_type="cuda",
                       backend="gloo")
        ranks = [json.loads((Path(folder) / f"rank{r}.json").read_text())
                 for r in range(2)]
    b = dict(s=time.perf_counter() - t0, ranks=ranks)
    for r, rr in enumerate(ranks):
        within(rr, 1e-5, 1e-4, f"18 b rank {r}")
        require(rr["replicated"] == [0.0] * 4,
                f"18 b rank {r}: replicate gave {rr['replicated']}")
        st = rr["steps"]
        require(all(math.isfinite(x) for x in st["losses"])
                and st["events"]["1"]["num_clone"] > 0
                and st["live"][1] > st["live"][0] > st["live"][2] > 0
                and st["moments_rows"] == PARALLEL_SCENE["capacity"] // 2,
                f"18 b rank {r} steps: {st}")
    res["b"] = b
    print(f"phase 18 b two ranks on one card: ok | card {card} | "
          + " | ".join(
              f"rank {r}: rows {rr['slab']['rows']} n_dup "
              f"{rr['slab']['n_dup']} slab fwd "
              f"{min(rr['slab']['fwd_ms']):.3f} ms bwd "
              f"{min(rr['slab']['bwd_ms']):.3f} ms, whole view fwd "
              f"{min(rr['full_view']['fwd_ms']):.3f} ms bwd "
              f"{min(rr['full_view']['bwd_ms']):.3f} ms (min of 5 spans) "
              f"| tile "
              f"{rr['tile']} | gauss {rr['gauss']} | steps {rr['steps']}"
              for r, rr in enumerate(ranks)), flush=True)

    # ---- c: the dry run on every card ----
    t0 = time.perf_counter()
    n = torch.cuda.device_count()
    dryrun_multichip(n, device_type="cuda")
    res["c"] = dict(ranks=n, s=time.perf_counter() - t0)
    res["launches"] = {k: {
        **{f"a {lab} {lay}": a[lab][lay]["launches"][k]
           for lab in ("base.yaml", "bench 100K") for lay in ("tile",
                                                             "gauss")},
        **{f"b rank {r} {lay}": rr[lay]["launches"][k]
           for r, rr in enumerate(ranks) for lay in ("tile", "gauss")}}
        for k in PER_VIEW["padded"]}
    print(f"phase 18 c dryrun_multichip: ok | {n} rank(s), "
          f"{res['c']['s']:.1f} s", flush=True)
    return res



# phase 19: the c2f resolution switches and the presets no earlier phase
# runs.  a: configs/flagship_rehearsal.yaml with its milestones moved to
# steps 10 and 20 (64^2 -> 256^2 -> 512^2; the feedback steps 0 and 10
# predict the buckets), 22 steps; b: three densify presets with the event
# moved to step 2 of 3 (mock guidance, capacity 65,536), then
# prompt/sd_perp_neg.yaml on the SD 2.1 slice
C2F = ["data.reso_milestones=[10,20]", "prompt.use_cache=false"]
C2F_STEPS = 22
C2F_SPANS = ((64, 0, 10), (256, 10, 20), (512, 20, 22))   # reso, steps
K1_K5 = ("raster_fwd", "raster_bwd", "expansion_rank", "gid_repack",
         "flash_attn_fwd")
DENSIFY_AT_2 = ["guidance.type=mock", "renderer.densify.warm_up=2",
                "renderer.densify.period=2"]
# split_by_scale splits scales above its scale_max (0.08), which base.yaml's
# initial 0.02 never passes: its Gaussians start at 0.1
DENSIFY_PRESETS = {
    "split_by_scale": (["base.yaml", "renderer/split_by_scale.yaml"],
                       ["init.svec_val=0.1"]),
    "progressive": (["base.yaml", "renderer/progressive.yaml"], []),
    "shrink_then_densify": (["shrink_then_densify.yaml"], []),
}
PERP_NEG = ["base.yaml", "prompt/sd_perp_neg.yaml"]


def jax_bucket_rule(n_dup_max, reso, next_reso, bucket_min):
    """The bucket the JAX trainer compiles ahead for the next resolution
    at a feedback step (its Trainer.train_step): the demand scaled by
    (next_reso / reso)^2, buckets doubling from ``bucket_min``."""
    need = max(n_dup_max, 1) * (next_reso / max(reso, 1)) ** 2
    b = bucket_min
    while b < need:
        b *= 2
    return b


def record_bins():
    """Wrap the binning that render_view calls; each view's (width, bucket,
    cap + pad_budget, demand, padded demand) goes to the returned list
    (tensors: read them after a synchronize).  Returns it and a restore
    function."""
    from gsgen_torch.models import scene as scene_mod
    orig = scene_mod.bin_gaussians
    rec = []

    def wrapped(*args, **kw):
        bins = orig(*args, **kw)
        # (mean2d, cov2d, depth, active, fx, fy, cx, cy, w, h, tile, cap)
        rec.append((args[8], args[11], args[11] + kw["pad_budget"],
                    bins.total, bins.padded_total))
        return bins

    scene_mod.bin_gaussians = wrapped

    def restore():
        scene_mod.bin_gaussians = orig
    return rec, restore


def c2f_phases(torch, build_trainer, load_config, wrappers, card):
    """Phase 19 (a) the flagship across both resolution switches: each
    step's bucket, n_dup_max and padded demand; a bucket at a switch below
    the JAX rule's prediction from the feedback step's n_dup_max fails;
    (b) split_by_scale, progressive and shrink_then_densify through their
    densify event (the live count must change; the event's counts, ms
    and peak memory), and the perp-neg prompt on the SD 2.1 slice (its
    per-view weights, which must be read every step)."""
    from gsgen_torch.models.density import should_run
    from gsgen_torch.prompt.processors import PromptEmbedding

    res = {}
    # ---- a: the flagship across both switches ----
    rec, restore = record_bins()
    steps = []

    def on_step(tr, step, metrics):
        views = [(w, cap, capp, int(t), int(pt))
                 for w, cap, capp, t, pt in rec]
        rec.clear()
        require(len({v[:3] for v in views}) == 1,
                f"19 a step {step}: views differ in reso or bucket {views}")
        steps.append(dict(reso=views[0][0], bucket=views[0][1],
                          cap_padded=views[0][2],
                          demand=max(v[3] for v in views),
                          padded_demand=max(v[4] for v in views),
                          n_dup_max=int(metrics["n_dup_max"]),
                          launches={k: wrappers[k].launches
                                    for k in K1_K5}))

    try:
        trainer, a = drive(torch, build_trainer, load_config, wrappers,
                           "flagship_rehearsal.yaml", C2F, C2F_STEPS,
                           dict(flash_attn_fwd=SD21_K5_PER_FWD),
                           on_step=on_step)
    finally:
        restore()
    bucket_min = trainer.cfg.dup_bucket_min
    del trainer
    torch.cuda.empty_cache()
    spans = []
    for i, (reso, lo, hi) in enumerate(C2F_SPANS):
        seg = steps[lo:hi]
        require({s["reso"] for s in seg} == {reso},
                f"19 a steps {lo}-{hi - 1}: resos {[s['reso'] for s in seg]}")
        prev = steps[lo - 1] if lo else None
        span = dict(
            reso=reso, steps=[lo, hi - 1],
            bucket_before=prev and prev["bucket"], bucket_at=seg[0]["bucket"],
            buckets=[s["bucket"] for s in seg],
            n_dup_max=[s["n_dup_max"] for s in seg],
            demand=max(s["demand"] for s in seg),
            padded_demand=max(s["padded_demand"] for s in seg),
            cap_padded=[s["cap_padded"] for s in seg],
            drops=any(s["padded_demand"] > s["cap_padded"] for s in seg),
            ms_per_step=a["ms_per_step"][lo:hi],
            launches={k: seg[-1]["launches"][k]
                      - (prev["launches"][k] if prev else 0)
                      for k in K1_K5})
        if lo:
            fb, fb_reso = C2F_SPANS[i - 1][1], C2F_SPANS[i - 1][0]
            span["predicted"] = jax_bucket_rule(
                steps[fb]["n_dup_max"], fb_reso, reso, bucket_min)
            span["feedback"] = dict(step=fb,
                                    n_dup_max=steps[fb]["n_dup_max"])
            require(span["bucket_at"] >= span["predicted"],
                    f"19 a: the bucket at step {lo} is {span['bucket_at']}, "
                    f"below the JAX rule's {span['predicted']} from "
                    f"n_dup_max {steps[fb]['n_dup_max']} at step {fb}")
        spans.append(span)
        print(f"phase 19 a {reso}^2: ok | card {card} | steps {lo}-{hi - 1}"
              + (f" | bucket {span['bucket_before']} before the switch, "
                 f"{span['bucket_at']} at it; the JAX rule predicts "
                 f"{span['predicted']} from n_dup_max "
                 f"{span['feedback']['n_dup_max']} at step "
                 f"{span['feedback']['step']}" if lo else
                 f" | bucket {span['bucket_at']}")
              + f" | buckets {span['buckets']} | n_dup_max "
              f"{span['n_dup_max']} | padded demand max "
              f"{span['padded_demand']} of cap + pad_budget "
              f"{sorted(set(span['cap_padded']))} (demand max "
              f"{span['demand']}; tiles dropped: "
              f"{'yes' if span['drops'] else 'no'}) | ms/step "
              f"{[round(x, 2) for x in span['ms_per_step']]} | launches "
              f"{span['launches']}", flush=True)
    res["a"] = dict(config=a["config"], losses=a["losses"],
                    peak_gib=a["peak_gib"], launches=a["launches"],
                    bucket_min=bucket_min, spans=spans)

    # ---- b: three densify presets and perp-neg ----
    res["b"] = {}
    for name, (cfgs, extra) in DENSIFY_PRESETS.items():
        live, ev = [], {}

        def prepare(tr, ev=ev):
            orig = tr.density_step

            def measured(step):
                d = tr.dcfg
                if not should_run(step, d.enabled, d.warm_up, d.end,
                                  d.period):
                    return orig(step)
                torch.cuda.synchronize()
                ev["run_peak_gib"] = \
                    torch.cuda.max_memory_allocated() / 2 ** 30
                base = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                info = orig(step)
                torch.cuda.synchronize()
                ev.update(step=step, ms=1e3 * (time.perf_counter() - t0),
                          peak_gib_above_start=(
                              torch.cuda.max_memory_allocated() - base)
                          / 2 ** 30, **info)
                return info
            tr.density_step = measured

        trainer, r = drive(
            torch, build_trainer, load_config, wrappers, cfgs,
            DENSIFY_AT_2 + extra, 3, {}, prepare=prepare,
            on_step=lambda tr, s, m, live=live: live.append(
                int(tr.state.scene.active.sum())))
        cap = trainer.state.scene.active.shape[0]
        dtype = trainer.dcfg.type
        del trainer
        torch.cuda.empty_cache()
        require(cap == 65536, f"19 b {name}: capacity {cap}")
        require(ev.get("step") == 2 and live[2] != live[1],
                f"19 b {name}: densify ({dtype}) at step 2 left the live "
                f"count {live}: {ev}")
        res["b"][name] = dict(r, type=dtype, live=live, event=ev)
        print(f"phase 19 b {name}: ok | card {card} | {r['config']}: "
              f"densify {dtype} at step 2, capacity {cap}: live per step "
              f"{live} | event {ev} | losses {r['losses']} | ms/step "
              f"{[round(x, 2) for x in r['ms_per_step']]} | launches "
              f"{r['launches']}", flush=True)

    weights = []
    orig = PromptEmbedding.get_text_embeddings_perp_neg

    def recorded(self, *args, **kw):
        emb, w = orig(self, *args, **kw)
        weights.append([[round(x, 4) for x in row]
                        for row in w.detach().cpu().tolist()])
        return emb, w

    PromptEmbedding.get_text_embeddings_perp_neg = recorded
    try:
        trainer, p = drive(torch, build_trainer, load_config, wrappers,
                           PERP_NEG, SLICE + ["prompt.use_cache=false"], 2,
                           dict(flash_attn_fwd=SD21_K5_PER_FWD))
    finally:
        PromptEmbedding.get_text_embeddings_perp_neg = orig
    del trainer
    torch.cuda.empty_cache()
    require(len(weights) == 2 and all(len(w) == p["batch"] for w in weights)
            and any(x != 0 for w in weights for row in w for x in row),
            f"19 b perp_neg: the perp-neg branch's weights {weights}")
    res["b"]["perp_neg"] = dict(p, weights=weights)
    print(f"phase 19 b perp_neg: ok | card {card} | {p['config']}: "
          f"per-view weights (neg0, neg1) per step {weights} | losses "
          f"{p['losses']} | ms/step "
          f"{[round(x, 2) for x in p['ms_per_step']]} | peak "
          f"{p['peak_gib']:.2f} GiB | launches {p['launches']}", flush=True)
    return res


if __name__ == "__main__":
    sys.exit(main())
