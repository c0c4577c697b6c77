"""Training orchestration: one text-to-3D training step, eagerly.

Port of the JAX package's ``training/trainer.py``.  A step runs in the
same order as the JAX package's jitted ``train_step``: backgrounds (the
``mlp`` one over each view's ray directions), render (with each view's
light under ``renderer.pbr``), guidance, the sparsity / opague / z_var
terms, penalties, backward, per-field Adam, then the densify statistics
(``grad_accum``, ``grad_cnt``, ``max_radii2d``); after the step, the
densify and prune events that are due (:mod:`..models.density`).  The
host loop evaluates ``C()`` schedules, samples numpy camera poses and
keeps the duplicate-capacity bucket policy.  Eager PyTorch compiles nothing, so the JAX package's
compile-ahead threads have no counterpart.

Guidance is ``MockGuidance``, SDS (:mod:`..guidance.sds`) or VSD
(:mod:`..guidance.vsd`); the SD backbone freezes its own weights.  An
auxiliary guidance (:mod:`..guidance.point_e_aux`: SDS of a point-cloud
diffusion model on the Gaussian means) adds ``w_aux · loss_aux`` to the
same loss, so its gradient reaches the means through the same backward.
The optimizer's leaves are the scene fields (the PBR ``specular`` and
``normal`` at ``lr_specular`` / ``lr_normal``, by default ``lr_color``),
the background (``bg/<name>``, at ``lr_bg``) and the guidance's trainable
leaves (``gp/<name>``: VSD's LoRA and camera embedding, at
``lr_guidance``).  The ``move`` penalty holds the means to where they were
before the previous update (the current means on the first step).

With a ``logger`` (:class:`..io.logging.RunLogger`), ``fit`` logs scalars,
field statistics, eval images and orbit videos and saves checkpoints on
the JAX package's periods; :meth:`Trainer.load` resumes from a checkpoint
of either package (:mod:`..io.checkpoint`).

Every ``guidance_eval_period`` steps the logger also gets a CFG sample of
the guidance at a fixed pose (``eval/guidance_sample``,
:meth:`Trainer._guidance_sample`), and ``profile_steps: [a, b]`` writes a
``torch.profiler`` trace of steps a to b - 1 under the run directory's
``profile/`` (:func:`..utils.profiling.trace`).  While any profiler
records, the step marks its layers with ``gsgen:`` spans
(:func:`..utils.profiling.span`): ``step`` (with its index) around ``cameras``, ``background``, ``render``, ``guidance``
(``vae``, ``unet``, ``attn`` inside), ``aux_guidance``, ``estimator``,
``losses``, ``backward`` (the layers' backward spans ``unet_bwd``,
``attn_bwd``, ``vae_bwd``, ``render_bwd`` on autograd's thread),
``adam``, ``stats`` and ``sync`` (a host read of a device value), and
``density`` after the step; the renders count their views and
duplicates (:func:`..utils.profiling.counters`).

Image-to-3D (:mod:`.sit3d`): with an ``image_target``, a batch that
carries ``is_original`` adds ``w_image · loss_image + w_depth ·
loss_depth`` of its original views; a ``grad_mask`` [capacity] zeroes the
gradient of its rows before Adam while ``mask_steps`` (start, end)
holds the step, so those rows' moments stay 0 and their parameters stay
bitwise as they were.  The mask is indexed by scene row, through density
events too, as the JAX package indexes it.  The ``estimators`` (only the
``enabled`` ones; ``depth`` and ``normal``, each a DPT checkpoint,
:mod:`..priors.dpt`) run on every render: ``depth`` adds ``w_est_depth``
x (1 - Pearson) of DPT's depth against the rendered depth, ``normal`` the
MSE of DPT's normal against the rendered normal (it turns
``render_normal`` on: 8 composited features).  The gradient flows back
through DPT into the render.

Scale-out (:mod:`..parallel`), every rank running this trainer:
``tile_mesh`` (a device mesh with a ``tile`` axis) renders each view
tile-sharded over it, every rank computing the same loss on the whole
images (the generators, seeded alike, draw alike); the render's gradients
and the densify statistics are summed (``radii2d`` and ``visible``: their
maximum) over the slabs, and the bucket policy sees the duplicates summed
over them, as in the JAX package.  ``data_mesh`` (a ``data`` axis) splits
each batch's views over its ranks: every rank samples the whole batch and
keeps its own views, its loss is scaled by 1/D so that the all-reduced
gradients are those of the mean over all views, the statistics and the
metrics are reduced over the ranks, and a data rank r > 0 re-seeds its
generator (seed + r·2^32) after the init so that its views draw noise and
backgrounds of their own; its density events are then replaced by data
rank 0's.  The JAX package gets the data-parallel step from its sharded
inputs; the two meshes may be the axes of one 2-D mesh.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from ..data.cameras import CameraPoseProvider, CameraSamplerConfig
from ..guidance import convert
from ..guidance.mock import MockGuidance
from ..models.background import (BackgroundConfig, apply_background,
                                 init_background)
from ..models.density import (DensifyConfig, PruneConfig, densify, prune,
                              should_run)
from ..models.init import InitConfig, initialize
from ..models.scene import (FIELDS, OPTIONAL_FIELDS, RenderConfig,
                            SceneState, activate, present_fields,
                            render_batch, scene_from_numpy)
from ..ops.camera import get_rays_d
from ..parallel import collectives as col
from ..parallel.mesh import (axis_group, axis_rank, axis_size, replicate,
                             shard_batch)
from ..utils import profiling
from ..utils.schedule import C, make_lr_schedule
from .losses import PENALTIES, pearson_depth_loss, penalty
from .optimizer import AdamState, adam_init, adam_update
from .sit3d import ImageTarget, sit3d_losses


@dataclasses.dataclass
class LossConfig:
    sds: Any = 0.1
    vsd: Any = 1.0
    lora: Any = 1.0
    sparsity: Any = 0.0
    opague: Any = 0.0          # sic — reference spelling
    z_var: Any = 0.0
    image: Any = 1000.0
    depth: Any = 10.0
    aux_guidance: Any = 0.0


@dataclasses.dataclass
class TrainerConfig:
    """Same keys as the JAX package's TrainerConfig."""

    max_steps: int = 15000
    batch_size: int = 4
    grad_accum: int = 1
    seed: int = 0
    use_bg: bool = True
    rgb_only: bool = False
    lr: Dict[str, Any] = dataclasses.field(default_factory=lambda: dict(
        mean=[0.005, 3.0e-5, 15000, "exp"],
        svec=[0.003, 0.001, 15000, "exp"],
        qvec=0.003, color=0.01, alpha=0.003, bg=0.003, guidance=1e-4))
    loss: LossConfig = dataclasses.field(default_factory=LossConfig)
    penalty: Dict[str, Dict] = dataclasses.field(default_factory=lambda: {
        "alpha": {"type": "center_weighted", "value": 0.0}})
    log_period: int = 100
    save_period: int = 2000
    estimators: Dict[str, Dict] = dataclasses.field(default_factory=dict)
    auto_dup_bucket: bool = True
    dup_bucket_min: int = 1 << 14
    reso_prewarm_lead: int = 500
    eval_image_period: int = 100
    eval_video_period: int = 500
    guidance_eval_period: int = 0
    guidance_eval_steps: int = 25
    eval_elevation: float = 45.0
    eval_n_frames: int = 30
    eval_camera_distance: float = 2.5
    profile_steps: Any = None
    field_stats_period: int = 0


@dataclasses.dataclass
class TrainState:
    scene: SceneState
    bg: Dict[str, torch.Tensor]
    gp: Dict[str, torch.Tensor]   # trainable guidance leaves; {} if none
    opt: AdamState       # over the scene fields, "bg/<name>", "gp/<name>"
    step: int


def _opt_params(params: Dict[str, torch.Tensor],
                bg: Dict[str, torch.Tensor],
                gp: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The optimizer's leaves: scene fields, ``bg/<name>``, ``gp/<name>``."""
    return {**params, **{f"bg/{k}": v for k, v in bg.items()},
            **{f"gp/{k}": v for k, v in gp.items()}}


def _gp_leaf(name: str, arr: np.ndarray):
    """A JAX ``gp`` leaf in the port's naming and layout: a flax path
    (``params/.../to_q_lora/down/kernel``) becomes its torch key with the
    kernel transposed; a plain name (the MockUNet adapter's) stays as it
    is."""
    if "/" not in name:
        return name, arr
    path = tuple(name.split("/"))
    key, kind = convert.flax_path_to_torch_key(
        path[1:] if path[0] == "params" else path)
    return key, np.ascontiguousarray(convert.to_torch_leaf(kind, arr))


def train_state_from_jax_arrays(arrays: Dict[str, np.ndarray], device
                                ) -> TrainState:
    """TrainState from the flattened key paths the JAX package's
    checkpoints write to ``arrays.npz`` (``.scene/.params/.mean``,
    ``.opt/.mu/[0]/.mean``, ``.bg/['name']``, ``.gp/['name']``,
    ``.opt/.mu/[2]/['name']``, ``.step``, ...).  Guidance leaves and their
    moments take the port's names and layouts (:func:`_gp_leaf`).  The
    JAX RNG key is not carried: the port draws from its own generator."""
    def field(path, name):
        return arrays[f"{path}/.{name}"]

    fields = [f for f in FIELDS + OPTIONAL_FIELDS
              if f".scene/.params/.{f}" in arrays]
    scene = scene_from_numpy(
        {**{f: field(".scene/.params", f) for f in fields},
         **{s: field(".scene", s) for s in
            ("active", "max_radii2d", "grad_accum", "grad_cnt")}},
        device)

    def named(prefix, leaf=lambda k, a: (k, a)):
        out = {}
        for key in arrays:
            if key.startswith(prefix + "/['"):
                k, a = leaf(key[len(prefix) + 3:-2], np.array(arrays[key]))
                out[k] = torch.as_tensor(a, device=device)
        return out

    bg, gp = named(".bg"), named(".gp", _gp_leaf)
    moments = {}
    for m in ("mu", "nu"):
        mom = {f: torch.as_tensor(np.array(field(f".opt/.{m}/[0]", f)),
                                  device=device) for f in fields}
        mom.update({f"bg/{k}": v for k, v in
                    named(f".opt/.{m}/[1]").items()})
        mom.update({f"gp/{k}": v for k, v in
                    named(f".opt/.{m}/[2]", _gp_leaf).items()})
        moments[m] = mom
    opt = AdamState(mu=moments["mu"], nu=moments["nu"],
                    count=int(arrays[".opt/.count"]))
    return TrainState(scene=scene, bg=bg, gp=gp, opt=opt,
                      step=int(arrays[".step"]))


class Trainer:
    """Host loop around the eager train step; tensors live on ``device``
    (the card unless the caller passes ``device="cpu"``)."""

    def __init__(self, cfg: TrainerConfig, rcfg: RenderConfig,
                 init_cfg: InitConfig, bg_cfg: BackgroundConfig,
                 data_cfg: CameraSamplerConfig,
                 guidance: Optional[Any] = None,
                 dcfg: DensifyConfig = DensifyConfig(),
                 pcfg: PruneConfig = PruneConfig(),
                 init_points: Optional[np.ndarray] = None,
                 init_colors: Optional[np.ndarray] = None,
                 init_raw: Optional[Dict[str, np.ndarray]] = None,
                 prompt_processor: Optional[Any] = None,
                 aux_guidance: Optional[Any] = None,
                 image_target: Optional[ImageTarget] = None,
                 grad_mask: Optional[torch.Tensor] = None,
                 mask_steps: tuple = (-1, -1),
                 estimators: Optional[Dict[str, Any]] = None,
                 device="cuda", logger: Optional[Any] = None,
                 tile_mesh: Optional[Any] = None,
                 data_mesh: Optional[Any] = None):
        """``estimators`` (name -> :class:`..priors.dpt.DPTEstimator`)
        replace the ones ``cfg.estimators`` would load; ``tile_mesh`` and
        ``data_mesh`` as the module docstring says."""
        for name in cfg.penalty:
            if name not in PENALTIES:
                raise NotImplementedError(f"penalty {name}")
        self.device = torch.device(device)
        self.cfg = cfg
        self.rcfg = rcfg
        self.bg_cfg = bg_cfg
        self.dcfg = dcfg
        self.pcfg = pcfg
        self.guidance = guidance or MockGuidance()
        self.prompt_processor = prompt_processor
        self.aux_guidance = aux_guidance
        self.image_target = image_target
        self.grad_mask = grad_mask
        self.mask_steps = tuple(mask_steps)
        self.logger = logger
        if estimators is None:
            estimators = {name: self._load_estimator(name, d)
                          for name, d in cfg.estimators.items()
                          if d.get("enabled", False)}
        self.estimators = estimators
        if "normal" in estimators and not rcfg.render_normal:
            self.rcfg = rcfg = dataclasses.replace(rcfg, render_normal=True)
        self.data = CameraPoseProvider(data_cfg, seed=cfg.seed)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(cfg.seed)

        scene = initialize(init_cfg, rcfg, self.generator, self.device,
                           points=init_points, colors=init_colors,
                           raw_values=init_raw)
        bg = init_background(bg_cfg, self.generator, self.device)
        self.tile_mesh = tile_mesh
        self.data_mesh = data_mesh
        if data_mesh is not None and axis_rank(data_mesh, "data") > 0:
            self.generator.manual_seed(
                cfg.seed + (axis_rank(data_mesh, "data") << 32))
        gp = {k: v.detach().clone() for k, v in getattr(
            self.guidance, "trainable_params", {}).items()}
        self.state = TrainState(
            scene=scene, bg=bg, gp=gp,
            opt=adam_init(_opt_params(scene.params, bg, gp)), step=0)
        self.lr_fns = {k: make_lr_schedule(v, cfg.max_steps)
                       for k, v in cfg.lr.items()}
        self.dup_bucket = rcfg.dup_cap
        self._shrink_streak = 0
        # the (intrinsics, bucket) pairs the JAX trainer would have built or
        # compiled ahead a step for (its _step_cache and _prewarm_threads);
        # a step at new intrinsics jumps onto the smallest of them
        self._bucket_keys = set()
        self._last_intr = None
        self._prev_mean = None

    def _load_estimator(self, name: str, d: Dict):
        from ..priors.dpt import DPTEstimator
        if name not in ("depth", "normal"):
            raise ValueError(f"estimators.{name}: depth or normal")
        if not d.get("checkpoint"):
            raise ValueError(f"estimators.{name}.checkpoint required (an "
                             "omnidata .ckpt, priors/dpt.py)")
        return DPTEstimator.from_checkpoint(d["checkpoint"], mode=name,
                                            device=self.device)

    def load(self, ckpt_path) -> int:
        """Resume from a checkpoint of either package (a ``step_N`` dir, or
        a ``ckpts`` dir whose latest step is taken).  Build this Trainer
        with the same configs first: its state is the shape template."""
        from ..io.checkpoint import load_checkpoint
        self.state, step = load_checkpoint(ckpt_path, self.state)
        return step

    # ---- schedules (host side) ----
    def sched_scalars(self, step: int) -> Dict[str, float]:
        c = lambda v: C(v, step, self.cfg.max_steps)  # noqa: E731
        s = {
            "w_sds": c(self.cfg.loss.sds),
            "w_vsd": c(self.cfg.loss.vsd),
            "w_lora": c(self.cfg.loss.lora),
            "w_sparsity": c(self.cfg.loss.sparsity),
            "w_opague": c(self.cfg.loss.opague),
            "w_z_var": c(self.cfg.loss.z_var),
        }
        for f, fn in self.lr_fns.items():
            s[f"lr_{f}"] = fn(step)
        for name, p in self.cfg.penalty.items():
            s[f"w_pen_{name}"] = c(p["value"])
        if hasattr(self.guidance, "sched_scalars"):
            s.update(self.guidance.sched_scalars(step, self.cfg.max_steps))
        if self.image_target is not None:
            s["w_image"] = c(self.cfg.loss.image)
            s["w_depth"] = c(self.cfg.loss.depth)
        if self.aux_guidance is not None:
            s["w_aux"] = c(self.cfg.loss.aux_guidance)
        for name in self.estimators:
            s[f"w_est_{name}"] = c(
                self.cfg.estimators.get(name, {}).get("value", 1.0))
        ms, me = self.mask_steps
        s["grad_mask_on"] = 1.0 if (self.grad_mask is not None
                                    and ms <= step <= me) else 0.0
        return s

    def _effective_rcfg(self) -> RenderConfig:
        if self.dup_bucket == self.rcfg.dup_cap:
            return self.rcfg
        return dataclasses.replace(self.rcfg, dup_cap=self.dup_bucket)

    def _loss(self, params, bg, gp, taps, batch, sched, intr, rcfg,
              prev_mean):
        cfg = self.cfg
        B = batch["c2w"].shape[0]
        # the mlp reads the static intrinsics' rays, not the jittered focal
        with profiling.span("background"):
            dirs = ([get_rays_d(c, intr) for c in batch["c2w"]]
                    if self.bg_cfg.type == "mlp" else [None] * B)
            bgs = torch.stack([apply_background(
                bg, self.bg_cfg, self.generator, self.device, dirs=d,
                training=True) for d in dirs])
            if not cfg.use_bg:
                bgs = torch.zeros_like(bgs)
        lights = {}
        if rcfg.pbr and "light_pos" in batch:
            lights = dict(light_pos=batch["light_pos"],
                          light_color=batch["light_color"])
        with profiling.span("render"):
            outs = render_batch(params, self.state.scene.active,
                                batch["c2w"], intr, rcfg, bgs, batch["fx"],
                                batch["fy"], batch["cx"], batch["cy"],
                                rgb_only=cfg.rgb_only, mean2d_taps=taps,
                                tile_mesh=self.tile_mesh, **lights)
        if profiling.recording():
            # the render's backward: from the gradient reaching its outputs
            # to the scene's leaves, the taps and the backgrounds receiving
            # theirs
            profiling.backward_span(
                "render_bwd",
                [v for v in outs.values() if v.is_floating_point()],
                [*params.values(), taps, bgs])
        embedding = (self.prompt_processor()
                     if self.prompt_processor is not None else None)
        with profiling.span("guidance"):
            g = self.guidance.loss(outs["rgb"], embedding,
                                   batch["elevation"], batch["azimuth"],
                                   batch["camera_distance"],
                                   generator=self.generator, sched=sched,
                                   c2ws=batch["c2w"], fxs=batch["fx"],
                                   fys=batch["fy"], cxs=batch["cx"],
                                   cys=batch["cy"], train=gp)
        loss = sched["w_sds"] * g.get("loss_sds", 0.0)
        if "loss_vsd" in g:
            loss = loss + sched["w_vsd"] * g["loss_vsd"]
        if "loss_lora" in g:
            loss = loss + sched["w_lora"] * g["loss_lora"]
        metrics = dict(g)
        if self.image_target is not None and "is_original" in batch:
            with profiling.span("losses"):
                sl = sit3d_losses(outs, batch, self.image_target)
                loss = (loss + sched["w_image"] * sl["loss_image"]
                        + sched["w_depth"] * sl["loss_depth"])
                metrics.update(sl)
        if self.aux_guidance is not None:
            with profiling.span("aux_guidance"):
                col = activate(params, rcfg)[3]
                ag = self.aux_guidance.loss(
                    params["mean"], col, self.state.scene.active,
                    embedding.text if embedding is not None else None,
                    generator=self.generator)
                loss = loss + sched["w_aux"] * ag["loss_aux"]
                metrics.update(ag)
        for name, est in self.estimators.items():
            # reference estimator_loss_step (trainer.py:424-456)
            with profiling.span("estimator"):
                pred = est.estimate(outs["rgb"])
                if name == "depth":
                    depth = outs["depth"].reshape(pred.shape[:3])
                    est_loss = torch.mean(torch.stack([
                        pearson_depth_loss(p, d)
                        for p, d in zip(pred[..., 0], depth)]))
                else:
                    nrm = outs["normal"].reshape(pred.shape)
                    est_loss = torch.mean(
                        (nrm - torch.clamp(pred, 0.0, 1.0)) ** 2)
                loss = loss + sched[f"w_est_{name}"] * est_loss
                metrics[f"loss_est_{name}"] = est_loss
        with profiling.span("losses"):
            if not cfg.rgb_only:
                opacity = outs["opacity"]
                sparsity = torch.mean(torch.sqrt(opacity ** 2 + 0.01))
                o = torch.clamp(opacity, 1e-3, 1.0 - 1e-3)
                opague = torch.mean(-(o * torch.log(o)
                                      + (1 - o) * torch.log(1 - o)))
                z_var = torch.mean(outs["z_var"] / o * (o > 0.5))
                loss = (loss + sched["w_sparsity"] * sparsity
                        + sched["w_opague"] * opague
                        + sched["w_z_var"] * z_var)
                metrics.update(loss_sparsity=sparsity, loss_opague=opague,
                               loss_z_var=z_var)
            for name, p in cfg.penalty.items():
                pen = penalty(name, p, params, self.state.scene.active,
                              rcfg, prev_mean)
                loss = loss + sched[f"w_pen_{name}"] * pen
                metrics[f"pen_{name}"] = pen
            metrics["loss_total"] = loss
            metrics["n_dup_max"] = torch.amax(outs["n_dup"])
        return loss, outs, metrics

    def _train_step(self, batches, sched, intr, prev_mean):
        """One optimizer step over ``grad_accum`` micro-batches."""
        cfg = self.cfg
        state = self.state
        scene = state.scene
        rcfg = self._effective_rcfg()
        params = {k: v.detach().requires_grad_(True)
                  for k, v in scene.params.items()}
        bg = {k: v.detach().requires_grad_(True)
              for k, v in state.bg.items()}
        gp = {k: v.detach().requires_grad_(True)
              for k, v in state.gp.items()}
        leaves = _opt_params(params, bg, gp)
        A = cfg.grad_accum
        D = 1 if self.data_mesh is None else axis_size(self.data_mesh, "data")
        gsum = {k: torch.zeros_like(v) for k, v in leaves.items()}
        tap_grads, vis_list, radii_list = [], [], []
        for batch in batches:
            B = batch["c2w"].shape[0]
            taps = torch.zeros(B, scene.params["mean"].shape[0], 2,
                               device=self.device, requires_grad=True)
            loss, outs, metrics = self._loss(params, bg, gp, taps, batch,
                                             sched, intr, rcfg, prev_mean)
            names = list(leaves)
            with profiling.span("backward"):
                try:
                    grads = torch.autograd.grad(
                        loss / D, [leaves[k] for k in names] + [taps],
                        allow_unused=True)
                finally:
                    profiling.close_all()
            for k, gr in zip(names, grads[:-1]):
                if gr is not None:
                    gsum[k] = gsum[k] + gr
            tap_grads.append(grads[-1])
            if not cfg.rgb_only:
                vis_list.append(outs["visible"])
                radii_list.append(outs["radii2d"].detach())
        grads = {k: v / A for k, v in gsum.items()}
        if D > 1:
            grads = col.sum_tensors(grads, axis_group(self.data_mesh, "data"))
        if self.grad_mask is not None:
            # freeze the masked rows while the window is on
            # (register_mask, gs/gaussian_splatting.py:341-366)
            keep = 1.0 - sched["grad_mask_on"] * self.grad_mask.to(
                torch.float32)
            for k in scene.params:
                grads[k] = grads[k] * keep.reshape(
                    (-1,) + (1,) * (grads[k].dim() - 1))
        lrs = {k: sched.get(f"lr_{k}", sched["lr_color"])
               if k in OPTIONAL_FIELDS else sched[f"lr_{k}"]
               for k in scene.params}
        lrs.update({f"bg/{k}": sched["lr_bg"] for k in state.bg})
        lrs.update({f"gp/{k}": sched.get("lr_guidance", 1e-4)
                    for k in state.gp})
        with profiling.span("adam"):
            new, opt = adam_update(
                grads, state.opt,
                _opt_params(scene.params, state.bg, state.gp), lrs)

        with torch.no_grad(), profiling.span("stats"):
            tg = torch.cat(tap_grads, dim=0)                 # [A*B, M, 2]
            gnorm = torch.linalg.norm(tg, dim=-1)
            if vis_list:
                cnt = torch.sum(torch.cat(vis_list, dim=0), dim=0)
                r = torch.amax(torch.cat(radii_list, dim=0), dim=0)
            else:
                cnt, r = torch.sum(gnorm > 0, dim=0), None
            stats = dict(accum=torch.sum(gnorm, dim=0), cnt=cnt)
            if D > 1:
                group = axis_group(self.data_mesh, "data")
                stats = col.sum_tensors(stats, group)
                r = None if r is None else col.reduce_max(r, group)
                metrics = self._reduce_metrics(metrics, group, D)
            grad_accum = scene.grad_accum + stats["accum"]
            grad_cnt = scene.grad_cnt + stats["cnt"]
            max_radii2d = (scene.max_radii2d if r is None
                           else torch.maximum(scene.max_radii2d, r))
        new_scene = SceneState(
            params={k: new[k] for k in scene.params}, active=scene.active,
            max_radii2d=max_radii2d, grad_accum=grad_accum,
            grad_cnt=grad_cnt.to(torch.float32))
        new_bg = {k: new[f"bg/{k}"] for k in state.bg}
        new_gp = {k: new[f"gp/{k}"] for k in state.gp}
        self.state = TrainState(scene=new_scene, bg=new_bg, gp=new_gp,
                                opt=opt, step=state.step + 1)
        return {k: v.detach() for k, v in metrics.items()}

    @staticmethod
    def _reduce_metrics(metrics, group, D: int):
        """Scalar metrics averaged over the data ranks (each a mean over
        its views, or the same on every rank); ``n_dup_max`` their max."""
        keys = [k for k in metrics if k != "n_dup_max"]
        vals = col.all_reduce(torch.stack([
            torch.as_tensor(metrics[k], dtype=torch.float32).reshape(())
            for k in keys]), group) / D
        out = dict(zip(keys, vals.unbind()))
        out["n_dup_max"] = col.reduce_max(metrics["n_dup_max"], group)
        return out

    def _adjust_dup_bucket(self, n_dup_max: int, intr):
        """Grow on (near-)overflow, shrink after 20 undersubscribed
        feedback events in a row; at 10 the half bucket is recorded for
        ``intr``, where the JAX trainer compiles it ahead (JAX
        trainer.py:498-524).  The JAX shrink waits for that compile; the
        port has none, so it shrinks at 20, as the JAX trainer does once
        the compile has landed."""
        cap = self.dup_bucket
        if n_dup_max > 0.7 * cap:
            self.dup_bucket = cap * 2
            self._shrink_streak = 0
        elif n_dup_max < 0.15 * cap and cap > self.cfg.dup_bucket_min:
            self._shrink_streak += 1
            if self._shrink_streak >= 10:
                self._bucket_keys.add((intr, cap // 2))
            if self._shrink_streak >= 20:
                self.dup_bucket = cap // 2
                self._shrink_streak = 0
        else:
            self._shrink_streak = 0

    def _bucket_feedback(self, step: int, intr, n_dup_max: int):
        """A feedback step's bucket policy (JAX trainer.py:557-589): adjust
        the bucket; past 0.35 of it, record its double; within
        ``reso_prewarm_lead`` steps of a resolution milestone, record the
        bucket the next resolution will need and its double: footprints
        scale about (r_next / r)^2, buckets double from ``dup_bucket_min``."""
        self._adjust_dup_bucket(n_dup_max, intr)
        if n_dup_max > 0.35 * self.dup_bucket:
            self._bucket_keys.add((intr, self.dup_bucket * 2))
        nxt = self.data.next_reso_change(step)
        if nxt is not None and step >= nxt[0] - self.cfg.reso_prewarm_lead:
            need = max(n_dup_max, 1) * (nxt[1] / max(self.data.reso, 1)) ** 2
            b = self.cfg.dup_bucket_min
            while b < need:
                b *= 2
            intr_next = self.data.intrinsics(reso=nxt[1])
            self._bucket_keys.update(((intr_next, b), (intr_next, b * 2)))

    def _bucket_at(self, intr):
        """At the first step of new intrinsics, move onto the smallest
        bucket recorded for them if it is larger (JAX trainer.py:527-539);
        record this step's own pair."""
        if intr != self._last_intr:
            cand = [b for i, b in self._bucket_keys if i == intr]
            if cand and min(cand) > self.dup_bucket:
                self.dup_bucket = min(cand)
            self._last_intr = intr
        self._bucket_keys.add((intr, self.dup_bucket))

    # ---- host loop ----
    def _batch_tensors(self, batch: Dict[str, np.ndarray]):
        return {k: torch.as_tensor(v, dtype=torch.float32,
                                   device=self.device)
                for k, v in batch.items()}

    def train_step(self, step: int) -> Dict[str, torch.Tensor]:
        """One training step on ``grad_accum`` batches of sampled poses."""
        with profiling.span("step", step):
            with profiling.span("cameras"):
                self.data.update(step)
                intr = self.data.intrinsics()
                self._bucket_at(intr)
                sched = self.sched_scalars(step)
                batches = [self.data.get_batch()
                           for _ in range(self.cfg.grad_accum)]
                if self.data_mesh is not None:
                    batches = [shard_batch(b, self.data_mesh)
                               for b in batches]
                batches = [self._batch_tensors(b) for b in batches]
            # the move penalty's reference: the means before the previous
            # update
            mean = self.state.scene.params["mean"]
            prev_mean = self._prev_mean
            if prev_mean is None or prev_mean.shape != mean.shape:
                prev_mean = mean
            metrics = self._train_step(batches, sched, intr, prev_mean)
            self._prev_mean = mean
            # bucket feedback every 10 steps: int() waits for the device;
            # under data_mesh, n_dup_max is already the max over the data
            # ranks, so every rank moves to the same bucket
            if self.cfg.auto_dup_bucket and step % 10 == 0:
                with profiling.span("sync"):
                    n_dup_max = int(metrics["n_dup_max"])
                self._bucket_feedback(step, intr, n_dup_max)
        return metrics

    def density_step(self, step: int) -> Dict[str, Any]:
        """The densify and prune events due at ``step``; their counts as
        ints.  Only the scene fields' Adam moments change: the bg and
        ``gp/`` moments are left alone."""
        info: Dict[str, Any] = {}
        due_d = should_run(step, self.dcfg.enabled, self.dcfg.warm_up,
                           self.dcfg.end, self.dcfg.period)
        due_p = should_run(step, self.pcfg.enabled, self.pcfg.warm_up,
                           self.pcfg.end, self.pcfg.period)
        if not (due_d or due_p):
            return info
        with profiling.span("density"):
            opt = self.state.opt
            fields = present_fields(self.state.scene.params)
            scene_opt = AdamState(mu={k: opt.mu[k] for k in fields},
                                  nu={k: opt.nu[k] for k in fields},
                                  count=opt.count)
            scene = self.state.scene
            if due_d:
                scene, scene_opt, dinfo = densify(
                    scene, scene_opt, self.dcfg, self.rcfg, self.generator)
                info.update(dinfo)
            if due_p:
                scene, scene_opt, pinfo = prune(
                    scene, scene_opt, self.pcfg, self.rcfg,
                    C(self.pcfg.radii2d_thresh, step),
                    C(self.pcfg.alpha_thresh, step))
                info.update(pinfo)
            if self.data_mesh is not None:
                # the ranks drew apart: data rank 0's event for all of them
                scene, scene_opt = replicate((scene, scene_opt),
                                             self.data_mesh, "data")
            opt = AdamState(mu={**opt.mu, **scene_opt.mu},
                            nu={**opt.nu, **scene_opt.nu}, count=opt.count)
            self.state = dataclasses.replace(self.state, scene=scene,
                                             opt=opt)
            with profiling.span("sync"):
                return {k: int(v) for k, v in info.items()}

    def fit(self, n_steps: Optional[int] = None,
            callback: Optional[Callable[[int, Dict], None]] = None):
        """``n_steps`` more steps, or by default up to ``cfg.max_steps``
        in total (a resumed trainer continues, it does not restart)."""
        start = self.state.step
        n = (n_steps if n_steps is not None
             else max(self.cfg.max_steps - start, 0))
        eval_rng = np.random.default_rng(self.cfg.seed + 1)
        prof = self.cfg.profile_steps
        trace = None
        try:
            for step in range(start, start + n):
                if prof is not None and step == int(prof[0]):
                    trace = self._start_trace(int(prof[0]), int(prof[1]))
                metrics = self.train_step(step)
                dinfo = self.density_step(step)
                if trace is not None and step + 1 == int(prof[1]):
                    self._stop_trace(trace)
                    trace = None
                if callback is not None:
                    callback(step, {**metrics, **dinfo})
                if self.logger is not None:
                    self._periodic_logging(step, metrics, eval_rng)
        finally:
            if trace is not None:
                self._stop_trace(trace)
        return self.state

    def _start_trace(self, a: int, b: int):
        """Enter a profiler trace of steps [a, b) written under the run
        directory's ``profile/`` (``./profile`` without a logger)."""
        from ..utils import profiling
        logdir = (self.logger.dir / "profile" if self.logger is not None
                  else "profile")
        trace = profiling.trace(logdir, f"steps_{a}_{b}",
                                cuda=self.device.type == "cuda")
        trace.__enter__()
        return trace

    def _stop_trace(self, trace):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        trace.__exit__(None, None, None)

    def _periodic_logging(self, step: int, metrics: Dict,
                          eval_rng: np.random.Generator):
        """Scalars, field statistics, the eval image, the orbit video, the
        guidance sample and a checkpoint, each on its period (0 turns it
        off); the video, the sample and the checkpoint not at step 0."""
        from ..io.checkpoint import save_checkpoint
        from ..utils.profiling import field_stats
        from .evaluation import eval_image, eval_video
        cfg = self.cfg
        log = self.logger
        if step % cfg.log_period == 0:
            m = {k: float(v) for k, v in metrics.items() if v.dim() == 0}
            m["num_gaussians"] = int(self.state.scene.active.sum())
            m.update(self.sched_scalars(step))
            log.log_scalars(step, m)
        if cfg.field_stats_period and step % cfg.field_stats_period == 0:
            log.log_scalars(step, field_stats(self.state.scene.params))
        intr = self.data.intrinsics()
        if cfg.eval_image_period and step % cfg.eval_image_period == 0:
            log.log_image(step, "eval/image", eval_image(
                self.state.scene, intr, self.rcfg, eval_rng,
                cfg.eval_elevation, cfg.eval_camera_distance))
        if cfg.eval_video_period and step % cfg.eval_video_period == 0 \
                and step > 0:
            log.log_video(step, "eval/orbit", eval_video(
                self.state.scene, intr, self.rcfg, cfg.eval_n_frames,
                elevation=cfg.eval_elevation,
                camera_distance=cfg.eval_camera_distance))
        if cfg.guidance_eval_period and step % cfg.guidance_eval_period == 0 \
                and step > 0:
            img = self._guidance_sample(step)
            if img is not None:
                log.log_image(step, "eval/guidance_sample", img)
        if cfg.save_period and step % cfg.save_period == 0 and step > 0:
            save_checkpoint(log.ckpt_dir, step, self.state, seed=cfg.seed)

    def _guidance_sample(self, step: int, **draws) -> Optional[np.ndarray]:
        """One CFG sample of the guidance's scheduler at a front-ish pose
        (elevation 15, azimuth 30, distance 2.5) as [H, W, 3] in [0, 1],
        drawn from a generator seeded from (seed + 7, step); ``draws``
        (``x``, ``noise``) replace those draws.  None where the guidance
        has no sampler (mock guidance) or no prompt."""
        if not hasattr(self.guidance, "sample") \
                or self.prompt_processor is None:
            return None
        dev = self.device
        gen = torch.Generator(device=dev).manual_seed(
            ((self.cfg.seed + 7) << 32) + step)
        pose = [torch.tensor([v], device=dev) for v in (15.0, 30.0, 2.5)]
        with torch.no_grad():
            img = self.guidance.sample(
                self.prompt_processor(), *pose, generator=gen,
                num_steps=self.cfg.guidance_eval_steps, **draws)
        return np.clip(img[0].float().cpu().numpy(), 0.0, 1.0)
