"""Training orchestration: one text-to-3D training step, eagerly.

Port of the JAX package's ``training/trainer.py``.  A step runs in the
same order as the JAX package's jitted ``train_step``: backgrounds,
render, guidance, the sparsity / opague / z_var terms, penalties,
backward, per-field Adam, then the densify statistics (``grad_accum``,
``grad_cnt``, ``max_radii2d``); after the step, the densify and prune
events that are due (:mod:`..models.density`).  The host loop evaluates ``C()``
schedules, samples numpy camera poses and keeps the duplicate-capacity
bucket policy.  Eager PyTorch compiles nothing, so the JAX package's
compile-ahead threads have no counterpart.

Guidance is ``MockGuidance``, SDS (:mod:`..guidance.sds`) or VSD
(:mod:`..guidance.vsd`); the SD backbone freezes its own weights.  The
optimizer's leaves are the scene fields, the background (``bg/<name>``)
and the guidance's trainable leaves (``gp/<name>``: VSD's LoRA and camera
embedding, at ``lr_guidance``).

With a ``logger`` (:class:`..io.logging.RunLogger`), ``fit`` logs scalars,
field statistics, eval images and orbit videos and saves checkpoints on
the JAX package's periods; :meth:`Trainer.load` resumes from a checkpoint
of either package (:mod:`..io.checkpoint`).

Not ported yet (``NotImplementedError``): DeepFloyd guidance, estimators,
image-to-3D, auxiliary guidance.  Guidance samples
(``guidance_eval_period``) and trace capture (``profile_steps``) are
accepted and not written.
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
from ..models.scene import (FIELDS, RenderConfig, SceneState,
                            render_batch, scene_from_numpy)
from ..utils.schedule import C, make_lr_schedule
from .losses import PENALTIES
from .optimizer import AdamState, adam_init, adam_update


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
    """Same keys as the JAX package's TrainerConfig; ``guidance_eval_*``
    and ``profile_steps`` are accepted and have no effect here."""

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

    scene = scene_from_numpy(
        {**{f: field(".scene/.params", f) for f in FIELDS},
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
                                  device=device) for f in FIELDS}
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
                 device="cuda", logger: Optional[Any] = None):
        if cfg.estimators:
            raise NotImplementedError("estimators")
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
        self.logger = logger
        self.data = CameraPoseProvider(data_cfg, seed=cfg.seed)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(cfg.seed)

        scene = initialize(init_cfg, rcfg, self.generator, self.device,
                           points=init_points, colors=init_colors,
                           raw_values=init_raw)
        bg = init_background(bg_cfg, self.device)
        gp = {k: v.detach().clone() for k, v in getattr(
            self.guidance, "trainable_params", {}).items()}
        self.state = TrainState(
            scene=scene, bg=bg, gp=gp,
            opt=adam_init(_opt_params(scene.params, bg, gp)), step=0)
        self.lr_fns = {k: make_lr_schedule(v, cfg.max_steps)
                       for k, v in cfg.lr.items()}
        self.dup_bucket = rcfg.dup_cap
        self._shrink_streak = 0

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
        return s

    def _effective_rcfg(self) -> RenderConfig:
        if self.dup_bucket == self.rcfg.dup_cap:
            return self.rcfg
        return dataclasses.replace(self.rcfg, dup_cap=self.dup_bucket)

    def _loss(self, params, bg, gp, taps, batch, sched, intr, rcfg):
        cfg = self.cfg
        B = batch["c2w"].shape[0]
        bgs = torch.stack([apply_background(bg, self.bg_cfg, self.generator,
                                            self.device, training=True)
                           for _ in range(B)])
        if not cfg.use_bg:
            bgs = torch.zeros_like(bgs)
        outs = render_batch(params, self.state.scene.active, batch["c2w"],
                            intr, rcfg, bgs, batch["fx"], batch["fy"],
                            batch["cx"], batch["cy"], rgb_only=cfg.rgb_only,
                            mean2d_taps=taps)
        embedding = (self.prompt_processor()
                     if self.prompt_processor is not None else None)
        g = self.guidance.loss(outs["rgb"], embedding, batch["elevation"],
                               batch["azimuth"], batch["camera_distance"],
                               generator=self.generator, sched=sched,
                               c2ws=batch["c2w"], train=gp)
        loss = sched["w_sds"] * g.get("loss_sds", 0.0)
        if "loss_vsd" in g:
            loss = loss + sched["w_vsd"] * g["loss_vsd"]
        if "loss_lora" in g:
            loss = loss + sched["w_lora"] * g["loss_lora"]
        metrics = dict(g)
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
            pen = PENALTIES[name](params, self.state.scene.active, cfg=rcfg,
                                  kind=p.get("type", "center_weighted"))
            loss = loss + sched[f"w_pen_{name}"] * pen
            metrics[f"pen_{name}"] = pen
        metrics["loss_total"] = loss
        metrics["n_dup_max"] = torch.amax(outs["n_dup"])
        return loss, outs, metrics

    def _train_step(self, batches, sched, intr):
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
        gsum = {k: torch.zeros_like(v) for k, v in leaves.items()}
        tap_grads, vis_list, radii_list = [], [], []
        for batch in batches:
            B = batch["c2w"].shape[0]
            taps = torch.zeros(B, scene.params["mean"].shape[0], 2,
                               device=self.device, requires_grad=True)
            loss, outs, metrics = self._loss(params, bg, gp, taps, batch,
                                             sched, intr, rcfg)
            names = list(leaves)
            grads = torch.autograd.grad(
                loss, [leaves[k] for k in names] + [taps], allow_unused=True)
            for k, gr in zip(names, grads[:-1]):
                if gr is not None:
                    gsum[k] = gsum[k] + gr
            tap_grads.append(grads[-1])
            if not cfg.rgb_only:
                vis_list.append(outs["visible"])
                radii_list.append(outs["radii2d"].detach())
        grads = {k: v / A for k, v in gsum.items()}
        lrs = {k: sched[f"lr_{k}"] for k in scene.params}
        lrs.update({f"bg/{k}": sched["lr_bg"] for k in state.bg})
        lrs.update({f"gp/{k}": sched.get("lr_guidance", 1e-4)
                    for k in state.gp})
        new, opt = adam_update(grads, state.opt,
                               _opt_params(scene.params, state.bg, state.gp),
                               lrs)

        with torch.no_grad():
            tg = torch.cat(tap_grads, dim=0)                 # [A*B, M, 2]
            gnorm = torch.linalg.norm(tg, dim=-1)
            grad_accum = scene.grad_accum + torch.sum(gnorm, dim=0)
            if vis_list:
                vis = torch.cat(vis_list, dim=0)
                grad_cnt = scene.grad_cnt + torch.sum(vis, dim=0)
                r = torch.amax(torch.cat(radii_list, dim=0), dim=0)
                max_radii2d = torch.maximum(scene.max_radii2d, r)
            else:
                grad_cnt = scene.grad_cnt + torch.sum(gnorm > 0, dim=0)
                max_radii2d = scene.max_radii2d
        new_scene = SceneState(
            params={k: new[k] for k in scene.params}, active=scene.active,
            max_radii2d=max_radii2d, grad_accum=grad_accum,
            grad_cnt=grad_cnt.to(torch.float32))
        new_bg = {k: new[f"bg/{k}"] for k in state.bg}
        new_gp = {k: new[f"gp/{k}"] for k in state.gp}
        self.state = TrainState(scene=new_scene, bg=new_bg, gp=new_gp,
                                opt=opt, step=state.step + 1)
        return {k: v.detach() for k, v in metrics.items()}

    def _adjust_dup_bucket(self, n_dup_max: int):
        """Grow on (near-)overflow, shrink after 20 undersubscribed
        feedback events in a row."""
        cap = self.dup_bucket
        if n_dup_max > 0.7 * cap:
            self.dup_bucket = cap * 2
            self._shrink_streak = 0
        elif n_dup_max < 0.15 * cap and cap > self.cfg.dup_bucket_min:
            self._shrink_streak += 1
            if self._shrink_streak >= 20:
                self.dup_bucket = cap // 2
                self._shrink_streak = 0
        else:
            self._shrink_streak = 0

    # ---- host loop ----
    def _batch_tensors(self, batch: Dict[str, np.ndarray]):
        return {k: torch.as_tensor(v, dtype=torch.float32,
                                   device=self.device)
                for k, v in batch.items()}

    def train_step(self, step: int) -> Dict[str, torch.Tensor]:
        """One training step on ``grad_accum`` batches of sampled poses."""
        self.data.update(step)
        intr = self.data.intrinsics()
        sched = self.sched_scalars(step)
        batches = [self.data.get_batch() for _ in range(self.cfg.grad_accum)]
        metrics = self._train_step([self._batch_tensors(b) for b in batches],
                                   sched, intr)
        # bucket feedback every 10 steps: int() waits for the device
        if self.cfg.auto_dup_bucket and step % 10 == 0:
            self._adjust_dup_bucket(int(metrics["n_dup_max"]))
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
        opt = self.state.opt
        scene_opt = AdamState(mu={k: opt.mu[k] for k in FIELDS},
                              nu={k: opt.nu[k] for k in FIELDS},
                              count=opt.count)
        scene = self.state.scene
        if due_d:
            scene, scene_opt, dinfo = densify(scene, scene_opt, self.dcfg,
                                              self.rcfg, self.generator)
            info.update(dinfo)
        if due_p:
            scene, scene_opt, pinfo = prune(
                scene, scene_opt, self.pcfg, self.rcfg,
                C(self.pcfg.radii2d_thresh, step),
                C(self.pcfg.alpha_thresh, step))
            info.update(pinfo)
        opt = AdamState(mu={**opt.mu, **scene_opt.mu},
                        nu={**opt.nu, **scene_opt.nu}, count=opt.count)
        self.state = dataclasses.replace(self.state, scene=scene, opt=opt)
        return {k: int(v) for k, v in info.items()}

    def fit(self, n_steps: Optional[int] = None,
            callback: Optional[Callable[[int, Dict], None]] = None):
        """``n_steps`` more steps, or by default up to ``cfg.max_steps``
        in total (a resumed trainer continues, it does not restart)."""
        start = self.state.step
        n = (n_steps if n_steps is not None
             else max(self.cfg.max_steps - start, 0))
        eval_rng = np.random.default_rng(self.cfg.seed + 1)
        for step in range(start, start + n):
            metrics = self.train_step(step)
            dinfo = self.density_step(step)
            if callback is not None:
                callback(step, {**metrics, **dinfo})
            if self.logger is not None:
                self._periodic_logging(step, metrics, eval_rng)
        return self.state

    def _periodic_logging(self, step: int, metrics: Dict,
                          eval_rng: np.random.Generator):
        """Scalars, field statistics, the eval image, the orbit video and
        a checkpoint, each on its period (0 turns it off); the video and
        the checkpoint not at step 0."""
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
        if cfg.save_period and step % cfg.save_period == 0 and step > 0:
            save_checkpoint(log.ckpt_dir, step, self.state, seed=cfg.seed)
