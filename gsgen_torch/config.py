"""Config system: YAML tree -> typed dataclass configs -> Trainer.

Port of the JAX package's ``config.py``: ``load_config`` reads a YAML
file, deep-merges its ``include:`` list and applies dotted CLI overrides
with YAML-typed values (``guidance.type=mock``); ``build_trainer`` wires
the subsystems the port has from the same ``configs/`` tree: guidance
``mock``, ``sds``, ``vsd`` and ``deep_floyd`` / ``if`` (pixel-space SDS)
on ``MockUNet`` or the UNet backbone (SD with its VAE, or ``if_pixel``
without one; random, or from a diffusers directory at
``guidance.weights_path``), text encoders of a local directory at
``prompt.model_id``, the Point-E ``auxiliary`` guidance (text-conditioned
by ``clip_model_id``), the DPT ``estimators`` (top level or under
``trainer``), the inits ``base``, ``unisphere``, ``semisphere``, ``box``,
``unbounded``, ``ckpt``, ``point_cloud`` (from ``init_asset``), ``mesh``,
``point_e``, ``point_e_image`` and ``shap_e``, and image-to-3D: an
``image:`` block with a ``path`` (an 8-bit PNG) swaps in the single-view
camera sampler, the depth-lifted init with its gradient mask and the
original-view losses; a block without a path only configures.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Any, Dict, List, Optional

import yaml

from .data.cameras import CameraSamplerConfig
from .guidance.mock import MockGuidance
from .guidance.sds import SDSConfig, SDSGuidance
from .guidance.vsd import VSDConfig, VSDGuidance
from .models.background import BackgroundConfig
from .models.density import DensifyConfig, PruneConfig
from .models.init import InitConfig
from .models.scene import RenderConfig
from .prompt.encoders import build_encode_fn
from .prompt.processors import PromptProcessor, PromptProcessorConfig
from .training.trainer import LossConfig, Trainer, TrainerConfig
from .utils.precision import exact_fp32

# init keys that configure the priors (checkpoint paths, asset paths,
# sampler knobs); they ride the same `init:` block
_INIT_PASSTHROUGH = {
    "z_scale", "random_exceed", "seed", "point_e_base", "point_e_upsample",
    "clip_model_dir", "karras_steps", "shap_e_decoder", "shap_e_text300m",
    "shap_e_latent", "grid_size", "mesh", "flip_yz", "flip_xy", "ckpt_path",
    "image", "point_e_image_base", "clip_vision_dir"}


def _field_default(f: dataclasses.Field):
    if f.default is not dataclasses.MISSING:
        return f.default
    if f.default_factory is not dataclasses.MISSING:
        return f.default_factory()
    return None


def _from_dict(cls, d: Optional[Dict]) -> Any:
    """Build dataclass ``cls`` from a dict, recursing into dataclass
    fields; unknown keys are an error.  Lists become tuples where the
    field default is a tuple (frozen configs stay hashable)."""
    d = dict(d or {})
    fields = {f.name: f for f in dataclasses.fields(cls)}
    unknown = set(d) - set(fields)
    if unknown:
        raise KeyError(f"unknown {cls.__name__} keys: {sorted(unknown)}")
    kwargs = {}
    for name, val in d.items():
        default = _field_default(fields[name])
        if dataclasses.is_dataclass(default) and isinstance(val, dict):
            kwargs[name] = _from_dict(type(default), val)
        elif isinstance(val, list) and isinstance(default, tuple):
            kwargs[name] = tuple(tuple(v) if isinstance(v, list) else v
                                 for v in val)
        else:
            kwargs[name] = val
    return cls(**kwargs)


def set_dotted(d: Dict, key: str, value):
    parts = key.split(".")
    cur = d
    for p in parts[:-1]:
        cur = cur.setdefault(p, {})
    cur[parts[-1]] = value


def parse_override(s: str):
    """key=value with a YAML-typed value."""
    key, _, raw = s.partition("=")
    return key, yaml.safe_load(raw)


def deep_merge(base: Dict, over: Dict) -> Dict:
    """Recursive dict merge; ``over`` wins, nested dicts merge."""
    out = dict(base)
    for k, v in over.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = deep_merge(out[k], v)
        else:
            out[k] = v
    return out


def _resolve_include(name: str, rel_to: Path) -> Path:
    """An include names another config: relative to the including file's
    directory first, then the configs root (the nearest ancestor named
    ``configs``), then ``./configs``; ``.yaml`` is appended if missing."""
    cand = [name] if name.endswith(".yaml") else [name + ".yaml"]
    roots = [rel_to]
    for p in rel_to.parents:
        if p.name == "configs":
            roots.append(p)
            break
    else:
        roots.append(rel_to.parent if rel_to.name != "configs" else rel_to)
    roots.append(Path.cwd() / "configs")
    for root in roots:
        for c in cand:
            p = root / c
            if p.exists():
                return p
    raise FileNotFoundError(
        f"include '{name}' not found under {[str(r) for r in roots]}")


def _load_yaml_tree(path: Path, _seen=None) -> Dict:
    """Load one YAML file with its ``include:`` list merged in order;
    the file's own keys override its includes."""
    _seen = set() if _seen is None else _seen
    path = path.resolve()
    if path in _seen:
        raise ValueError(f"include cycle through {path}")
    _seen.add(path)
    cfg = yaml.safe_load(path.read_text()) or {}
    includes = cfg.pop("include", None) or []
    if isinstance(includes, str):
        includes = [includes]
    merged: Dict = {}
    for inc in includes:
        merged = deep_merge(merged, _load_yaml_tree(
            _resolve_include(inc, path.parent), _seen=set(_seen)))
    return deep_merge(merged, cfg)


def load_config(path, overrides: Optional[List[str]] = None) -> Dict:
    """One YAML file, or a list of them deep-merged in order (as an
    ``include:`` list merges), then the dotted overrides."""
    cfg: Dict = {}
    for one in ([path] if isinstance(path, (str, Path)) else path):
        cfg = deep_merge(cfg, _load_yaml_tree(Path(one)))
    for ov in overrides or []:
        k, v = parse_override(ov)
        set_dotted(cfg, k, v)
    return cfg


def _build_prompt_processor(prompt_d: Dict, device) -> PromptProcessor:
    """PromptProcessor on ``device``: the CLIP / T5 encoder of a local
    ``prompt.model_id`` directory, or mock embeddings."""
    pcfg = _from_dict(PromptProcessorConfig, prompt_d)
    return PromptProcessor(pcfg, encode_fn=build_encode_fn(
        pcfg.model_id, device=device), device=device)


def _build_backbone(g_d: Dict, device, vsd: Optional[Dict] = None):
    """Pop the backbone keys from the guidance block; None means the
    default, MockUNet.  ``vsd`` (lora_rank, camera_condition_dim) upgrades
    the UNet preset with LoRA adapters and a camera class embedding, and
    keeps the UNet in fp32 (the JAX VSD path applies it to the fp32
    masters; only the VAE runs in ``backbone_dtype``)."""
    kind = g_d.pop("backbone", "mock")
    preset = g_d.pop("backbone_preset", "tiny")
    weights = g_d.pop("weights_path", None)
    dtype = g_d.pop("backbone_dtype", None)
    # attention core: "auto" (K5 at the 4096-token level on the card) |
    # "on" | "off" -- see unet2d.set_fused_attention; YAML reads a bare
    # on / off as a boolean
    fused_attn = g_d.pop("fused_attention", "auto")
    fused_attn = {True: "on", False: "off"}.get(fused_attn, str(fused_attn))
    from .guidance.unet2d import FUSED_ATTENTION_MODES, set_fused_attention
    if fused_attn not in FUSED_ATTENTION_MODES:
        raise ValueError(f"fused attention mode {fused_attn!r}")
    if kind == "mock":
        return None
    if kind != "sd_unet":
        raise NotImplementedError(f"backbone {kind}")
    from .guidance.sd_unet import (IF_PIXEL, SD15, SD21, TINY,
                                   SDUNetBackbone, load_diffusers_weights)
    presets = {"tiny": TINY, "sd15": SD15, "sd21": SD21,
               "if_pixel": IF_PIXEL}
    if preset not in presets:
        raise NotImplementedError(f"backbone preset {preset}")
    cfg = presets[preset]
    if vsd:
        cfg = dataclasses.replace(
            cfg, lora_rank=int(vsd["lora_rank"]),
            class_embed_proj_dim=int(vsd["camera_condition_dim"]))
    # if_pixel: DeepFloyd's pixel space, no VAE
    kw = dict(latent_size=8 if preset == "tiny" else 64, compute_dtype=dtype,
              device=device, fp32_unet=bool(vsd), use_vae=preset != "if_pixel")
    bb = (load_diffusers_weights(weights, cfg, **kw) if weights
          else SDUNetBackbone(cfg, **kw))
    set_fused_attention(bb, fused_attn)
    return bb


def build_trainer(cfg: Dict, device="cuda", logger=None) -> Trainer:
    """Trainer for a loaded config, with its tensors on ``device`` and its
    periodic outputs going to ``logger`` (a ``RunLogger``; None writes
    nothing).  Sets the port's precision policy first (fp32 without TF32,
    ``utils/precision.py``)."""
    exact_fp32()
    rcfg_d = dict(cfg.get("renderer", {}))
    dcfg = _from_dict(DensifyConfig, rcfg_d.pop("densify", {}))
    pcfg = _from_dict(PruneConfig, rcfg_d.pop("prune", {}))
    bg_cfg = _from_dict(BackgroundConfig, rcfg_d.pop("background", {}))
    renderer_penalty = rcfg_d.pop("penalty", None)
    rcfg = _from_dict(RenderConfig, rcfg_d)

    tr_d = dict(cfg.get("trainer", {}))
    loss_d = tr_d.pop("loss", {})
    if "estimators" in cfg:
        tr_d.setdefault("estimators", cfg["estimators"])
    tcfg = _from_dict(TrainerConfig, tr_d)
    tcfg = dataclasses.replace(tcfg, loss=_from_dict(LossConfig, loss_d))
    if renderer_penalty is not None:
        tcfg = dataclasses.replace(tcfg, penalty=renderer_penalty)

    data_d = dict(cfg.get("data", {}))
    data_d.setdefault("batch_size", tcfg.batch_size)
    data_d.setdefault("max_steps", tcfg.max_steps)
    data_cfg = _from_dict(CameraSamplerConfig, data_d)

    init_d = dict(cfg.get("init", {}))
    init_extra = {k: init_d.pop(k) for k in list(init_d)
                  if k in _INIT_PASSTHROUGH}
    init_cfg = _from_dict(InitConfig, init_d)

    g_d = dict(cfg.get("guidance", {}))
    g_type = g_d.pop("type", "mock")
    prompt_processor = None
    if g_type == "mock":
        # guidance.type=mock on a diffusion config leaves sds-only keys
        # behind; MockGuidance takes only its own
        guidance = MockGuidance(**{k: v for k, v in g_d.items()
                                   if k in ("mode", "color")})
    elif g_type in ("sds", "deep_floyd", "if"):
        prompt_processor = _build_prompt_processor(
            dict(cfg.get("prompt", {})), device)
        if g_type != "sds":
            # DeepFloyd: SDS in pixel space at 64^2 with CFG 20
            g_d.setdefault("rgb_as_latents", True)
            g_d.setdefault("guidance_scale", 20.0)
        backbone = _build_backbone(g_d, device)
        guidance = SDSGuidance(_from_dict(SDSConfig, g_d), backbone,
                               device=device)
    elif g_type == "vsd":
        prompt_processor = _build_prompt_processor(
            dict(cfg.get("prompt", {})), device)
        backbone = _build_backbone(
            g_d, device, vsd={"lora_rank": g_d.get("lora_rank", 4),
                              "camera_condition_dim":
                                  g_d.get("camera_condition_dim", 16)})
        guidance = VSDGuidance(_from_dict(VSDConfig, g_d), backbone,
                               device=device)
    else:
        raise NotImplementedError(f"guidance type {g_type}")
    aux_guidance = _build_aux_guidance(
        dict(cfg.get("auxiliary") or {}), device,
        cfg.get("prompt", {}).get("prompt", ""))

    init_points = init_colors = init_raw = None
    if init_cfg.type == "ckpt":
        # a fresh run from a trained scene's raw fields (reference
        # from_ckpt, utils/initialize.py:335-356), not a resume
        from .io.checkpoint import scene_arrays_from_checkpoint
        init_raw = scene_arrays_from_checkpoint(init_extra["ckpt_path"])
    elif init_cfg.type == "point_e_image":
        # image-conditioned Point-E (reference point_e_image_initialize,
        # utils/initialize.py:410-439); facex is applied to the arrays
        from .priors import point_e_image_init_arrays
        image = init_extra.get("image") or (cfg.get("image") or {}).get(
            "path")
        if not image:
            raise ValueError("init.type=point_e_image needs init.image (or "
                             "image.path)")
        init_points, init_colors = point_e_image_init_arrays(
            image, num_points=init_cfg.num_points,
            mean_std=init_cfg.mean_std, facex=init_cfg.facex,
            seed=init_extra.get("seed", 0),
            base_weights=init_extra.get("point_e_image_base"),
            upsample_weights=init_extra.get("point_e_upsample"),
            clip_model_dir=init_extra.get("clip_vision_dir"),
            karras_steps=tuple(init_extra.get("karras_steps", (64, 64))),
            device=device)
        init_cfg = dataclasses.replace(init_cfg, type="point_cloud",
                                       facex=False)
    elif init_cfg.type in ("point_e", "shap_e"):
        # the generative priors at trainer init (reference
        # utils/initialize.py:110-228): the asset cache or the in-process
        # samplers, then a point_cloud init on those arrays
        prompt_text = cfg.get("prompt", {}).get("prompt", "")
        if init_cfg.type == "point_e":
            from .priors import point_e_init_arrays
            init_points, init_colors = point_e_init_arrays(
                prompt_text, num_points=init_cfg.num_points,
                mean_std=init_cfg.mean_std,
                z_scale=init_extra.get("z_scale", 1.0),
                random_exceed=init_extra.get("random_exceed", False),
                seed=init_extra.get("seed", 0),
                base_weights=init_extra.get("point_e_base"),
                upsample_weights=init_extra.get("point_e_upsample"),
                clip_model_dir=init_extra.get("clip_model_dir"),
                karras_steps=tuple(init_extra.get("karras_steps",
                                                  (64, 64))),
                device=device)
        else:
            from .priors import shap_e_init_arrays
            init_points, init_colors = shap_e_init_arrays(
                prompt_text, num_points=init_cfg.num_points,
                mean_std=init_cfg.mean_std,
                z_scale=init_extra.get("z_scale", 1.0),
                seed=init_extra.get("seed", 0),
                decoder_weights=init_extra.get("shap_e_decoder"),
                text_model_weights=init_extra.get("shap_e_text300m"),
                latent_path=init_extra.get("shap_e_latent"),
                clip_model_dir=init_extra.get("clip_model_dir"),
                grid_size=init_extra.get("grid_size", 128), device=device)
        if cfg.get("init", {}).get("random_color", False):
            init_colors = None       # random colours, only if set
        init_cfg = dataclasses.replace(init_cfg, type="point_cloud")
    elif init_cfg.type == "point_cloud":
        from .priors import load_point_cloud
        init_points, init_colors = load_point_cloud(cfg["init_asset"])
    elif init_cfg.type == "mesh":
        # area-weighted even surface samples (reference
        # mesh_initlization, utils/initialize.py:285-333)
        from .priors import mesh_init_arrays
        init_points, init_colors = mesh_init_arrays(
            init_extra["mesh"], num_points=init_cfg.num_points,
            mean_std=init_cfg.mean_std,
            flip_yz=init_extra.get("flip_yz", False),
            flip_xy=init_extra.get("flip_xy", False),
            seed=init_extra.get("seed", 0))
        init_cfg = dataclasses.replace(init_cfg, type="point_cloud")

    # image-to-3D; a block without a path (the data/sit3d.yaml preset's
    # original_view_prob) configures but does not switch it on
    img_d = cfg.get("image") or {}
    image = _image_mode(img_d, tcfg, init_cfg, rcfg, device) \
        if img_d.get("path") else {}
    trainer = Trainer(cfg=tcfg, rcfg=rcfg, init_cfg=init_cfg, bg_cfg=bg_cfg,
                      data_cfg=data_cfg, guidance=guidance, dcfg=dcfg,
                      pcfg=pcfg, init_points=init_points,
                      init_colors=init_colors, init_raw=init_raw,
                      prompt_processor=prompt_processor,
                      aux_guidance=aux_guidance, device=device,
                      logger=logger, **image.get("trainer_kw", {}))
    if image:
        from .data.cameras import SingleViewCameraPoseProvider
        from .training.optimizer import adam_init
        from .training.trainer import _opt_params
        scene = image["scene"]
        st = trainer.state
        trainer.state = dataclasses.replace(
            st, scene=scene,
            opt=adam_init(_opt_params(scene.params, st.bg, st.gp)))
        trainer.data = SingleViewCameraPoseProvider(
            data_cfg, seed=tcfg.seed,
            original_view_prob=float(img_d.get("original_view_prob", 0.5)))
    return trainer


def _image_mode(img_d: Dict, tcfg: TrainerConfig, init_cfg: InitConfig,
                rcfg: RenderConfig, device) -> Dict:
    """The ``image:`` block (reference sit3d mode, trainer.py:101-156):
    read ``path`` (an 8-bit PNG; an RGB one is matted unless
    ``auto_matte: false``), take its depth from ``depth`` (a ``.npy``),
    from DPT (``dpt_checkpoint``: recentred on the foreground mean, times
    ``depth_scale``, plus ``distance``) or ``default_depth``, and lift the
    front points from the front view (camera at +x, ``distance`` away).
    Returns the image init's ``scene`` and the Trainer's image keywords."""
    import numpy as np
    import torch

    from .io.logging import read_png
    from .ops.camera import CameraIntrinsics
    from .training.sit3d import ImageTarget, image_initialize

    rgba = read_png(img_d["path"]).astype(np.float32) / 255.0
    if rgba.shape[-1] != 4 and img_d.get("auto_matte", True):
        from .utils.matting import ensure_rgba
        rgba = ensure_rgba(rgba)
    rgb = np.ascontiguousarray(rgba[..., :3])
    mask = (rgba[..., 3] > 0.5 if rgba.shape[-1] == 4
            else np.ones(rgba.shape[:2], bool))
    distance = float(img_d.get("distance", 2.5))
    if img_d.get("depth"):
        depth = np.load(img_d["depth"]).astype(np.float32)
    elif img_d.get("dpt_checkpoint"):
        from .priors.dpt import DPTEstimator
        est = DPTEstimator.from_checkpoint(img_d["dpt_checkpoint"],
                                           mode="depth", device=device)
        with torch.no_grad():
            d = est(torch.as_tensor(rgb, device=device)[None])[0, ..., 0]
        d = d.cpu().numpy()
        depth = ((d - d[mask].mean()) * float(img_d.get("depth_scale", 100.0))
                 + distance).astype(np.float32)
        del est
    else:
        depth = np.full(rgb.shape[:2], float(img_d.get("default_depth", 2.5)),
                        np.float32)
    target = ImageTarget(image=torch.as_tensor(rgb, device=device),
                         depth=torch.as_tensor(depth, device=device),
                         mask=torch.as_tensor(mask, device=device))
    # the front view: camera at (distance, 0, 0) looking down -x
    c2w = torch.tensor([[0, 0, -1, distance], [1, 0, 0, 0], [0, -1, 0, 0]],
                       dtype=torch.float32, device=device)
    gen = torch.Generator(device=device).manual_seed(tcfg.seed)
    scene, gmask = image_initialize(
        init_cfg, rcfg, target, CameraIntrinsics.from_reso(rgb.shape[0]),
        c2w, gen, grad_mask=img_d.get("grad_mask", True))
    return dict(scene=scene, trainer_kw=dict(
        image_target=target, grad_mask=gmask,
        mask_steps=tuple(img_d.get("mask_steps", (0, 1000)))))


def _build_aux_guidance(aux_d: Dict, device, prompt: str):
    """The ``auxiliary`` block (reference conf/base.yaml:176-190): Point-E
    SDS on the Gaussian means, or None when it is not enabled.
    ``clip_model_id`` (a local CLIP directory) conditions it on the
    prompt's projected CLIP text vector."""
    if not aux_d.pop("enabled", False):
        return None
    aux_type = aux_d.pop("type", "point_e")
    if aux_type != "point_e":
        raise NotImplementedError(f"auxiliary type {aux_type}")
    clip_dir = aux_d.pop("clip_model_id", None)
    from .guidance.point_e_aux import PointEAuxConfig, PointEAuxGuidance
    acfg = _from_dict(PointEAuxConfig, aux_d)
    cond_vec = None
    if clip_dir:
        import torch

        from .prompt.encoders import build_clip_textvec_fn
        cond_vec = torch.as_tensor(build_clip_textvec_fn(
            clip_dir, device=device)([prompt])[0])
    return PointEAuxGuidance(acfg, device=device, cond_vec=cond_vec)
