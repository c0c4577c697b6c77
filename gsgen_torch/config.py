"""Config system: YAML tree -> typed dataclass configs -> Trainer.

Port of the JAX package's ``config.py``: ``load_config`` reads a YAML
file, deep-merges its ``include:`` list and applies dotted CLI overrides
with YAML-typed values (``guidance.type=mock``); ``build_trainer`` wires
the subsystems the port has from the same ``configs/`` tree: guidance
``mock``, ``sds`` and ``vsd`` (on ``MockUNet`` or the SD UNet + VAE
backbone).
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

# init keys that configure priors of later slices (checkpoint paths,
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
    """PromptProcessor on ``device`` (mock embeddings until the CLIP/T5
    encoders are ported)."""
    pcfg = _from_dict(PromptProcessorConfig, prompt_d)
    return PromptProcessor(pcfg, encode_fn=build_encode_fn(pcfg.model_id),
                           device=device)


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
    from .guidance.sd_unet import (SD15, SD21, TINY, SDUNetBackbone,
                                   load_diffusers_weights)
    presets = {"tiny": TINY, "sd15": SD15, "sd21": SD21}
    if preset not in presets:
        raise NotImplementedError(f"backbone preset {preset}")
    if weights:
        load_diffusers_weights(weights)
    cfg = presets[preset]
    if vsd:
        cfg = dataclasses.replace(
            cfg, lora_rank=int(vsd["lora_rank"]),
            class_embed_proj_dim=int(vsd["camera_condition_dim"]))
    bb = SDUNetBackbone(cfg, latent_size=8 if preset == "tiny" else 64,
                        compute_dtype=dtype, device=device,
                        fp32_unet=bool(vsd))
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

    init_d = {k: v for k, v in cfg.get("init", {}).items()
              if k not in _INIT_PASSTHROUGH}
    init_cfg = _from_dict(InitConfig, init_d)

    g_d = dict(cfg.get("guidance", {}))
    g_type = g_d.pop("type", "mock")
    prompt_processor = None
    if g_type == "mock":
        # guidance.type=mock on a diffusion config leaves sds-only keys
        # behind; MockGuidance takes only its own
        guidance = MockGuidance(**{k: v for k, v in g_d.items()
                                   if k in ("mode", "color")})
    elif g_type == "sds":
        prompt_processor = _build_prompt_processor(
            dict(cfg.get("prompt", {})), device)
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
    for block in ("auxiliary", "image"):
        sub = cfg.get(block) or {}
        if sub.get("enabled") or sub.get("path"):
            raise NotImplementedError(block)
    return Trainer(cfg=tcfg, rcfg=rcfg, init_cfg=init_cfg, bg_cfg=bg_cfg,
                   data_cfg=data_cfg, guidance=guidance, dcfg=dcfg,
                   pcfg=pcfg, prompt_processor=prompt_processor,
                   device=device, logger=logger)
