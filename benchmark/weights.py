"""Random weights and the prompt's embedding bank, made from the seed.

:func:`make_weights` draws every leaf of the UNet and the VAE (diffusers
state-dict names, from the reference's module skeleton on the meta
device) from one ``torch.Generator`` on the device, one normal draw a
network in the type it is served in, then scales each leaf: kernels by
``1 / sqrt(fan_in)``, biases by 0.02, norm scales as ``1 + 0.1 z``.
LoRA ``up`` leaves take 0.01 so that every LoRA leaf has a gradient.  The
same seed gives the same weights, so the reference draws them again after
the window instead of keeping a second copy beside the program's.

:func:`mock_bank` is gsgen's mock text encoder (an md5 of the text seeds
a numpy normal draw of [77, width]) over the prompt's ten texts, at the
UNet's cross-attention width.
"""

from __future__ import annotations

import hashlib
import math
from typing import Dict, List

import numpy as np
import torch

from .reference.nets import UNet, VAE

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _trainable(key: str) -> bool:
    return any("lora" in p or p == "class_embedding" for p in key.split("."))


def _fill(shapes: Dict[str, torch.Size], gen, dtype, device):
    total = sum(math.prod(s) for s in shapes.values())
    flat = torch.randn(total, generator=gen, dtype=dtype, device=device)
    out, i = {}, 0
    for k, s in shapes.items():
        n = math.prod(s)
        z = flat[i:i + n].view(s)
        i += n
        leaf = k.rsplit(".", 1)[-1]
        if "lora" in k and k.endswith(".up.weight"):
            z.mul_(0.01)
        elif leaf == "weight" and len(s) >= 2:
            z.mul_(1.0 / math.sqrt(math.prod(s[1:])))
        elif leaf == "weight":
            z.mul_(0.1).add_(1.0)
        else:
            z.mul_(0.02)
        out[k] = z
    return out


def make_weights(unet_cfg: Dict, vae_cfg: Dict, seed: int, device,
                 dtypes: Dict[str, str], vsd: bool) -> Dict:
    """``{"unet": state, "vae": state}``; under VSD the UNet's state holds
    the LoRA and camera-embedding leaves too (fp32, the trained leaves)."""
    with torch.device("meta"):
        unet = UNet(unet_cfg, lora_rank=4 if vsd else 0,
                    class_embed_proj_dim=16 if vsd else None)
        vae = VAE(vae_cfg)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) * 4 + 1)
    sd_u = {k: v.shape for k, v in unet.state_dict().items()}
    out = {"unet": _fill({k: s for k, s in sd_u.items()
                          if not _trainable(k)}, gen,
                         DTYPES[dtypes["unet"]], device)}
    out["unet"].update(_fill({k: s for k, s in sd_u.items()
                              if _trainable(k)}, gen, torch.float32, device))
    out["vae"] = _fill({k: v.shape for k, v in vae.state_dict().items()},
                       gen, DTYPES[dtypes["vae"]], device)
    return out


def split_trainable(state: Dict) -> tuple:
    """(frozen leaves, LoRA and camera-embedding leaves)."""
    return ({k: v for k, v in state.items() if not _trainable(k)},
            {k: v for k, v in state.items() if _trainable(k)})


def prompt_texts(prompt: Dict) -> List[str]:
    """gsgen's ten texts: the prompt, the negative, the four view prompts
    (side, front, back, overhead) and the negative four times."""
    if prompt.get("use_prompt_debiasing") or any(
            prompt.get(k) for k in ("prompt_side", "prompt_back",
                                    "prompt_overhead")):
        raise ValueError("the benchmark's bank takes no debiasing or "
                         "per-view prompt overrides")
    p = prompt.get("prompt", "a corgi")
    neg = prompt.get("negative_prompt", "")
    if prompt.get("front_style", False):
        vd = [f"side view of {p}", f"front view of {p}",
              f"backside view of {p}", f"overhead view of {p}"]
    else:
        vd = [f"{p}, side view", f"{p}, front view", f"{p}, back view",
              f"{p}, overhead view"]
    return [p, neg] + vd + [neg] * 4


def mock_bank(prompt: Dict, width: int, device, length: int = 77
              ) -> Dict[str, torch.Tensor]:
    embs = []
    for t in prompt_texts(prompt):
        s = int(hashlib.md5(t.encode()).hexdigest()[:8], 16)
        embs.append(np.random.default_rng(s).standard_normal((length, width)))
    e = torch.as_tensor(np.stack(embs).astype(np.float32), device=device)
    return {"text": e[0], "uncond": e[1], "text_vd": e[2:6],
            "uncond_vd": e[6:10]}
