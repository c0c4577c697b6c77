"""Flax parameter trees -> PyTorch state dicts (diffusers key names).

The name-mapping half of the JAX package's ``guidance/convert.py``,
copied into the port so that the port can take the JAX package's
parameters (as numpy arrays) without importing it:

* flax path component ``name_N`` (a list entry) <-> torch ``name.N``,
  except ATOMIC names that contain ``_<digit>`` (``linear_1``, ...);
* leaf transforms: conv ``kernel`` [kh, kw, I, O] -> ``weight``
  [O, I, kh, kw]; dense ``kernel`` [I, O] -> ``weight`` [O, I]; norm
  ``scale`` -> ``weight``; biases as they are;
* and back (:func:`torch_key_to_flax_path`, :func:`to_flax_leaf`), for the
  checkpoints that the JAX package reads: a 2-D or 4-D ``weight`` is a
  kernel, a 1-D one a norm scale (no embedding table is a trainable leaf).

:func:`load_safetensors` reads ``.safetensors`` files with a reader of the
port's own (``json``, numpy and torch; the ``safetensors`` package is not a
dependency): one file, or every file of a directory in sorted order, so
that a sharded checkpoint merges.  :func:`read_state_dict` reads a state
dict from such a file or directory, or from a ``.pt`` file (torch's own
reader, tensors only).  :func:`load_state` fills a module whose names are
the torch state dict's (the Point-E models, DPT, the CLIP towers) from
such a dict of tensors or numpy arrays; :func:`load_template` fills one
with the JAX loader's template rule (``torch_state_to_flax``): leaves that
pretrained checkpoints lack by construction (LoRA, the class embedding)
keep their value, every other key must be there with the module's shape.
:func:`as_tensors` brings a flat dict of arrays (e.g. the JAX
``MockImageEncoder``'s ``w`` and ``pool``) across as tensors.
"""

from __future__ import annotations

import json
import os
import re
import struct
from pathlib import Path
from typing import Callable, Dict, Iterable, Mapping, Optional, Tuple

import numpy as np
import torch

# flax attribute names that contain "_<digit>" but are single torch
# names, not list entries
ATOMIC = ("linear_1", "linear_2", "wi_0", "wi_1", "conv_shortcut",
          "ln_1", "ln_2")

_LIST_RE = re.compile(r"^(.*)_(\d+)$")


def flax_name_to_torch(name: str) -> str:
    """``down_blocks_0`` -> ``down_blocks.0`` (ATOMIC names kept)."""
    if name in ATOMIC:
        return name
    parts = []
    while True:
        m = _LIST_RE.match(name)
        if m is None or name in ATOMIC:
            break
        parts.append(m.group(2))
        name = m.group(1)
    return ".".join([name] + list(reversed(parts)))


def flax_path_to_torch_key(path: Tuple[str, ...]) -> Tuple[str, str]:
    """flax param path -> (torch key, leaf kind); kinds: kernel | scale |
    bias | embedding | raw."""
    *mods, leaf = path
    prefix = ".".join(flax_name_to_torch(p) for p in mods)
    if leaf == "kernel":
        return f"{prefix}.weight", "kernel"
    if leaf in ("scale", "weight"):
        return f"{prefix}.weight", "scale"
    if leaf == "embedding":
        return f"{prefix}.weight", "embedding"
    if leaf == "bias":
        return f"{prefix}.bias", "bias"
    return (f"{prefix}.{leaf}" if prefix else leaf), "raw"


def to_torch_leaf(kind: str, arr: np.ndarray) -> np.ndarray:
    """A flax leaf in torch's layout."""
    if kind == "kernel":
        if arr.ndim == 4:               # flax conv [kh, kw, I, O]
            return np.transpose(arr, (3, 2, 0, 1))
        if arr.ndim == 2:               # flax dense [I, O]
            return np.transpose(arr, (1, 0))
        raise ValueError(f"kernel with ndim {arr.ndim}")
    return arr


def torch_key_to_flax_path(key: str, ndim: int) -> Tuple[Tuple[str, ...],
                                                        str]:
    """torch key -> (flax param path, leaf kind); the inverse of
    :func:`flax_path_to_torch_key` for kernels, scales and biases."""
    *mods, leaf = key.split(".")
    names = []
    for p in mods:
        if p.isdigit() and names:
            names[-1] = f"{names[-1]}_{p}"
        else:
            names.append(p)
    if leaf == "weight":
        kind = "kernel" if ndim in (2, 4) else "scale"
        return tuple(names) + (kind,), kind
    if leaf == "bias":
        return tuple(names) + ("bias",), "bias"
    return tuple(names) + (leaf,), "raw"


def to_flax_leaf(kind: str, arr: np.ndarray) -> np.ndarray:
    """A torch leaf in flax's layout (the inverse of :func:`to_torch_leaf`)."""
    if kind == "kernel":
        if arr.ndim == 4:               # torch conv [O, I, kh, kw]
            return np.transpose(arr, (2, 3, 1, 0))
        return np.transpose(arr, (1, 0))
    return arr


def flat_paths(tree: Mapping, prefix: Tuple[str, ...] = ()
               ) -> Dict[Tuple[str, ...], np.ndarray]:
    """Leaves of a nested mapping, keyed by their path of names."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(flat_paths(v, prefix + (str(k),)))
        else:
            out[prefix + (str(k),)] = np.asarray(v)
    return out


def flax_to_torch_state(params: Mapping) -> Dict[str, np.ndarray]:
    """A flax param tree (numpy leaves; a ``"params"`` root is stripped)
    in torch state-dict layout."""
    if set(params) == {"params"}:
        params = params["params"]
    out = {}
    for path, leaf in flat_paths(params).items():
        key, kind = flax_path_to_torch_key(path)
        out[key] = np.ascontiguousarray(to_torch_leaf(kind, leaf))
    return out


# safetensors dtype -> the little-endian numpy type its bytes are read as;
# BF16 is read as 16-bit integers and viewed as torch.bfloat16 (numpy has
# no bf16)
_SAFETENSORS_DTYPES = {"F32": ("<f4", None), "F16": ("<f2", None),
                       "BF16": ("<i2", torch.bfloat16),
                       "I64": ("<i8", None), "I32": ("<i4", None)}


def _read_safetensors_file(path: str) -> Dict[str, torch.Tensor]:
    """One ``.safetensors`` file: an 8-byte little-endian header length, a
    JSON header (name -> dtype, shape, data_offsets; ``__metadata__``
    skipped), then the tensors' raw little-endian bytes.  Tensors come in
    the order of their names, as the ``safetensors`` package lists them
    (the Shap-E decoder slices its latent in key order)."""
    out = {}
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        header.pop("__metadata__", None)
        for name in sorted(header):
            meta = header[name]
            if meta["dtype"] not in _SAFETENSORS_DTYPES:
                raise ValueError(
                    f"{path}: tensor {name!r} has dtype {meta['dtype']}; "
                    f"the reader takes {sorted(_SAFETENSORS_DTYPES)}")
            np_dtype, view = _SAFETENSORS_DTYPES[meta["dtype"]]
            begin, end = meta["data_offsets"]
            arr = np.empty(int(np.prod(meta["shape"])), np_dtype)
            if end - begin != arr.nbytes:
                raise ValueError(f"{path}: tensor {name!r} holds "
                                 f"{end - begin} bytes, its shape needs "
                                 f"{arr.nbytes}")
            f.seek(8 + n + begin)
            if f.readinto(memoryview(arr).cast("B")) != arr.nbytes:
                raise ValueError(f"{path}: truncated at tensor {name!r}")
            t = torch.from_numpy(arr).reshape(meta["shape"])
            out[name] = t if view is None else t.view(view)
    return out


def load_safetensors(path) -> Dict[str, torch.Tensor]:
    """Every tensor of one ``.safetensors`` file, or of every
    ``*.safetensors`` file in a directory in sorted order (sharded
    checkpoints merge), as CPU torch tensors in the file's dtype (F32,
    F16, BF16, I64, I32)."""
    path = str(path)
    files = []
    if os.path.isdir(path):
        files = [os.path.join(path, name) for name in sorted(os.listdir(path))
                 if name.endswith(".safetensors")]
    elif os.path.exists(path):
        files = [path]
    if not files:
        raise FileNotFoundError(
            f"no .safetensors found at {path!r}; this environment has no "
            "network egress — provision diffusers/transformers weights "
            "locally (e.g. unet/diffusion_pytorch_model.safetensors).")
    out = {}
    for f in files:
        out.update(_read_safetensors_file(f))
    return out


def strip_prefix(state: Mapping, prefix: str) -> Dict:
    """Drop e.g. ``text_model.`` from transformers checkpoint keys."""
    return {k[len(prefix):] if k.startswith(prefix) else k: v
            for k, v in state.items()}


def read_state_dict(path_or_state) -> Mapping:
    """A state dict as it is, or read from a ``.safetensors`` file or a
    directory of them (:func:`load_safetensors`), or from a file that
    ``torch.save`` wrote (``torch.load(weights_only=True)``, onto the
    CPU)."""
    if isinstance(path_or_state, Mapping):
        return path_or_state
    path = Path(path_or_state)
    if path.suffix == ".safetensors" or path.is_dir():
        return load_safetensors(path)
    return torch.load(path, map_location="cpu", weights_only=True)


def as_tensors(arrays: Mapping, device=None) -> Dict[str, torch.Tensor]:
    """A flat dict of tensors or arrays as tensors (copies of numpy
    arrays), on ``device`` if given."""
    out = {}
    for k, v in arrays.items():
        v = v if torch.is_tensor(v) else torch.from_numpy(np.array(v))
        out[k] = v if device is None else v.to(device)
    return out


def load_state(module: torch.nn.Module, path_or_state,
               drop: Optional[Callable[[str], bool]] = None
               ) -> torch.nn.Module:
    """Fill ``module`` from a torch-layout state dict (or a file of one,
    :func:`read_state_dict`) without the keys ``drop(key)`` selects; every
    other key must match a parameter or buffer by name and shape."""
    state = {k: v for k, v in read_state_dict(path_or_state).items()
             if drop is None or not drop(k)}
    module.load_state_dict(as_tensors(state), strict=True)
    return module


# leaves that pretrained checkpoints lack by construction: LoRA adapters
# and the (camera / noise-level) class embedding
TEMPLATE_SKIP = ("lora", "class_embedding")


def load_template(module: torch.nn.Module, path_or_state,
                  skip: Iterable[str] = TEMPLATE_SKIP) -> torch.nn.Module:
    """Fill ``module`` from a torch-layout state dict (or a file of one)
    as the JAX package's ``torch_state_to_flax`` fills its template: a
    parameter whose name has a part containing one of ``skip`` keeps its
    value; every other one must be in the state dict with the module's
    shape; a key of the state dict that fills nothing raises.  Values are
    converted to the module's dtype."""
    state = as_tensors(read_state_dict(path_or_state))
    new, missing = {}, []
    for key, have in module.state_dict().items():
        if any(s in part for s in skip for part in key.split(".")):
            continue
        if key not in state:
            missing.append(key)
            continue
        v = state[key]
        if tuple(v.shape) != tuple(have.shape):
            raise ValueError(f"shape mismatch for {key}: checkpoint "
                             f"{tuple(v.shape)} vs model {tuple(have.shape)}")
        new[key] = v
    unexpected = sorted(set(state) - set(new))
    if missing or unexpected:
        raise KeyError(
            f"state_dict mismatch: {len(missing)} missing {missing[:8]}..., "
            f"{len(unexpected)} unexpected {unexpected[:8]}...")
    module.load_state_dict(new, strict=False)
    return module
