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

Reading safetensors is not ported: that package is not a dependency of
the port.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping, Tuple

import numpy as np

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
