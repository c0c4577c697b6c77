"""Checkpoint save / load / resume.

Port of the JAX package's ``io/checkpoint.py``.  A checkpoint is a
directory

  step_N/
    arrays.npz   every array of the train state, under the key paths that
                 the JAX package's ``_flatten_with_paths`` writes:
                 ``.scene/.params/.mean`` (and ``.specular`` / ``.normal``
                 of a PBR scene), ``.scene/.active``, the densify
                 statistics, ``.bg/['name']``, ``.gp/['name']``,
                 ``.opt/.mu/[0]/.mean``, ``.opt/.mu/[1]/['name']`` (bg),
                 ``.opt/.mu/[2]/['name']`` (gp), the same for ``.nu``,
                 ``.opt/.count``, ``.key``, ``.step``
    meta.json    step, the config blob, the array keys

so each package resumes from the other's checkpoints.  Raw
(pre-activation) fields are stored.  Guidance leaves go back to their flax
paths (``params/<module path>/kernel``) with kernels transposed, the
inverse of ``training/trainer.py::_gp_leaf``; plain names (the MockUNet
adapter's) stay as they are.  ``.opt/.count`` and ``.step`` are int32
scalars, as the JAX package writes them.

The port draws from a ``torch.Generator`` and carries no JAX PRNG key, but
the JAX package's ``load_checkpoint`` needs a ``.key`` leaf: the port writes
the layout of ``jax.random.PRNGKey(seed)``, uint32 ``[0, seed]``, from the
trainer's seed.  A JAX run resumed from it draws other numbers than a JAX
run would have; the port ignores the leaf on load.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import numpy as np

from ..guidance import convert
from ..models.scene import STATS, present_fields
from ..training.trainer import TrainState, train_state_from_jax_arrays


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy()


def _jax_gp_leaf(name: str, arr: np.ndarray) -> Tuple[str, np.ndarray]:
    """A port ``gp`` leaf under the JAX package's name and layout."""
    if "." not in name:
        return name, arr
    path, kind = convert.torch_key_to_flax_path(name, arr.ndim)
    return ("params/" + "/".join(path),
            np.ascontiguousarray(convert.to_flax_leaf(kind, arr)))


def state_arrays(state: TrainState, seed: int = 0) -> Dict[str, np.ndarray]:
    """The train state as the JAX package's flattened key paths, in its
    tree order (dict leaves sorted by name)."""
    scene = state.scene
    gp = {k: _jax_gp_leaf(k, _np(v)) for k, v in state.gp.items()}
    order = sorted(state.gp, key=lambda k: gp[k][0])
    fields = present_fields(scene.params)
    out = {f".scene/.params/.{f}": _np(scene.params[f]) for f in fields}
    out[".scene/.active"] = _np(scene.active)
    out.update({f".scene/.{s}": _np(getattr(scene, s)) for s in STATS})
    out.update({f".bg/['{k}']": _np(state.bg[k]) for k in sorted(state.bg)})
    out.update({f".gp/['{gp[k][0]}']": gp[k][1] for k in order})
    for m in ("mu", "nu"):
        mom = getattr(state.opt, m)
        out.update({f".opt/.{m}/[0]/.{f}": _np(mom[f]) for f in fields})
        out.update({f".opt/.{m}/[1]/['{k}']": _np(mom[f"bg/{k}"])
                    for k in sorted(state.bg)})
        out.update({f".opt/.{m}/[2]/['{gp[k][0]}']":
                    _jax_gp_leaf(k, _np(mom[f"gp/{k}"]))[1] for k in order})
    out[".opt/.count"] = np.asarray(state.opt.count, np.int32)
    out[".key"] = np.asarray([0, seed & 0xFFFFFFFF], np.uint32)
    out[".step"] = np.asarray(state.step, np.int32)
    return out


def save_checkpoint(ckpt_dir, step: int, state: TrainState,
                    config_blob: Optional[Dict] = None, seed: int = 0
                    ) -> str:
    """Write ``<ckpt_dir>/step_<N>/{arrays.npz, meta.json}``."""
    d = Path(ckpt_dir) / f"step_{step}"
    d.mkdir(parents=True, exist_ok=True)
    arrays = state_arrays(state, seed)
    np.savez(d / "arrays.npz", **arrays)
    meta = {"step": step, "keys": list(arrays), "config": config_blob or {}}
    (d / "meta.json").write_text(json.dumps(meta, indent=2, default=str))
    return str(d)


def _step_dir(path) -> Path:
    """A ``step_N`` directory, or the latest one under a ``ckpts`` dir."""
    d = Path(path)
    if (d / "arrays.npz").exists():
        return d
    latest = latest_checkpoint(d)
    if latest is None:
        raise FileNotFoundError(f"no checkpoints under {d}")
    return Path(latest)


def load_checkpoint(path, state_template: TrainState
                    ) -> Tuple[TrainState, int]:
    """Load a checkpoint of either package onto the device of
    ``state_template``, a freshly built state of the same config: every
    tensor must have the template's shape.  Returns (state, step)."""
    d = _step_dir(path)
    with np.load(d / "arrays.npz") as data:
        arrays = dict(data)
    meta = json.loads((d / "meta.json").read_text())
    device = state_template.scene.params["mean"].device
    state = train_state_from_jax_arrays(arrays, device)

    def tensors(s: TrainState) -> Dict[str, Any]:
        return {**{f"scene/{f}": v for f, v in s.scene.params.items()},
                "scene/active": s.scene.active,
                **{f"scene/{k}": getattr(s.scene, k) for k in STATS},
                **{f"bg/{k}": v for k, v in s.bg.items()},
                **{f"gp/{k}": v for k, v in s.gp.items()},
                **{f"mu/{k}": v for k, v in s.opt.mu.items()},
                **{f"nu/{k}": v for k, v in s.opt.nu.items()}}

    got, want = tensors(state), tensors(state_template)
    if set(got) != set(want):
        raise ValueError(f"{d}: leaves differ from the template: "
                         f"{sorted(set(got) ^ set(want))}")
    for k, v in want.items():
        if got[k].shape != v.shape:
            raise ValueError(f"shape mismatch for {k}: checkpoint "
                             f"{tuple(got[k].shape)} vs template "
                             f"{tuple(v.shape)}")
    return state, int(meta["step"])


def scene_arrays_from_checkpoint(path) -> Dict[str, np.ndarray]:
    """Raw scene fields of a checkpoint, compacted to its ACTIVE rows (the
    ``init.type=ckpt`` fresh-run path: a new run with another capacity,
    guidance or schedule starts from a trained scene).  Keys: mean, qvec,
    svec, color, alpha (+ specular / normal where the checkpoint has
    them)."""
    d = _step_dir(path)
    with np.load(d / "arrays.npz") as data:
        arrays = dict(data)

    def find(field):
        for key, arr in arrays.items():
            parts = [p.strip(".") for p in key.split("/")]
            if ("scene" in parts and parts[-1] == field
                    and ("params" in parts or field == "active")):
                return arr
        return None

    active = find("active")
    out = {}
    for field in ("mean", "qvec", "svec", "color", "alpha", "specular",
                  "normal"):
        arr = find(field)
        if arr is not None:
            out[field] = arr[active] if active is not None else arr
    if "mean" not in out:
        raise ValueError(f"{d} does not look like a trainer checkpoint "
                         "(no scene params)")
    return out


def latest_checkpoint(ckpt_dir) -> Optional[str]:
    d = Path(ckpt_dir)
    if not d.exists():
        return None
    steps = sorted(d.glob("step_*"), key=lambda p: int(p.name.split("_")[1]))
    return str(steps[-1]) if steps else None
