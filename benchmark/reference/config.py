"""The YAML configs merged as gsgen merges them: files deep-merged in
order, then ``dotted.key=value`` overrides with YAML-typed values."""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Iterable

import yaml


def deep_merge(base: Dict, over: Dict) -> Dict:
    out = dict(base)
    for k, v in over.items():
        out[k] = (deep_merge(out[k], v)
                  if isinstance(v, dict) and isinstance(out.get(k), dict)
                  else v)
    return out


def merged_config(paths: Iterable, overrides: Iterable[str] = ()) -> Dict:
    cfg: Dict = {}
    for p in paths:
        d = yaml.safe_load(Path(p).read_text()) or {}
        if d.get("include"):
            raise ValueError(f"{p}: the reference merges no include lists")
        cfg = deep_merge(cfg, d)
    for ov in overrides:
        key, _, raw = ov.partition("=")
        *head, last = key.split(".")
        cur = cfg
        for part in head:
            cur = cur.setdefault(part, {})
        cur[last] = yaml.safe_load(raw)
    return cfg
