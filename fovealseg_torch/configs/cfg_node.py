"""Minimal YACS-compatible config node (the port's own copy).

The reference drives everything through a ``yacs.config.CfgNode`` singleton
with ``merge_from_file`` (yaml) and ``merge_from_list`` (CLI dotlist)
overrides. This is a dependency-free copy of the slice of that surface the
JAX package implements in ``fovealseg_tpu/configs/cfg_node.py``, so the same
config files and dotlists load into the port.
"""

from __future__ import annotations

import ast
import copy
from typing import Any, Dict, List


def _literal(value: str) -> Any:
    """Parse a CLI/yaml string the way YACS does (python literal, else str)."""
    if not isinstance(value, str):
        return value
    try:
        return ast.literal_eval(value)
    except (ValueError, SyntaxError):
        return value


def _coerce(old: Any, new: Any, key: str) -> Any:
    """Coerce ``new`` onto the type of ``old`` with YACS's tolerances."""
    if old is None:
        return new
    if isinstance(new, str):
        new = _literal(new)
    if isinstance(old, tuple) and isinstance(new, list):
        new = tuple(new)
    elif isinstance(old, list) and isinstance(new, tuple):
        new = list(new)
    if isinstance(old, bool) and isinstance(new, int) and not isinstance(new, bool):
        new = bool(new)
    elif isinstance(old, float) and isinstance(new, int):
        new = float(new)
    elif isinstance(old, int) and isinstance(new, float) and not isinstance(old, bool):
        # keep float (yacs would raise; we stay permissive like the reference usage)
        pass
    if type(old) is not type(new) and not isinstance(old, CfgNode):
        ok = (isinstance(old, (int, float)) and isinstance(new, (int, float))) or (
            isinstance(old, (list, tuple)) and isinstance(new, (list, tuple))
        )
        if not ok:
            raise TypeError(
                f"Type mismatch for key {key}: {type(old).__name__} vs {type(new).__name__}"
            )
    return new


class CfgNode(dict):
    """dict with attribute access + yaml/dotlist merging (YACS work-alike)."""

    IMMUTABLE = "__immutable__"

    def __init__(self, init: Dict[str, Any] | None = None):
        super().__init__()
        object.__setattr__(self, CfgNode.IMMUTABLE, False)
        if init:
            for k, v in init.items():
                self[k] = CfgNode(v) if isinstance(v, dict) else v

    # -- attribute access ----------------------------------------------------
    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        if getattr(self, CfgNode.IMMUTABLE):
            raise AttributeError(f"CfgNode is frozen; cannot set {name}")
        self[name] = value

    # -- lifecycle -----------------------------------------------------------
    def clone(self) -> "CfgNode":
        return copy.deepcopy(self)

    def freeze(self) -> None:
        object.__setattr__(self, CfgNode.IMMUTABLE, True)
        for v in self.values():
            if isinstance(v, CfgNode):
                v.freeze()

    def defrost(self) -> None:
        object.__setattr__(self, CfgNode.IMMUTABLE, False)
        for v in self.values():
            if isinstance(v, CfgNode):
                v.defrost()

    # -- merging -------------------------------------------------------------
    def merge_from_other_cfg(self, other: Dict[str, Any]) -> None:
        for k, v in other.items():
            if k not in self:
                raise KeyError(f"Non-existent config key: {k}")
            if isinstance(self[k], CfgNode):
                if not isinstance(v, dict):
                    raise TypeError(f"Cannot merge non-dict into group {k}")
                self[k].merge_from_other_cfg(v)
            else:
                self[k] = _coerce(self[k], v, k)

    def merge_from_file(self, path: str) -> None:
        import yaml

        with open(path, "r") as f:
            loaded = yaml.safe_load(f) or {}
        self.merge_from_other_cfg(loaded)

    def merge_from_list(self, dotlist: List[Any]) -> None:
        if len(dotlist) % 2 != 0:
            raise ValueError("Override list must have even length: KEY VALUE pairs")
        for key, value in zip(dotlist[0::2], dotlist[1::2]):
            node: "CfgNode" = self
            parts = key.split(".")
            for p in parts[:-1]:
                if p not in node:
                    raise KeyError(f"Non-existent config key: {key}")
                node = node[p]
            leaf = parts[-1]
            if leaf not in node:
                raise KeyError(f"Non-existent config key: {key}")
            node[leaf] = _coerce(node[leaf], value, key)

    # -- dumping ---------------------------------------------------------------
    def to_dict(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        for k, v in self.items():
            out[k] = v.to_dict() if isinstance(v, CfgNode) else v
        return out

    def dump(self) -> str:
        import yaml

        def _plain(d):
            if isinstance(d, dict):
                return {k: _plain(v) for k, v in d.items()}
            if isinstance(d, tuple):
                return list(d)
            return d

        return yaml.safe_dump(_plain(self.to_dict()), sort_keys=False)
