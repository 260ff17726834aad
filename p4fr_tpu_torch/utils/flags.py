"""YAML configuration -> attribute-access namespace, port of
``p4fr_tpu/utils/flags.py``.

Nested dicts become nested ``ConfigNode``s and string leaves are parsed
when they parse (``"5e-4"`` -> 5e-4, ``"[1,2]"`` -> a list) with
``ast.literal_eval`` and numeric parsing; ``to_dict`` gives the plain dict
back, which checkpoints embed. yaml is imported only to read a file: a
dict config needs none (the card's host has no yaml).
"""

from __future__ import annotations

import ast
import os
from typing import Any, Dict, Union


def _coerce(value: str) -> Any:
    """Best-effort parse of a string leaf; the string itself on failure."""
    try:
        return ast.literal_eval(value)
    except (ValueError, SyntaxError):
        pass
    try:
        return int(value)
    except ValueError:
        pass
    try:
        return float(value)
    except ValueError:
        return value


class ConfigNode:
    """Attribute namespace over a nested dict."""

    def __init__(self, d: Dict[str, Any]):
        object.__setattr__(self, "_raw", {})
        for k, v in d.items():
            if k == "prefix" and isinstance(v, str):
                v = os.path.join("./", v)
            if isinstance(v, dict):
                v = ConfigNode(v)
            elif isinstance(v, str):
                v = _coerce(v)
            self._raw[k] = v

    def __getattr__(self, name: str) -> Any:
        try:
            return self._raw[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        self._raw[name] = value

    def __contains__(self, name: str) -> bool:
        return name in self._raw

    def get(self, name: str, default: Any = None) -> Any:
        return self._raw.get(name, default)

    def keys(self):
        return self._raw.keys()

    def to_dict(self) -> Dict[str, Any]:
        return {k: v.to_dict() if isinstance(v, ConfigNode) else v
                for k, v in self._raw.items()}

    def __repr__(self) -> str:
        return f"ConfigNode({self._raw!r})"


class Flags:
    """Load a YAML file path or an already-parsed dict."""

    def __init__(self, config: Union[str, Dict[str, Any]]):
        if isinstance(config, str):
            import yaml

            with open(config, "r") as f:
                config = yaml.safe_load(f)
        self.flags = ConfigNode(config)

    def get(self) -> ConfigNode:
        return self.flags
