"""Nested config dict with dotted-key access and uid derivation.

Replaces the exca.ConfDict surface the reference relies on for config
overrides and cache identity (reference grids/test_run.py:38-41 uses
``ConfDict(cfg).update({"infra.cluster": None})``; run_grid uses
``ConfDict(params).to_uid()`` for job folder names, modeling_utils/utils.py:127).
"""

from __future__ import annotations

import hashlib
import logging
import math
import typing as tp

import numpy as np

__all__ = ["ConfDict"]

logger = logging.getLogger(__name__)


def _flatten(data: tp.Mapping[str, tp.Any], prefix: str = "") -> dict[str, tp.Any]:
    out: dict[str, tp.Any] = {}
    for k, v in data.items():
        key = f"{prefix}{k}"
        if isinstance(v, tp.Mapping):
            sub = _flatten(v, prefix=f"{key}.")
            if sub:
                out.update(sub)
            else:
                out[key] = {}
        else:
            out[key] = v
    return out


def _to_uid_value(v: tp.Any) -> str:
    if isinstance(v, float):
        if math.isfinite(v) and v == int(v) and abs(v) < 1e12:
            return str(int(v))
        return f"{v:g}"  # inf/nan format fine; int() on them would raise
    if isinstance(v, (list, tuple, np.ndarray)):
        return "[" + ",".join(_to_uid_value(x) for x in v) + "]"
    if v is None:
        return "None"
    out = str(v)
    for char in " /\\\n\t#":
        out = out.replace(char, "")
    return out


class ConfDict(dict):
    """A nested dict; keys containing '.' address sub-dictionaries."""

    def __init__(self, data: tp.Mapping[str, tp.Any] | None = None, **kwargs: tp.Any):
        super().__init__()
        merged: dict[str, tp.Any] = {}
        if data:
            merged.update(data)
        merged.update(kwargs)
        for k, v in merged.items():
            self[k] = v

    def __setitem__(self, key: str, value: tp.Any) -> None:
        if isinstance(key, str) and "." in key:
            first, rest = key.split(".", 1)
            sub = super().setdefault(first, ConfDict())
            if not isinstance(sub, ConfDict):
                if isinstance(sub, dict):
                    sub = ConfDict(sub)
                    super().__setitem__(first, sub)
                else:
                    raise TypeError(f"Cannot set {key!r}: {first!r} is not a dict")
            sub[rest] = value
            return
        if isinstance(value, dict) and not isinstance(value, ConfDict):
            value = ConfDict(value)
        super().__setitem__(key, value)

    def __getitem__(self, key: str) -> tp.Any:
        if isinstance(key, str) and "." in key:
            first, rest = key.split(".", 1)
            return super().__getitem__(first)[rest]
        return super().__getitem__(key)

    def __contains__(self, key: object) -> bool:
        try:
            self[key]  # type: ignore[index]
            return True
        except (KeyError, TypeError):
            return False

    def update(self, other: tp.Mapping[str, tp.Any] | None = None, **kw: tp.Any) -> None:  # type: ignore[override]
        items: dict[str, tp.Any] = {}
        if other:
            items.update(other)
        items.update(kw)
        for k, v in items.items():
            if isinstance(v, tp.Mapping) and k in self and isinstance(self.get(k.split(".")[0]), dict):
                # deep-merge nested mappings
                for fk, fv in _flatten({k: v}).items():
                    if isinstance(fv, tp.Mapping) and not fv and fk in self:
                        # merging an EMPTY mapping into an existing subtree
                        # is a no-op (e.g. a grid entry with no infra
                        # overrides) — assigning would wipe the subtree.
                        # Logged because an update INTENDED to clear the
                        # section is otherwise ignored without any signal
                        # (ADVICE r3 #4; clear explicitly with `del` or by
                        # assigning the new subtree directly)
                        logger.debug(
                            "ConfDict.update: empty mapping for %r left the "
                            "existing subtree unchanged",
                            fk,
                        )
                        continue
                    self[fk] = fv
            else:
                self[k] = v

    def flat(self) -> dict[str, tp.Any]:
        return _flatten(self)

    def to_uid(self, max_len: int = 160) -> str:
        """A filesystem-safe uid string: sorted key=value pairs (+hash if long)."""
        flat = self.flat()
        parts = [f"{k}={_to_uid_value(v)}" for k, v in sorted(flat.items())]
        uid = ",".join(parts)
        if len(uid) > max_len or any(c in uid for c in "/\\"):
            h = hashlib.sha256(uid.encode()).hexdigest()[:10]
            uid = uid[: max_len - 11].replace("/", "") + "-" + h
        return uid

    def to_dict(self) -> dict[str, tp.Any]:
        out: dict[str, tp.Any] = {}
        for k, v in self.items():
            out[k] = v.to_dict() if isinstance(v, ConfDict) else v
        return out
