"""Config-hash identity for caches and tasks.

The reference derives cache identity from pydantic config contents with
per-class exclusions so that e.g. ``device`` or ``layers`` changes don't
invalidate feature caches (reference features/text.py:153-158,
audio.py:200-205, video.py:169-170, neuro.py:110-113).  This module
provides the same contract for the TPU build.
"""

from __future__ import annotations

import hashlib
import json
import math
import typing as tp

import pydantic

__all__ = ["config_uid", "dump_for_uid"]


def _normalize(value: tp.Any) -> tp.Any:
    if isinstance(value, dict):
        return {str(k): _normalize(v) for k, v in sorted(value.items())}
    if isinstance(value, (list, tuple)):
        return [_normalize(v) for v in value]
    if isinstance(value, float):
        if not math.isfinite(value):
            return repr(value)  # 'inf'/'nan': json-safe and deterministic
        if value == int(value) and abs(value) < 1e12:
            return int(value)  # 2.0 and 2 are the same config value
        return value
    if isinstance(value, pydantic.BaseModel):
        return _normalize(value.model_dump())
    return value


def _convert_field(model: pydantic.BaseModel, name: str, value: tp.Any) -> tp.Any:
    """json-mode value for one field, recursing into live submodels so
    their own uid exclusions apply (a flat model_dump would flatten them
    first and silently skip every nested hook)."""
    if isinstance(value, pydantic.BaseModel):
        return dump_for_uid(value)
    if isinstance(value, (list, tuple)) and any(
        isinstance(v, pydantic.BaseModel) for v in value
    ):
        return [
            dump_for_uid(v) if isinstance(v, pydantic.BaseModel) else _normalize(v)
            for v in value
        ]
    if isinstance(value, dict) and any(
        isinstance(v, pydantic.BaseModel) for v in value.values()
    ):
        return {
            str(k): (
                dump_for_uid(v) if isinstance(v, pydantic.BaseModel) else _normalize(v)
            )
            for k, v in value.items()
        }
    # plain leaf: let pydantic handle json conversion (Paths, enums, ...)
    return model.model_dump(mode="json", include={name}).get(name)


def dump_for_uid(
    model: pydantic.BaseModel, exclude: tp.Collection[str] = ()
) -> dict[str, tp.Any]:
    """Field dump with exclusions applied, plus instance/class-level
    ``_exclude_from_cache_uid`` / ``_exclude_from_cls_uid`` hooks —
    applied RECURSIVELY: nested configs keep their own exclusion contract
    (a nested feature's ``device``/``batch_size`` must not invalidate the
    parent experiment's cache), and ``infra`` placement is dropped at
    every level (reference exca contract)."""
    excluded = set(exclude)
    hook = getattr(model, "_exclude_from_cache_uid", None)
    if callable(hook):
        excluded.update(hook())
    cls_hook = getattr(type(model), "_exclude_from_cls_uid", None)
    if callable(cls_hook):
        excluded.update(cls_hook())
    excluded.add("infra")  # infra placement never affects results
    data = {
        name: _convert_field(model, name, getattr(model, name))
        for name in type(model).model_fields
        if name not in excluded and not _is_default(model, name)
    }
    return _normalize(data)


def _is_default(model: pydantic.BaseModel, name: str) -> bool:
    """True when the field currently holds its default VALUE.

    Default-valued fields are dropped from the uid dump (the reference's
    exca contract — see the ``exclude_defaults`` serializer branch in
    reference enhancers.py:73): adding a new config field with a default
    must not invalidate every existing cache, and explicitly passing the
    default is identical to omitting it.  The ``name`` discriminator is
    always kept — nested features of different classes must never collapse
    onto the same uid just because their other fields coincide."""
    if name == "name":
        return False
    field = type(model).model_fields[name]
    if field.is_required():
        return False
    try:
        default = field.get_default(call_default_factory=True)
        value = getattr(model, name)
        if isinstance(value, pydantic.BaseModel) and isinstance(
            default, pydantic.BaseModel
        ):
            # compare UNDER the exclusion contract: a nested model differing
            # only in its own uid-excluded fields (e.g. a feature's
            # `device`) is still "default" for cache identity
            return dump_for_uid(value) == dump_for_uid(default)
        return bool(value == default)
    except Exception:
        return False


def config_uid(
    model: pydantic.BaseModel,
    exclude: tp.Collection[str] = (),
    version: str = "",
) -> str:
    """Stable short uid for a pydantic config."""
    data = dump_for_uid(model, exclude)
    payload = json.dumps({"cfg": data, "version": version}, sort_keys=True, default=str)
    name = type(model).__name__
    return f"{name}-{hashlib.sha256(payload.encode()).hexdigest()[:16]}"
