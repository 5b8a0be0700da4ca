"""Auto-generate pydantic config classes from callables.

The port's copy of algonauts2025_tpu/config/builders.py (it imports no
JAX, but the port keeps its own copy).  Equivalent of the reference's
``convert_to_pydantic`` (reference modeling_utils/utils.py:22-66):
introspects an ``__init__`` signature and emits a config model with a
``build()`` method, used to expose user-defined losses/metrics/modules
through the same discriminated-union config surface as the built-ins.
"""

from __future__ import annotations

import inspect
import typing as tp

from pydantic import BaseModel, Field, create_model

__all__ = ["convert_to_pydantic", "all_subclasses", "validate_kwargs"]


def convert_to_pydantic(
    class_to_convert: type,
    name: str,
    parent_class: tp.Any = None,
    exclude_from_build: list[str] | None = None,
) -> type[BaseModel]:
    """Build a pydantic config class mirroring ``class_to_convert.__init__``."""
    sig = inspect.signature(class_to_convert.__init__)
    empty = inspect.Parameter.empty
    fields = {
        k: (
            v.annotation if v.annotation != empty else tp.Any,
            v.default if v.default != empty else ...,
        )
        for k, v in sig.parameters.items()
        if k != "self" and not k.startswith("_")
        and v.kind not in (v.VAR_POSITIONAL, v.VAR_KEYWORD)
    }
    assert "name" not in fields, "target __init__ may not define 'name'"

    Builder = create_model(
        name,
        name=(tp.Literal[name], Field(default=name)),
        __base__=parent_class,
        **fields,
    )
    Builder._cls = class_to_convert
    excluded = set(exclude_from_build or [])

    def build_method(instance: BaseModel, **extra: tp.Any):
        params = {
            field: getattr(instance, field)
            for field in type(instance).model_fields
            if field != "name" and field not in excluded
        }
        return instance._cls(**params, **extra)

    Builder.build = build_method
    return Builder


def all_subclasses(cls: type) -> set[type]:
    subs = set(cls.__subclasses__())
    return subs | {s for c in subs for s in all_subclasses(c)}


def validate_kwargs(fn: tp.Callable, kwargs: dict[str, tp.Any]) -> None:
    """Raise if kwargs don't bind to fn's signature (exca.helpers parity)."""
    sig = inspect.signature(fn)
    params = sig.parameters
    has_var_kw = any(p.kind == p.VAR_KEYWORD for p in params.values())
    for key in kwargs:
        if key not in params and not has_var_kw:
            raise ValueError(
                f"Invalid kwarg {key!r} for {getattr(fn, '__name__', fn)}; "
                f"valid: {sorted(k for k in params if k != 'self')}"
            )
