"""Tracing."""

from .profiling import span, step_range, step_summary, trace

__all__ = ["span", "step_range", "step_summary", "trace"]
