"""Tracing and per-stage timing."""

from .profiling import StageTimer, step_range, step_summary, trace

__all__ = ["StageTimer", "step_range", "step_summary", "trace"]
