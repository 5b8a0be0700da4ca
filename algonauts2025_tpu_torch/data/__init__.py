"""Batch type and device placement of the port."""

from .dataset import SegmentData, to_device

__all__ = ["SegmentData", "to_device"]
