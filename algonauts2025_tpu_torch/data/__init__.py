"""The data layer of the port: studies, enhancers, batches and their
host-to-device copy."""

from .dataset import SegmentData, SegmentDataset, prefetch_to_device, to_device

__all__ = ["SegmentData", "SegmentDataset", "prefetch_to_device", "to_device"]
