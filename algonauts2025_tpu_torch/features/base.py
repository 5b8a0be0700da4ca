"""Shared feature-extractor machinery.

Every feature follows the reference contract (e.g. features/audio.py:59-120):
``prepare(events)`` bulk-computes + caches per-event arrays, and
``__call__(events, start, duration)`` pools cached arrays onto the output
time grid via TimedArray overlap-add.  The reference repeats this logic in
each feature; here it lives once.

The device boundary: ``_get_data`` may run a frozen backbone on the device
named by ``device`` (batched, bf16); everything in ``__call__`` is
host-side NumPy on cached arrays, so the training input pipeline never
touches the backbone.  ``device="auto"`` means the CUDA card
(``runtime.default_device``), and raises where there is none.
"""

from __future__ import annotations

import typing as tp

import numpy as np
import pydantic
import torch

from ..cache.map_runner import CachedMap, MapInfra
from ..core.events import Event, EventTypesHelper
from ..core.timed import Frequency, TimedArray
from ..ops.layer_agg import aggregate_layers
from ..runtime import default_device

__all__ = ["FeatureBase", "MapInfra"]


class FeatureBase(pydantic.BaseModel):
    """Base for pooled features with per-item caching."""

    model_config = pydantic.ConfigDict(protected_namespaces=(), extra="forbid")

    infra: MapInfra = MapInfra()
    device: tp.Literal["auto", "cpu", "cuda"] = "auto"

    #: event type consumed (subclasses override)
    event_type: tp.ClassVar[str] = "Event"
    #: output grid frequency (Hz); 0 = static
    frequency: tp.ClassVar[float] = 2.0

    _missing_default: np.ndarray | None = pydantic.PrivateAttr(default=None)
    _event_types_helper: EventTypesHelper = pydantic.PrivateAttr()
    _cached_map: CachedMap | None = pydantic.PrivateAttr(default=None)
    #: True when the feature built its own backbone lazily (vs an injected
    #: one via set_backbone) — only owned backbones are released
    _backbone_owned: bool = pydantic.PrivateAttr(default=False)

    def model_post_init(self, _ctx: tp.Any) -> None:
        super().model_post_init(_ctx)
        self._event_types_helper = EventTypesHelper(self.event_type)

    # -- subclass hooks ---------------------------------------------------
    @staticmethod
    def item_uid(event: Event) -> str:
        raise NotImplementedError

    def _compute(self, events: tp.Sequence[Event]) -> tp.Iterable[np.ndarray]:
        """Bulk-compute arrays for events (cache misses only)."""
        raise NotImplementedError

    def _get_timed_arrays(
        self, events: list[Event], start: float, duration: float
    ) -> tp.Iterable[TimedArray]:
        raise NotImplementedError

    @classmethod
    def _exclude_from_cls_uid(cls) -> list[str]:
        return ["device"]

    def _exclude_from_cache_uid(self) -> list[str]:
        return ["device"]

    def torch_device(self) -> torch.device:
        """Where the backbone runs: ``"auto"`` is the CUDA card."""
        return default_device(None if self.device == "auto" else self.device)

    # -- caching ----------------------------------------------------------
    def _get_data(self, events: tp.Sequence[Event]) -> list[np.ndarray]:
        if self._cached_map is None:
            self._cached_map = CachedMap(
                infra=self.infra,
                owner=self,
                method_name="_get_data",
                fn=self._compute,
                item_uid=type(self).item_uid,
            )
        return self._cached_map(list(events))

    def release_backbone(self) -> None:
        """Drop a lazily-built backbone's reference (and with it its device
        params — after a cold prepare the three frozen backbones hold ~10 GB
        of device memory that training needs).  Backbones injected via set_backbone
        belong to the caller and are kept.  Purely a memory operation: a
        later cache miss transparently rebuilds the identical backbone (HF
        weights by name, or the seeded tiny-random)."""
        if self._backbone_owned and getattr(self, "_backbone", None) is not None:
            self._backbone = None
            self._backbone_owned = False

    # -- public API -------------------------------------------------------
    def prepare(self, obj: tp.Any) -> None:
        from ..data import helpers

        events = helpers.extract_events(obj, types=self._event_types_helper)
        if events:
            self._get_data(events)
            self(
                events[0],
                start=events[0].start,
                duration=0.001,
                trigger=events[0].to_dict(),
            )

    def __call__(
        self,
        events: tp.Any,
        start: float,
        duration: float,
        trigger: tp.Any = None,
    ) -> np.ndarray:
        from ..data import helpers

        assert duration >= 0.0, f"{duration} must be >= 0."
        input_events = events
        events = helpers.extract_events(events, types=self._event_types_helper)

        if not events:
            if self._missing_default is None:
                found = {type(e).__name__ for e in input_events} if isinstance(input_events, (list, tuple)) else set()
                raise ValueError(
                    f"No {self.event_type} events found for feature "
                    f"{type(self).__name__} (types found: {found}) and feature "
                    'shape not populated (call "prepare" on the feature first).'
                )
            default = self._missing_default
            freq = Frequency(self.frequency)
            if freq:
                n_times = max(1, freq.to_ind(duration))
                default = np.repeat(default[..., None], n_times, axis=-1)
            return default

        tarrays = list(
            self._get_timed_arrays(events=events, start=start, duration=duration)
        )
        out = TimedArray(
            aggregation="sum",
            start=start,
            frequency=self.frequency,
            duration=duration,
        )
        for ta in tarrays:
            out += ta
        result = np.asarray(out.data)
        if not result.ndim:
            result = result[None]
        if self._missing_default is None:
            shape = result.shape[:-1] if self.frequency else result.shape
            self._missing_default = np.zeros(shape, dtype=result.dtype)
        return result


class LayeredFeatureBase(FeatureBase):
    """A frozen backbone's layer stack as a feature: fractional-layer
    selection (layers / layer_aggregation), the backbone built on first use
    from ``model_name`` (or injected with ``set_backbone``), and the per-event
    (L+1, D, T) latents pooled onto the output grid."""

    layers: list[float] = [0.5, 0.75, 1.0]
    layer_aggregation: tp.Optional[tp.Literal["group_mean"]] = "group_mean"

    #: names the backbone in the error of a named model that cannot be read
    modality: tp.ClassVar[str] = "feature"
    #: the per-event latents span the event's duration rather than their
    #: own length (the JAX package's VJEPA2 does, its Wav2VecBert does not)
    latents_span_event: tp.ClassVar[bool] = False

    _backbone: tp.Any = pydantic.PrivateAttr(default=None)

    def _exclude_from_cache_uid(self) -> list[str]:
        return ["device", "layers", "layer_aggregation"]

    def _aggregate_layers(self, latents: np.ndarray) -> np.ndarray:
        return aggregate_layers(latents, self.layers, self.layer_aggregation)

    # -- the backbone -----------------------------------------------------
    def _tiny_backbone(self, device: torch.device) -> tp.Any:
        """The seeded small backbone of ``model_name="tiny-random"``."""
        raise NotImplementedError

    def _named_backbone(self, device: torch.device) -> tp.Any:
        """The backbone of the named model, read from local files only."""
        raise NotImplementedError

    def set_backbone(self, backbone: tp.Any) -> None:
        self._backbone = backbone
        self._backbone_owned = False

    @property
    def backbone(self) -> tp.Any:
        if self._backbone is None:
            device = self.torch_device()
            if self.model_name == "tiny-random":  # type: ignore[attr-defined]
                self._backbone = self._tiny_backbone(device)
            else:
                try:
                    self._backbone = self._named_backbone(device)
                except Exception as e:
                    # never substitute random weights for a named model: the
                    # cache is keyed by this config's uid, so a fallback
                    # would poison it
                    raise RuntimeError(
                        f"Could not load {self.modality} backbone {self.model_name!r}; "  # type: ignore[attr-defined]
                        "refusing to substitute random weights under the same "
                        "cache identity (use model_name='tiny-random' for "
                        "offline runs)"
                    ) from e
            self._backbone_owned = True
        return self._backbone

    def _get_timed_arrays(
        self, events: list[Event], start: float, duration: float
    ) -> tp.Iterable[TimedArray]:
        """Each event's latents cut to [start, start + duration) (an empty
        slice at the event's start where they miss it), layers aggregated."""
        for event, latent in zip(events, self._get_data(events)):
            tdata = TimedArray(
                data=np.asarray(latent),
                frequency=self.frequency,
                start=event.start,
                duration=event.duration if self.latents_span_event else None,
            )
            sub = tdata.overlap(start=start, duration=duration)
            if sub is None:
                sub = tdata.overlap(start=tdata.start, duration=0)
            sub.data = self._aggregate_layers(sub.data)
            yield sub
