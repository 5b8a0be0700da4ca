from .timed import Frequency, TimedArray
from .events import (
    Event,
    EventTypesHelper,
    BaseDataEvent,
    BaseSplittableEvent,
    Image,
    Sound,
    Video,
    Text,
    Sentence,
    Word,
    Phoneme,
    Fmri,
)
from .segments import (
    HEMODYNAMIC_LAG,
    WINDOW_SECONDS,
    Segment,
    SegmentCreator,
    iter_segments,
    list_segments,
    validate_events,
    find_enclosed,
    find_overlap,
)
from .splitting import DeterministicSplitter, chunk_events
