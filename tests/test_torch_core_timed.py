"""The port's twin of tests/test_core_timed.py: the same cases over the copies
in algonauts2025_tpu_torch.

TimedArray / Frequency semantics (mirrors reference base.py behavior)."""

import numpy as np
import pytest

from algonauts2025_tpu_torch.core import Frequency, TimedArray


def test_frequency_roundtrip():
    f = Frequency(2.0)
    assert f.to_ind(1.49) == 3
    assert f.to_ind(0.24) == 0
    # round-half-EVEN (np.round / Python round — the reference base.py:50
    # convention): .5 boundaries go to the even index
    assert f.to_ind(0.25) == 0  # round(0.5) = 0
    assert f.to_ind(0.75) == 2  # round(1.5) = 2
    assert f.to_ind(1.25) == 2  # round(2.5) = 2
    assert f.to_sec(4) == 2.0
    arr = np.array([0.0, 0.5, 1.0])
    np.testing.assert_array_equal(f.to_ind(arr), [0, 1, 2])


def test_timed_array_empty_accumulator():
    ta = TimedArray(frequency=2.0, start=0.0, duration=5.0)
    assert ta.data.shape == (0, 10)
    assert ta.duration == 5.0


def test_timed_array_static():
    ta = TimedArray(frequency=0.0, start=1.0, duration=2.0, data=np.ones(3))
    assert ta.duration == 2.0
    sub = ta.overlap(1.5, 1.0)
    assert sub is not None
    assert sub.start == 1.5
    assert sub.duration == 1.0


def test_overlap_slice_basic():
    data = np.arange(20, dtype=float).reshape(2, 10)
    ta = TimedArray(frequency=2.0, start=10.0, data=data)
    sub = ta.overlap(11.0, 2.0)
    assert sub is not None
    assert sub.start == 11.0
    assert sub.data.shape == (2, 4)
    np.testing.assert_array_equal(sub.data[0], [2, 3, 4, 5])


def test_overlap_none_when_disjoint():
    ta = TimedArray(frequency=2.0, start=0.0, data=np.zeros((1, 4)))
    assert ta.overlap(10.0, 1.0) is None


def test_overlap_touching_windows():
    ta = TimedArray(frequency=2.0, start=0.0, data=np.zeros((1, 4)))
    # zero-width touch between two non-empty windows -> None
    assert ta.overlap(2.0, 1.0) is None
    # zero-duration query at boundary -> minimum one timepoint
    sub = ta.overlap(1.0, 0.0)
    assert sub is not None
    assert sub.data.shape[-1] == 1


def test_min_one_timepoint_clamp():
    ta = TimedArray(frequency=2.0, start=0.0, data=np.arange(4.0)[None])
    sub = ta.overlap(1.9, 0.05)
    assert sub is not None
    assert sub.data.shape[-1] == 1


def test_iadd_sum():
    out = TimedArray(frequency=2.0, start=0.0, duration=4.0, aggregation="sum")
    a = TimedArray(frequency=2.0, start=0.0, data=np.ones((3, 4)))
    b = TimedArray(frequency=2.0, start=1.0, data=2 * np.ones((3, 4)))
    out += a
    out += b
    # first 2 cols: only a; next 4: a+b then b
    np.testing.assert_array_equal(out.data[0], [1, 1, 3, 3, 2, 2, 0, 0])


def test_iadd_average_streaming():
    out = TimedArray(frequency=1.0, start=0.0, duration=4.0, aggregation="average")
    a = TimedArray(frequency=1.0, start=0.0, data=np.full((1, 4), 2.0))
    b = TimedArray(frequency=1.0, start=0.0, data=np.full((1, 4), 4.0))
    c = TimedArray(frequency=1.0, start=0.0, data=np.full((1, 4), 6.0))
    for x in (a, b, c):
        out += x
    np.testing.assert_allclose(out.data, np.full((1, 4), 4.0))


def test_iadd_static_onto_grid():
    # a static (frequency=0) word embedding accumulated onto a 2 Hz grid
    out = TimedArray(frequency=2.0, start=0.0, duration=3.0)
    word = TimedArray(frequency=0.0, start=1.0, duration=0.5, data=np.ones(5))
    out += word
    assert out.data.shape == (5, 6)
    # word covers [1.0, 1.5) -> index 2
    assert out.data[0, 2] == 1.0
    assert out.data[0].sum() == 1.0


def test_iadd_frequency_mismatch_raises():
    out = TimedArray(frequency=2.0, start=0.0, duration=100.0)
    other = TimedArray(frequency=3.0, start=0.0, data=np.ones((1, 300)))
    with pytest.raises(ValueError):
        out += other


def test_iadd_near_frequency_tolerated():
    out = TimedArray(frequency=2.0, start=0.0, duration=1.0)
    other = TimedArray(frequency=2.001, start=0.0, data=np.ones((1, 2)))
    out += other  # small drift over short duration is fine
    assert out.data.sum() > 0


def test_bad_duration_raises():
    with pytest.raises(ValueError):
        TimedArray(frequency=2.0, start=0.0, duration=-1.0, data=np.ones((1, 2)))
    with pytest.raises(ValueError):
        TimedArray(frequency=2.0, start=0.0, duration=10.0, data=np.ones((1, 2)))
