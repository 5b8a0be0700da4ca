"""The port's twin of tests/test_infra_units.py: the same cases over the copies
in algonauts2025_tpu_torch. The config-builder and profiling-timer cases
wait for their modules (ROADMAP queue 1 items 1 and 5).

Direct unit coverage for infra pieces otherwise only exercised through
the end-to-end suites: FrameStore, config builders, profiling timer."""

import time
import typing as tp

import numpy as np
import pandas as pd
import pytest


def test_frame_store_roundtrip(tmp_path):
    from algonauts2025_tpu_torch.cache.frame_store import FrameStore

    store = FrameStore(tmp_path / "frames")
    df = pd.DataFrame({"a": [1, 2, 3], "b": ["x", "y", "z"]})
    key = "some/awkward key:with*chars" * 4  # long + unsafe characters
    assert key not in store
    with pytest.raises(KeyError):
        store[key]
    store[key] = df
    assert key in store
    pd.testing.assert_frame_equal(store[key], df)
    # distinct keys with the same sanitized stem stay distinct
    other = key + "!"
    store[other] = df.assign(a=[9, 9, 9])
    assert store[other].a.tolist() == [9, 9, 9]
    assert store[key].a.tolist() == [1, 2, 3]
    store.clear()
    assert key not in store and other not in store


def test_run_cached_recomputes_on_corrupt_result(tmp_path):
    import pydantic

    from algonauts2025_tpu_torch.cache.task_cache import TaskInfra

    class T(pydantic.BaseModel):
        x: int = 1

    infra = TaskInfra(folder=tmp_path)
    infra.bind(T())
    calls = []
    out = infra.run_cached(lambda: calls.append(1) or {"v": 42})
    assert out == {"v": 42}
    # corrupt the cached pickle: a rerun must recompute, not return None
    infra._result_path().write_bytes(b"\x80garbage")
    out2 = infra.run_cached(lambda: calls.append(1) or {"v": 43})
    assert out2 == {"v": 43}
    assert len(calls) == 2
    # and the repaired cache serves normally afterwards
    out3 = infra.run_cached(lambda: calls.append(1) or {"v": 44})
    assert out3 == {"v": 43} and len(calls) == 2


def test_monitor_mode_from_metric_flags():
    from algonauts2025_tpu_torch.experiment.experiment import _monitor_mode
    from algonauts2025_tpu_torch.training.metrics import (
        GroupedPearson,
        MultidimPearsonCorrCoef,
        Rank,
    )

    metrics = {
        "val/pearson": MultidimPearsonCorrCoef(),
        "val/subj_pearson": GroupedPearson(n_groups=2),
        "val/rank": Rank(),
    }
    assert _monitor_mode("val/pearson", metrics) == "max"
    assert _monitor_mode("val/subj_pearson/1", metrics) == "max"  # group key
    assert _monitor_mode("val/rank", metrics) == "min"  # lower is better
    assert _monitor_mode("val/loss", {}) == "min"
    assert _monitor_mode("val/custom", {}) == "max"


def test_cached_map_threadpool(tmp_path):
    import pydantic

    from algonauts2025_tpu_torch.cache.map_runner import CachedMap, MapInfra

    class Owner(pydantic.BaseModel):
        tag: str = "o"

    seen_batches = []

    def fn(items):
        seen_batches.append(list(items))
        for it in items:
            yield np.full((3,), float(it))

    cm = CachedMap(
        infra=MapInfra(folder=tmp_path, cluster="threadpool", max_jobs=3),
        owner=Owner(),
        method_name="m",
        fn=fn,
        item_uid=str,
    )
    out = cm(list(range(7)))
    assert [int(o[0]) for o in out] == list(range(7))
    assert len(seen_batches) == 3  # chunked over 3 workers
    # second call: pure cache, order preserved, no recompute
    out2 = cm([5, 1, 5])
    assert [int(o[0]) for o in out2] == [5, 1, 5]
    assert len(seen_batches) == 3


def test_config_uid_handles_inf_and_canonicalizes_floats():
    import pydantic

    from algonauts2025_tpu_torch.config.uid import config_uid

    class C(pydantic.BaseModel):
        x: float = 1.0

    assert config_uid(C(x=float("inf"))) != config_uid(C(x=float("nan")))
    assert config_uid(C(x=2.0)) == config_uid(C(x=2.0))
    assert config_uid(C(x=2.0)).split("-")[-1] != config_uid(C(x=2.5)).split("-")[-1]

    # integral float == int: the same config value hashes the same (a
    # yaml/json round trip may turn 2.0 into 2 — caches must not split)
    from algonauts2025_tpu_torch.config.uid import dump_for_uid

    class D(pydantic.BaseModel):
        x: tp.Any = 1

    assert dump_for_uid(D(x=2.0)) == dump_for_uid(D(x=2))


def test_study_loader_uid_with_chunk_events_inf():
    """ChunkEvents' default max_duration=inf must not crash the study uid."""
    from algonauts2025_tpu_torch.config.uid import config_uid
    from algonauts2025_tpu_torch.data.study import StudyLoader

    loader = StudyLoader(
        path="/tmp/x",
        enhancers=[{"name": "ChunkEvents", "event_type_to_chunk": "Sound"}],
    )
    assert config_uid(loader)


def test_prefetch_abandoned_generator_unblocks_producer(tmp_path):
    import threading
    import time as _time

    from algonauts2025_tpu_torch.data.dataset import SegmentData, prefetch_to_device

    produced = []

    def gen():
        for i in range(50):
            produced.append(i)
            yield SegmentData(
                data={"x": np.full((1, 2), float(i), np.float32)}, segments=[None]
            )

    before = threading.active_count()
    it = prefetch_to_device(gen(), "cpu", size=2)
    first = next(it)
    assert float(np.asarray(first.data["x"])[0, 0]) == 0.0
    it.close()  # abandon mid-stream (limit_train_batches semantics)
    deadline = _time.time() + 5
    while threading.active_count() > before and _time.time() < deadline:
        _time.sleep(0.05)
    assert threading.active_count() <= before  # producer thread exited
    assert len(produced) < 50  # and did not run the whole epoch


def test_ram_only_cache_dedupes_within_one_call():
    """Duplicate uids in a single call (e.g. every unmatched word sharing
    the 'word_' uid) must compute once, matching the store path's
    first-appearance dedup."""
    import numpy as np

    import pydantic

    from algonauts2025_tpu_torch.cache.map_runner import CachedMap, MapInfra

    class Owner(pydantic.BaseModel):
        pass

    calls: list[list[int]] = []

    def fn(items):
        calls.append(list(items))
        return [np.full((2,), it) for it in items]

    cm = CachedMap(
        infra=MapInfra(folder=None),  # RAM-only path
        owner=Owner(),
        method_name="m",
        fn=fn,
        item_uid=lambda it: f"u{it % 2}",  # 2 distinct uids
    )
    out = cm([0, 1, 2, 3, 4])
    assert len(calls) == 1 and calls[0] == [0, 1]  # one compute per uid
    np.testing.assert_array_equal(out[2], out[0])
    np.testing.assert_array_equal(out[4], out[0])
    assert len(out) == 5
