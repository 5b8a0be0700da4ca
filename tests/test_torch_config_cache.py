"""The port's twin of tests/test_config_cache.py: the same cases over the
copies in algonauts2025_tpu_torch.

ConfDict, uid hashing, ArrayStore, CachedMap, TaskInfra tests."""

from typing import ClassVar

import numpy as np
import pydantic
import pytest

from algonauts2025_tpu_torch.cache import ArrayStore, CachedMap, MapInfra, TaskInfra
from algonauts2025_tpu_torch.config import ConfDict, config_uid


def test_confdict_dotted():
    cfg = ConfDict({"a": {"b": 1}, "c": 2})
    cfg["a.b"] = 3
    cfg.update({"a.d.e": 4, "c": 5})
    assert cfg["a"]["b"] == 3
    assert cfg["a.d.e"] == 4
    assert cfg["c"] == 5
    assert "a.d" in cfg
    d = cfg.to_dict()
    assert d == {"a": {"b": 3, "d": {"e": 4}}, "c": 5}


def test_confdict_uid_stable():
    u1 = ConfDict({"x": 1, "y": [0.5, 1.0]}).to_uid()
    u2 = ConfDict({"y": [0.5, 1.0], "x": 1}).to_uid()
    assert u1 == u2
    assert "x=1" in u1
    u3 = ConfDict({"x": 2}).to_uid()
    assert u3 != u1


class _Feat(pydantic.BaseModel):
    dim: int = 4
    device: str = "auto"
    layers: list[float] = [0.5, 1.0]

    def _exclude_from_cache_uid(self):
        return ["device", "layers"]


def test_config_uid_exclusions():
    a = config_uid(_Feat())
    assert a == config_uid(_Feat(device="cpu", layers=[0.1]))
    assert a != config_uid(_Feat(dim=8))


def test_array_store(tmp_path):
    store = ArrayStore(tmp_path / "s")
    x = np.arange(12, dtype=np.float32).reshape(3, 4)
    y = np.ones((2, 2), dtype=np.int32)
    store.append_many([("x", x), ("y", y)])
    assert "x" in store and "y" in store
    np.testing.assert_array_equal(store["x"], x)
    np.testing.assert_array_equal(store["y"], y)
    # reopen from disk
    store2 = ArrayStore(tmp_path / "s")
    np.testing.assert_array_equal(store2["x"], x)
    assert store2.missing(["x", "z"]) == ["z"]
    # duplicate appends are ignored
    store2.append_many([("x", np.zeros((3, 4), np.float32))])
    np.testing.assert_array_equal(store2["x"], x)


def test_array_store_dead_writer_cannot_deadlock(tmp_path):
    """A SIGKILLed writer must never deadlock later writers (r4 review:
    the old O_EXCL lock file persisted forever).  flock is kernel-released
    on process death, so a killed holder's lock frees immediately."""
    import os
    import signal
    import subprocess
    import sys
    import time

    store = ArrayStore(tmp_path / "s")
    lock = tmp_path / "s" / "data.bin.lock"
    # a real process takes the flock, then is SIGKILLed mid-hold
    holder = subprocess.Popen(
        [sys.executable, "-c", (
            "import fcntl, os, sys, time\n"
            f"fd = os.open({str(lock)!r}, os.O_CREAT | os.O_RDWR)\n"
            "fcntl.flock(fd, fcntl.LOCK_EX)\n"
            "print('locked', flush=True)\n"
            "time.sleep(60)\n"
        )],
        stdout=subprocess.PIPE,
    )
    assert holder.stdout.readline().strip() == b"locked"
    holder.send_signal(signal.SIGKILL)
    holder.wait()
    t0 = time.time()
    store.append_many([("x", np.ones((2,), np.float32))])
    assert time.time() - t0 < 30, "dead writer's lock was not released"
    assert "x" in store


def test_array_store_live_lock_times_out_with_owner(tmp_path):
    """A LIVE holder blocks acquisition until timeout; the error names the
    holder recorded in the lock file."""
    import os
    import signal
    import subprocess
    import sys

    from algonauts2025_tpu_torch.cache.array_store import _file_lock

    store = ArrayStore(tmp_path / "s")
    lock = tmp_path / "s" / "data.bin.lock"
    holder = subprocess.Popen(
        [sys.executable, "-c", (
            "import fcntl, os, sys, time\n"
            f"fd = os.open({str(lock)!r}, os.O_CREAT | os.O_RDWR)\n"
            "fcntl.flock(fd, fcntl.LOCK_EX)\n"
            "os.ftruncate(fd, 0); os.write(fd, b'otherhost:12345')\n"
            "print('locked', flush=True)\n"
            "time.sleep(60)\n"
        )],
        stdout=subprocess.PIPE,
    )
    try:
        assert holder.stdout.readline().strip() == b"locked"
        with pytest.raises(TimeoutError, match="otherhost:12345"):
            with _file_lock(store._bin, timeout=0.3):
                pass
    finally:
        holder.send_signal(signal.SIGKILL)
        holder.wait()
    # released after death: acquisition now succeeds immediately
    with _file_lock(store._bin, timeout=5):
        pass


def test_array_store_index_reload_on_same_mtime_tick(tmp_path):
    """The index fast path keys on (mtime_ns, size): a second writer's
    append landing in the same mtime tick must still be picked up."""
    import os

    store_a = ArrayStore(tmp_path / "s")
    store_b = ArrayStore(tmp_path / "s")
    store_a.append_many([("x", np.ones((2,), np.float32))])
    assert "x" in store_b  # __contains__ reloads
    # simulate coarse mtime: append then force the same mtime as before
    st = (tmp_path / "s" / "index.jsonl").stat()
    store_a.append_many([("y", np.ones((2,), np.float32))])
    os.utime(tmp_path / "s" / "index.jsonl", ns=(st.st_atime_ns, st.st_mtime_ns))
    store_b.refresh()
    assert "y" in store_b.keys()


def test_cached_map(tmp_path):
    calls = []

    def fn(items):
        calls.append(list(items))
        return [np.full((2,), float(i)) for i in items]

    feat = _Feat()
    cm = CachedMap(
        infra=MapInfra(folder=tmp_path),
        owner=feat,
        method_name="_get_data",
        fn=fn,
        item_uid=str,
    )
    out = cm([1, 2, 3])
    assert len(calls) == 1
    np.testing.assert_array_equal(out[1], [2.0, 2.0])
    out2 = cm([2, 4])
    assert calls[1] == [4]  # only uncached items recomputed
    np.testing.assert_array_equal(out2[0], [2.0, 2.0])

    # a second run (fresh object) reads from disk without recomputing
    cm2 = CachedMap(
        infra=MapInfra(folder=tmp_path),
        owner=_Feat(device="cuda"),  # excluded field -> same cache
        method_name="_get_data",
        fn=fn,
        item_uid=str,
    )
    out3 = cm2([1, 4])
    assert len(calls) == 2
    np.testing.assert_array_equal(out3[1], [4.0, 4.0])


def test_cached_map_impl_version_busts_cache(tmp_path):
    """An owner-declared `_cache_impl_version` busts warm caches when
    compute semantics change with no config change (r3 review: the video
    decode parity fixes changed cached values under identical configs);
    the default "0" keeps historical uids stable."""
    calls = []

    def fn(items):
        calls.append(list(items))
        return [np.full((2,), float(i)) for i in items]

    def make(owner):
        return CachedMap(
            infra=MapInfra(folder=tmp_path),
            owner=owner,
            method_name="_get_data",
            fn=fn,
            item_uid=str,
        )

    class _FeatV1(_Feat):
        _cache_impl_version: ClassVar[str] = "1"

    # config_uid embeds the class name; align it so ONLY the impl version
    # differs between the two owners
    _FeatV1.__name__ = "_Feat"

    make(_Feat())([1])
    make(_FeatV1())([1])
    assert len(calls) == 2  # new impl version does not read the old cache
    make(_FeatV1())([1])
    assert len(calls) == 2  # but is itself cached


def test_cached_map_ram_only():
    calls = []

    def fn(items):
        calls.append(list(items))
        return [np.zeros(1) for _ in items]

    cm = CachedMap(
        infra=MapInfra(folder=None),
        owner=_Feat(),
        method_name="m",
        fn=fn,
        item_uid=str,
    )
    cm([1, 2])
    cm([1, 2])
    assert len(calls) == 1


class _Task(pydantic.BaseModel):
    x: int = 1
    infra: TaskInfra = TaskInfra()
    _count: int = 0

    def model_post_init(self, _ctx):
        self.infra.bind(self)

    def run(self):
        return self.infra.run_cached(self._run)

    def _run(self):
        self._count += 1
        return self.x * 10


def test_task_cache(tmp_path):
    t = _Task(x=3, infra=TaskInfra(folder=tmp_path))
    assert t.run() == 30
    assert t.infra.status() == "completed"
    assert t.run() == 30
    assert t._count == 1  # second call was cached

    # same config, new object: still cached
    t2 = _Task(x=3, infra=TaskInfra(folder=tmp_path))
    assert t2.run() == 30
    assert t2._count == 0

    # different config: recomputed
    t3 = _Task(x=4, infra=TaskInfra(folder=tmp_path))
    assert t3.run() == 40
    assert t3._count == 1

    # force mode reruns
    t4 = _Task(x=3, infra=TaskInfra(folder=tmp_path, mode="force"))
    assert t4.run() == 30
    assert t4._count == 1


def test_task_failure_and_retry(tmp_path):
    class Failing(_Task):
        def _run(self):
            self._count += 1
            if self._count == 1:
                raise RuntimeError("boom")
            return 7

    t = Failing(infra=TaskInfra(folder=tmp_path))
    with pytest.raises(RuntimeError):
        t.run()
    assert t.infra.status() == "failed"
    with pytest.raises(RuntimeError):  # cached mode refuses failed tasks
        _t = Failing(infra=TaskInfra(folder=tmp_path))
        _t.run()
    t2 = Failing(infra=TaskInfra(folder=tmp_path, mode="retry"))
    t2._count = 1  # skip the failing first call
    assert t2.run() == 7


def test_job_array(tmp_path):
    ran = []

    class T(pydantic.BaseModel):
        i: int

        def run(self):
            ran.append(self.i)

    infra = TaskInfra(folder=tmp_path)
    with infra.job_array() as tasks:
        tasks.extend(T(i=i) for i in range(3))
    assert sorted(ran) == [0, 1, 2]


def test_job_array_threadpool(tmp_path):
    import threading

    seen_threads = set()
    ran = []

    class T(pydantic.BaseModel):
        i: int

        def run(self):
            seen_threads.add(threading.get_ident())
            ran.append(self.i)

    infra = TaskInfra(folder=tmp_path, cluster="threadpool", max_workers=3)
    with infra.job_array() as tasks:
        tasks.extend(T(i=i) for i in range(6))
    assert sorted(ran) == list(range(6))
    # executor threads, not the caller: a regression to serial in-thread
    # execution would otherwise pass unnoticed
    assert threading.get_ident() not in seen_threads


def test_job_array_threadpool_propagates_failure(tmp_path):
    class T(pydantic.BaseModel):
        i: int

        def run(self):
            if self.i == 1:
                raise RuntimeError("boom")

    infra = TaskInfra(folder=tmp_path, cluster="threadpool", max_workers=2)
    with pytest.raises(RuntimeError, match="boom"):
        with infra.job_array() as tasks:
            tasks.extend(T(i=i) for i in range(3))


def test_empty_job_array_raises(tmp_path):
    infra = TaskInfra(folder=tmp_path)
    with pytest.raises(RuntimeError, match="Empty job array"):
        with infra.job_array():
            pass


def test_uid_ignores_default_valued_fields():
    """exca contract (reference enhancers.py:73 exclude_defaults): a new
    config field with a default must NOT invalidate existing caches, and
    explicitly passing the default is identical to omitting it."""
    import typing as tp

    from algonauts2025_tpu_torch.config.uid import config_uid

    class Cfg(pydantic.BaseModel):
        x: int = 3
        y: str = "a"

    base_uid = config_uid(Cfg())

    class Cfg(pydantic.BaseModel):  # noqa: F811  same name, one new field
        x: int = 3
        y: str = "a"
        z: float = 0.5  # newly added, defaulted

    assert config_uid(Cfg()) == base_uid  # old caches stay valid
    assert config_uid(Cfg(x=3, y="a")) == base_uid  # explicit default == omitted
    assert config_uid(Cfg(z=0.7)) != base_uid  # non-default engages

    class Named(pydantic.BaseModel):
        name: tp.Literal["A"] = "A"
        v: int = 1

    class Named2(pydantic.BaseModel):
        name: tp.Literal["B"] = "B"
        v: int = 1

    # the name discriminator is always kept: nested features of different
    # classes must not collapse to the same dump
    from algonauts2025_tpu_torch.config.uid import dump_for_uid

    assert dump_for_uid(Named()) != dump_for_uid(Named2())


def test_confdict_empty_mapping_merge_is_noop():
    """Merging an empty mapping into an existing subtree (a grid entry
    with no overrides for that section) must not wipe the subtree."""
    from algonauts2025_tpu_torch.config.confdict import ConfDict

    cd = ConfDict({"infra": {"folder": "/x", "cluster": "external"}, "lr": 0.1})
    cd.update({"infra": {}})
    assert cd["infra.folder"] == "/x"
    assert cd["infra.cluster"] == "external"
    # non-empty merge still deep-merges, preserving siblings
    cd.update({"infra": {"cluster": "threadpool"}})
    assert cd["infra.cluster"] == "threadpool"
    assert cd["infra.folder"] == "/x"
    # assigning an empty dict to a NEW key still works
    cd.update({"fresh": {}})
    assert cd["fresh"] == {}


def test_uid_default_check_respects_nested_exclusions():
    """A nested model differing from its default only in its own
    uid-EXCLUDED fields is still 'default' for cache identity (the
    device/layers-never-invalidate contract must survive the
    exclude-defaults dump)."""
    from algonauts2025_tpu_torch.config.uid import config_uid

    class Inner(pydantic.BaseModel):
        device: str = "cpu"
        depth: int = 2

        def _exclude_from_cache_uid(self):
            return ["device"]

    class Outer(pydantic.BaseModel):
        inner: Inner = Inner()
        lr: float = 0.1

    assert config_uid(Outer()) == config_uid(Outer(inner=Inner(device="tpu")))
    assert config_uid(Outer()) != config_uid(Outer(inner=Inner(depth=3)))


def test_array_store_concurrent_process_writers(tmp_path):
    """Two real processes appending concurrently must serialize on the
    flock: all keys land, every payload reads back intact."""
    import subprocess
    import sys

    script = (
        "import sys\n"
        "import numpy as np\n"
        "from algonauts2025_tpu_torch.cache import ArrayStore\n"
        "folder, tag = sys.argv[1], sys.argv[2]\n"
        "store = ArrayStore(folder)\n"
        "items = [(f'{tag}-{i}', np.full((i + 1,), float(i))) for i in range(20)]\n"
        "for it in items:\n"
        "    store.append_many([it])\n"
    )
    procs = [
        subprocess.Popen([sys.executable, "-c", script, str(tmp_path / "s"), tag])
        for tag in ("a", "b")
    ]
    for p in procs:
        assert p.wait() == 0
    store = ArrayStore(tmp_path / "s")
    for tag in ("a", "b"):
        for i in range(20):
            np.testing.assert_array_equal(
                store[f"{tag}-{i}"], np.full((i + 1,), float(i))
            )


def test_confdict_flatten_roundtrip_fuzz():
    """Property: any nested config tree survives flatten -> dotted-set
    reconstruction -> to_dict unchanged (the dotted-override surface the
    grids sweep through must be lossless)."""
    import random

    rng = random.Random(1)

    def rand_tree(depth):
        if depth == 0 or rng.random() < 0.4:
            return rng.choice([1, 2.5, "s", None, [1, 2], True, {}])
        return {f"k{i}": rand_tree(depth - 1) for i in range(rng.randint(1, 3))}

    for _ in range(200):
        tree = {f"k{i}": rand_tree(2) for i in range(rng.randint(1, 4))}
        cd = ConfDict(tree)
        assert cd.to_dict() == tree
        rebuilt = ConfDict()
        for k, v in cd.flat().items():
            rebuilt[k] = v
        assert rebuilt.to_dict() == tree
        # uid is order-invariant over the same flattening
        shuffled = list(cd.flat().items())
        rng.shuffle(shuffled)
        other = ConfDict()
        for k, v in shuffled:
            other[k] = v
        assert other.to_uid() == cd.to_uid()
