"""The port's HDF5 reader and writer (io/hdf5.py) against h5py.

h5py writes files in every variant the reader covers (1, 9 and 300
datasets; ``libver`` earliest and latest; contiguous, chunked, gzip and
shuffle + gzip layouts; float32 and float64, and integers): the port's
reader must return the same keys and the same arrays, bit for bit.  The
port's writer's files must read back through h5py and through the JAX
package's ``io/fmri.load_h5_key``.  What the reader does not cover raises
``NotImplementedError``.  h5py is the oracle here only; the port never
imports it.
"""

import h5py
import numpy as np
import pytest

from algonauts2025_tpu.io import fmri as jax_fmri
from algonauts2025_tpu_torch.io import fmri, hdf5

LAYOUTS = {
    "contiguous": {},
    "chunked": {"chunks": (5, 4)},
    "gzip": {"chunks": (5, 4), "compression": "gzip"},
    "shuffle_gzip": {"chunks": (5, 4), "compression": "gzip", "shuffle": True},
}


def _arrays(n, dtype, seed):
    """``n`` 2-D arrays keyed like the release's runs, ragged in time (so
    chunked layouts have partial edge chunks)."""
    rng = np.random.default_rng(seed)
    out = {}
    for i in range(n):
        key = f"ses-{i // 10 + 1:03d}_task-s{i % 7 + 1:02d}e{i:03d}a"
        out[key] = (rng.standard_normal((int(rng.integers(5, 23)), 7)) * 50).astype(dtype)
    return out


def _h5py_file(path, arrays, libver, **kwargs):
    with h5py.File(path, "w", libver=libver) as f:
        for key, value in arrays.items():
            f.create_dataset(key, data=value, **kwargs)
        return list(f)


def _assert_same(path, keys):
    assert hdf5.keys(path) == keys
    with h5py.File(path, "r") as f:
        for key in keys:
            got = hdf5.read(path, key)
            want = f[key][()]
            assert got.dtype == want.dtype and got.shape == want.shape
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("n", [1, 9, 300])
@pytest.mark.parametrize("libver", ["earliest", "latest"])
def test_reader_matches_h5py(tmp_path, libver, n, layout, dtype):
    """Symbol-table groups over one or many B-tree leaves (earliest), compact
    and dense links (latest, dense above 8), every chunk index h5py picks."""
    arrays = _arrays(n, dtype, seed=n)
    path = tmp_path / "bold.h5"
    keys = _h5py_file(path, arrays, libver, **LAYOUTS[layout])
    _assert_same(path, keys)
    assert sorted(keys) == sorted(arrays)


@pytest.mark.parametrize("libver", ["earliest", "latest"])
def test_reader_integers_single_chunk_and_three_dims(tmp_path, libver):
    """Integer types, a chunk the size of its dataset (filtered or not; a
    single-chunk index in the latest format), 1-D and 3-D datasets."""
    rng = np.random.default_rng(3)
    path = tmp_path / "mixed.h5"
    with h5py.File(path, "w", libver=libver) as f:
        for dtype in ("int8", "uint8", "int16", "int32", "int64", "uint64"):
            f.create_dataset(dtype, data=rng.integers(-100, 100, (6, 5)).astype(dtype))
        f.create_dataset("single", data=rng.standard_normal((7, 11)), chunks=(7, 11))
        f.create_dataset("single_gzip", data=rng.standard_normal((7, 11)).astype("float32"),
                         chunks=(7, 11), compression="gzip", shuffle=True)
        f.create_dataset("one_d", data=np.arange(10.0))
        f.create_dataset("three_d", data=rng.standard_normal((3, 4, 5)), chunks=(2, 3, 2),
                         compression="gzip")
        keys = list(f)
    _assert_same(path, keys)


@pytest.mark.parametrize("libver", ["earliest", "latest"])
def test_reader_compact_layout(tmp_path, libver):
    path = tmp_path / "compact.h5"
    with h5py.File(path, "w", libver=libver) as f:
        dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
        dcpl.set_layout(h5py.h5d.COMPACT)
        space = h5py.h5s.create_simple((2, 3))
        dset = h5py.h5d.create(f.id, b"c", h5py.h5t.IEEE_F32LE, space, dcpl=dcpl)
        dset.write(h5py.h5s.ALL, h5py.h5s.ALL, np.arange(6, dtype=np.float32).reshape(2, 3))
    np.testing.assert_array_equal(hdf5.read(path, "c"), np.arange(6, dtype=np.float32).reshape(2, 3))


@pytest.mark.parametrize("n", [0, 1, 9, 300])
def test_writer_reads_back_through_h5py_and_jax(tmp_path, n):
    arrays = _arrays(n, "float32", seed=10 + n)
    arrays.update({"ints": np.arange(12, dtype=np.int64).reshape(3, 4)} if n else {})
    path = tmp_path / "written.h5"
    hdf5.write(path, arrays)
    with h5py.File(path, "r") as f:
        assert sorted(f) == sorted(arrays)
        for key, value in arrays.items():
            assert f[key].dtype == value.dtype
            np.testing.assert_array_equal(f[key][()], value)
    assert hdf5.keys(path) == sorted(arrays)
    for key, value in arrays.items():
        np.testing.assert_array_equal(hdf5.read(path, key), value)
        if key != "ints":
            np.testing.assert_array_equal(jax_fmri.load_h5_key(str(path), key), value)
            np.testing.assert_array_equal(fmri.load_h5_key(str(path), key), value)


def test_writer_append_keeps_keys(tmp_path):
    """mode="a" keeps what is in the file, written by the port or by h5py,
    and adds the new keys; h5py can append to the port's file."""
    path = tmp_path / "a.h5"
    first = _arrays(3, "float32", seed=1)
    _h5py_file(path, first, "latest", chunks=(5, 4), compression="gzip")
    second = {"extra": np.ones((2, 2), np.float64)}
    hdf5.write(path, second, mode="a")
    with h5py.File(path, "a") as f:
        assert sorted(f) == sorted({**first, **second})
        for key, value in {**first, **second}.items():
            np.testing.assert_array_equal(f[key][()], value)
        f.create_dataset("by_h5py", data=np.zeros(3))
    assert hdf5.keys(path) == sorted([*first, *second, "by_h5py"])
    hdf5.write(path, {"extra": np.zeros((1, 1))}, mode="w")
    assert hdf5.keys(path) == ["extra"]


def test_single_dataset_file_load_matches_jax(tmp_path):
    path = tmp_path / "one.h5"
    value = np.random.default_rng(0).standard_normal((30, 12)).astype(np.float32)
    hdf5.write(path, {"bold": value})
    np.testing.assert_array_equal(fmri.load(str(path)), jax_fmri.load(str(path)))


@pytest.mark.parametrize("libver", ["earliest", "latest"])
@pytest.mark.parametrize("kwargs,what", [
    ({"compression": "lzf"}, "lzf"),
    ({"dtype": ">f4"}, "big-endian"),
    ({"chunks": (5, 4), "fletcher32": True}, "fletcher32"),
    ({"dtype": "S4"}, "datatype class"),
])
def test_unsupported_raises(tmp_path, libver, kwargs, what):
    path = tmp_path / "odd.h5"
    data = np.ones((7, 11), "S4" if kwargs.get("dtype") == "S4" else np.float32)
    with h5py.File(path, "w", libver=libver) as f:
        f.create_dataset("x", data=data, **kwargs)
    with pytest.raises(NotImplementedError, match=what):
        hdf5.read(path, "x")


def test_unsupported_chunk_index_raises(tmp_path):
    """A resizable dataset in the latest format gets an extensible-array
    chunk index, which the reader does not cover."""
    path = tmp_path / "resizable.h5"
    with h5py.File(path, "w", libver="latest") as f:
        f.create_dataset("x", data=np.ones((7, 11)), chunks=(3, 5), maxshape=(None, 11))
    with pytest.raises(NotImplementedError, match="extensible array"):
        hdf5.read(path, "x")


def test_missing_key_and_not_hdf5(tmp_path):
    path = tmp_path / "f.h5"
    hdf5.write(path, {"a": np.zeros(2)})
    with pytest.raises(KeyError):
        hdf5.read(path, "b")
    other = tmp_path / "g.h5"
    other.write_bytes(b"not an hdf5 file" * 8)
    with pytest.raises(ValueError, match="not an HDF5 file"):
        hdf5.keys(other)
