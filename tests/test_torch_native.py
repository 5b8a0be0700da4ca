"""The port's twin of tests/test_native.py: the same cases over the copies in
algonauts2025_tpu_torch.

Native C++ data-plane: parity with the NumPy paths."""

import numpy as np
import pytest

from algonauts2025_tpu_torch import native


@pytest.fixture(scope="module")
def lib():
    lib = native.get_lib()
    if lib is None:
        pytest.skip("native library unavailable (no g++)")
    return lib


def test_pcm16_mono_zscore(lib, rng):
    data = (rng.standard_normal((1000, 2)) * 8000).astype(np.int16)
    out = native.decode_pcm16_mono_zscore(data.view(np.uint8).ravel(), 2)
    ref = (data.astype(np.float32) / 32768.0).mean(axis=1)
    ref = (ref - ref.mean()) / (1e-8 + ref.std())
    np.testing.assert_allclose(out, ref, atol=1e-5)


def test_overlap_add(lib, rng):
    out = rng.standard_normal((4, 20)).astype(np.float32)
    src = rng.standard_normal((4, 9)).astype(np.float32)
    expected = out.copy()
    expected[:, 3:10] += src[:, 1:8]
    assert native.overlap_add(out, src, 3, 1, 7)
    np.testing.assert_allclose(out, expected, atol=1e-6)


def test_timed_array_uses_native(rng, monkeypatch):
    """TimedArray accumulation must actually DISPATCH to the native
    overlap_add (a silent fall-through to the NumPy path — dtype guard
    drift, missing lib — would make this test equal-by-construction)."""
    from algonauts2025_tpu_torch import native
    from algonauts2025_tpu_torch.core import TimedArray

    calls = {"native": 0}
    orig = native.overlap_add

    def counting(*args, **kw):
        took_native = orig(*args, **kw)
        calls["native"] += bool(took_native)
        return took_native

    # timed.py does `from ..native import overlap_add` inside the method,
    # so patching the module attribute intercepts every dispatch
    monkeypatch.setattr(native, "overlap_add", counting)

    out = TimedArray(frequency=2.0, start=0.0, duration=5.0)
    a = TimedArray(frequency=2.0, start=1.0, data=rng.standard_normal((3, 4)).astype(np.float32))
    b = TimedArray(frequency=2.0, start=2.0, data=rng.standard_normal((3, 4)).astype(np.float32))
    out += a
    out += b
    if native.get_lib() is not None:
        assert calls["native"] >= 2, "native overlap_add was never taken"
    ref = np.zeros((3, 10), np.float32)
    ref[:, 2:6] += np.asarray(a.data)
    ref[:, 4:8] += np.asarray(b.data)
    np.testing.assert_allclose(out.data, ref, atol=1e-6)
