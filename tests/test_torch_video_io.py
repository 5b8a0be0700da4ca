"""The port's twin of tests/test_video_io.py: the same cases over the copies in
algonauts2025_tpu_torch.

Video decode/sampling parity (round-3 review findings).

The reference reads frames through moviepy's FFMPEG_VideoReader, which
maps a timestamp to ``floor(fps * t + 1e-5)``.  ``io.video`` previously
used round(), selecting the NEXT frame for half of all timestamps at
non-integer fps — these tests pin the floor convention functionally, with
the frame index encoded in the pixels of a synthetic clip.
"""

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

from algonauts2025_tpu_torch.io.video import VideoClip


FPS = 8
N_FRAMES = 48
LEVELS = 5  # frame k is filled with gray level (k % LEVELS) * 50


def _write_indexed_video(path) -> bool:
    for fourcc_name in ("mp4v", "XVID", "MJPG"):
        fourcc = cv2.VideoWriter_fourcc(*fourcc_name)
        writer = cv2.VideoWriter(str(path), fourcc, FPS, (64, 64))
        if writer.isOpened():
            break
        writer.release()
    else:
        return False
    for k in range(N_FRAMES):
        level = (k % LEVELS) * 50
        writer.write(np.full((64, 64, 3), level, np.uint8))
    writer.release()
    return path.exists()


def _level(frame: np.ndarray) -> int:
    """Nearest encoded gray level (codecs are lossy but not 25-levels
    lossy)."""
    return int(round(float(frame.mean()) / 50.0))


@pytest.fixture(scope="module")
def clip_path(tmp_path_factory):
    path = tmp_path_factory.mktemp("vio") / "idx.mp4"
    if not _write_indexed_video(path):
        pytest.skip("no cv2 encoder available")
    return path


def test_get_frame_uses_moviepy_floor(clip_path):
    clip = VideoClip(str(clip_path))
    try:
        # t exactly between frames: floor must pick the EARLIER frame
        # (round() would pick the later one for fractional parts >= 0.5)
        for t, expected_idx in [
            (0.0, 0),
            (0.99 / FPS, 0),
            (1.0 / FPS, 1),
            (1.5 / FPS, 1),
            (7.9 / FPS, 7),
        ]:
            frame = clip.get_frame(t)
            assert _level(frame) == (expected_idx % LEVELS), (t, expected_idx)
    finally:
        clip.close()


def test_sliding_windows_frame_ids(clip_path):
    clip = VideoClip(str(clip_path))
    try:
        n, span = 8, 1.0  # 8 frames covering the previous 1 s at 8 fps
        times = [2.0, 2.5]
        for t, window in zip(times, clip.sliding_windows(times, n, span)):
            assert window.shape == (n, 64, 64, 3)
            subtimes = [k / n * span for k in reversed(range(n))]
            expected = [int(max(0.0, t - t2) * FPS + 1e-5) for t2 in subtimes]
            got = [_level(f) for f in window]
            assert got == [e % LEVELS for e in expected], (t, got, expected)
    finally:
        clip.close()


def test_preprocess_frames_torchvision_size_semantics():
    """Shortest edge -> int(crop*256/224); long edge truncated; center
    crop; ImageNet normalization (ops/video_prep.py)."""
    import torch

    from algonauts2025_tpu_torch.ops.video_prep import (
        IMAGENET_MEAN,
        IMAGENET_STD,
        preprocess_frames,
    )

    rng = np.random.default_rng(0)
    # 534x1280: torchvision truncates the long edge (292*1280/534 = 699.9 -> 699)
    frames = torch.from_numpy(rng.integers(0, 256, (2, 534, 1280, 3), dtype=np.uint8))
    out = np.asarray(preprocess_frames(frames, crop_size=256))
    assert out.shape == (2, 256, 256, 3)
    # uniform-color input survives resize+crop exactly -> check normalization
    solid = torch.full((1, 300, 400, 3), 128, dtype=torch.uint8)
    got = np.asarray(preprocess_frames(solid, crop_size=256))
    want = (128 / 255.0 - np.asarray(IMAGENET_MEAN)) / np.asarray(IMAGENET_STD)
    np.testing.assert_allclose(got[0, 0, 0], want, atol=1e-5)
    np.testing.assert_allclose(got, np.broadcast_to(want, got.shape), atol=1e-4)


def test_fmri_event_orientation_validation(tmp_path):
    """Fmri events validate file orientation against their declared
    duration/frequency: time-major files transpose, ambiguity-free wrong
    shapes fail loudly (round-3 review: io.fmri.load returns as stored)."""
    from algonauts2025_tpu_torch.core.events import Event

    tr_hz = 1 / 1.49
    n_t, n_p = 40, 64
    data_tp = np.random.default_rng(0).standard_normal((n_t, n_p)).astype(np.float32)

    def make_event(path):
        return Event.from_dict(
            dict(
                type="Fmri",
                filepath=str(path),
                start=0.0,
                duration=n_t / tr_hz,
                frequency=tr_hz,
                timeline="tl",
                subject="s1",
            )
        )

    p_time_major = tmp_path / "tm.npy"
    np.save(p_time_major, data_tp)
    out = make_event(p_time_major).read()
    assert out.shape == (n_p, n_t)  # transposed to time-last

    p_parcel_major = tmp_path / "pm.npy"
    np.save(p_parcel_major, data_tp.T)
    out2 = make_event(p_parcel_major).read()
    assert out2.shape == (n_p, n_t)
    np.testing.assert_array_equal(out, out2)

    p_bad = tmp_path / "bad.npy"
    np.save(p_bad, np.zeros((7, 9), np.float32))
    import pytest as _pytest

    with _pytest.raises(ValueError, match="neither axis"):
        make_event(p_bad).read()

    # BOTH axes within 1 of the declared timestep count (e.g. 1000 parcels
    # and ~1000 TRs): orientation is undecidable — must fail loudly rather
    # than silently guess (r3 review: a wrong guess swaps axes)
    p_ambig = tmp_path / "ambig.npy"
    np.save(p_ambig, np.zeros((n_t, n_t), np.float32))  # square: errors tie
    with _pytest.raises(ValueError, match="ambiguous"):
        make_event(p_ambig).read()

    # one axis exact, the other off by one (40 vs 41): STILL ambiguous —
    # the file could be time-major with the declared length or time-last
    # one TR long; r4 raises whenever both axes are within tolerance
    # (r3 let the exact axis win, which silently transposed files whose
    # true time axis was off by one while parcels matched — ADVICE r3 #2)
    p_close = tmp_path / "close.npy"
    np.save(p_close, np.zeros((n_t, n_t + 1), np.float32))
    with _pytest.raises(ValueError, match="ambiguous"):
        make_event(p_close).read()

    # off-by-one on one axis only (time-major, one TR short): transposed
    p_trunc = tmp_path / "trunc.npy"
    np.save(p_trunc, data_tp[: n_t - 1])
    out3 = make_event(p_trunc).read()
    assert out3.shape == (n_p, n_t - 1)


def test_center_crop_bankers_rounding_offsets():
    """torchvision center_crop offsets are int(round(diff/2.0)) — Python
    banker's rounding, so odd diffs round their .5 to the EVEN offset.
    Shapes whose shortest edge already equals the resize size make the
    resize an identity, exposing the crop offset exactly."""
    import torch

    from algonauts2025_tpu_torch.ops.video_prep import IMAGENET_MEAN, IMAGENET_STD

    from algonauts2025_tpu_torch.ops.video_prep import preprocess_frames

    for width, want_left in [(391, 68), (389, 66)]:  # round(67.5)=68, round(66.5)=66
        col = (np.arange(width) % 251).astype(np.uint8)
        frames = np.broadcast_to(col[None, None, :, None], (1, 292, width, 3))
        out = np.asarray(preprocess_frames(torch.from_numpy(frames.copy()), crop_size=256))
        # denormalize channel 0 of the first output column back to 0..255
        v = (out[0, 0, 0, 0] * IMAGENET_STD[0] + IMAGENET_MEAN[0]) * 255.0
        # expected offsets follow torchvision center_crop's formula
        # int(round((W - 256) / 2.0)) (torchvision is not installed here;
        # the formula is pinned in ops/video_prep.py's docstring)
        assert abs(v - want_left) < 0.35, (width, v, want_left)


def test_wav_rejects_non_pcm_formats(tmp_path):
    """a-law/mu-law WAVs (format codes 6/7) must be rejected loudly — the
    8-bit linear-PCM branch would decode companded bytes as garbage audio
    that trains corrupted features with no error (r4 review)."""
    import struct

    from algonauts2025_tpu_torch.io import wav as wavio

    path = tmp_path / "alaw.wav"
    n = 64
    data = bytes(range(64))
    fmt = struct.pack("<HHIIHH", 6, 1, 8000, 8000, 1, 8)  # a-law, 8-bit
    payload = (
        b"WAVE"
        + b"fmt " + struct.pack("<I", len(fmt)) + fmt
        + b"data" + struct.pack("<I", n) + data
    )
    path.write_bytes(b"RIFF" + struct.pack("<I", len(payload)) + payload)
    with pytest.raises(ValueError, match="format code 6"):
        wavio.read(str(path))


def test_iter_frames_floor_convention(clip_path):
    """iter_frames must use the same floor(+1e-5) time->frame mapping as
    get_frame — round() served an extra EOF-clamped duplicate when
    duration*fps landed just under an integer (r4 review)."""
    from algonauts2025_tpu_torch.io.video import VideoClip

    clip = VideoClip(str(clip_path))
    try:
        frames = list(clip.iter_frames())
        assert len(frames) == int(clip.duration * clip.fps + 1e-5)
        assert _level(frames[0]) == _level(clip.get_frame(0.0))
        # duration just below an integer frame count: floor, not round
        clip.duration = (len(frames) - 0.4) / clip.fps
        assert len(list(clip.iter_frames())) == len(frames) - 1
    finally:
        clip.close()
