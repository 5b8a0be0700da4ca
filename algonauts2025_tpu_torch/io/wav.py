"""WAV reading/writing with frame-offset support.

Replaces the reference's libsndfile dependency (reference
data_utils/data_utils/events.py:263-275 reads wav spans via soundfile) with
a self-contained RIFF/WAVE parser: pure NumPy with an optional C++ fast
path (algonauts2025_tpu_torch.native) for bulk PCM decode.

Supports PCM 16/24/32-bit and IEEE float32/float64, mono or multichannel.
Returns float32 arrays in [-1, 1], shape (frames, channels).
"""

from __future__ import annotations

import dataclasses
import struct
from pathlib import Path

import numpy as np

__all__ = ["Info", "info", "read", "write"]


@dataclasses.dataclass
class Info:
    samplerate: int
    frames: int
    channels: int

    @property
    def duration(self) -> float:
        return self.frames / self.samplerate


@dataclasses.dataclass
class _Format:
    audio_format: int  # 1 = PCM, 3 = IEEE float
    channels: int
    samplerate: int
    bits: int
    data_offset: int  # byte offset of PCM payload
    data_size: int  # bytes


def _parse_header(path: str) -> _Format:
    with open(path, "rb") as f:
        riff = f.read(12)
        if len(riff) < 12 or riff[:4] != b"RIFF" or riff[8:12] != b"WAVE":
            raise ValueError(f"Not a RIFF/WAVE file: {path}")
        fmt = None
        while True:
            head = f.read(8)
            if len(head) < 8:
                break
            chunk_id, size = head[:4], struct.unpack("<I", head[4:])[0]
            if chunk_id == b"fmt ":
                payload = f.read(size)
                if size & 1:  # RIFF chunks are word-aligned: skip pad byte
                    f.seek(1, 1)
                audio_format, channels, samplerate = struct.unpack(
                    "<HHI", payload[:8]
                )
                bits = struct.unpack("<H", payload[14:16])[0]
                if audio_format == 0xFFFE and size >= 40:  # WAVE_FORMAT_EXTENSIBLE
                    audio_format = struct.unpack("<H", payload[24:26])[0]
                fmt = (audio_format, channels, samplerate, bits)
            elif chunk_id == b"data":
                if fmt is None:
                    raise ValueError(f"WAV data chunk before fmt chunk: {path}")
                return _Format(*fmt, data_offset=f.tell(), data_size=size)
            else:
                f.seek(size + (size & 1), 1)
    raise ValueError(f"No data chunk found in {path}")


def info(path: str) -> Info:
    fmt = _parse_header(path)
    frame_bytes = fmt.channels * (fmt.bits // 8)
    return Info(
        samplerate=fmt.samplerate,
        frames=fmt.data_size // frame_bytes,
        channels=fmt.channels,
    )


def _decode(raw: np.ndarray, fmt: _Format) -> np.ndarray:
    if fmt.audio_format == 3:  # IEEE float
        dtype = np.float32 if fmt.bits == 32 else np.float64
        return raw.view(dtype).astype(np.float32)
    if fmt.audio_format != 1:
        # a-law/mu-law (6/7) etc. would decode as garbage through the
        # linear-PCM branches below — plausible-looking floats that train
        # corrupted audio features with no error
        raise ValueError(
            f"Unsupported WAV format code {fmt.audio_format} "
            "(only PCM=1 and IEEE float=3); transcode with ffmpeg first"
        )
    if fmt.bits == 16:
        return raw.view("<i2").astype(np.float32) / 32768.0
    if fmt.bits == 32:
        return raw.view("<i4").astype(np.float32) / 2147483648.0
    if fmt.bits == 24:
        b = raw.reshape(-1, 3)
        val = (
            b[:, 0].astype(np.int32)
            | (b[:, 1].astype(np.int32) << 8)
            | (b[:, 2].astype(np.int32) << 16)
        )
        val = np.where(val >= 1 << 23, val - (1 << 24), val)
        return val.astype(np.float32) / 8388608.0
    if fmt.bits == 8:  # unsigned
        return (raw.view("u1").astype(np.float32) - 128.0) / 128.0
    raise ValueError(f"Unsupported WAV bit depth: {fmt.bits}")


def read(path: str, start: int = 0, frames: int = -1) -> np.ndarray:
    """Read float32 samples, shape (frames, channels), from ``start``."""
    fmt = _parse_header(path)
    bytes_per_sample = fmt.bits // 8
    frame_bytes = fmt.channels * bytes_per_sample
    total_frames = fmt.data_size // frame_bytes
    start = min(max(0, start), total_frames)
    if frames < 0:
        frames = total_frames - start
    frames = min(frames, total_frames - start)
    offset = fmt.data_offset + start * frame_bytes
    count = frames * frame_bytes
    raw = np.fromfile(path, dtype=np.uint8, count=count, offset=offset)
    data = _decode(raw, fmt)
    return data.reshape(-1, fmt.channels)


def write(path: str | Path, data: np.ndarray, samplerate: int) -> None:
    """Write float32 samples in [-1, 1] as PCM16 WAV."""
    data = np.asarray(data, dtype=np.float32)
    if data.ndim == 1:
        data = data[:, None]
    pcm = np.clip(data * 32767.0, -32768, 32767).astype("<i2")
    payload = pcm.tobytes()
    channels = data.shape[1]
    byte_rate = samplerate * channels * 2
    with open(path, "wb") as f:
        f.write(b"RIFF")
        f.write(struct.pack("<I", 36 + len(payload)))
        f.write(b"WAVE")
        f.write(b"fmt ")
        f.write(struct.pack("<IHHIIHH", 16, 1, channels, samplerate, byte_rate, channels * 2, 16))
        f.write(b"data")
        f.write(struct.pack("<I", len(payload)))
        f.write(payload)


def read_mono_zscore(path: str, start: int = 0, frames: int = -1) -> np.ndarray:
    """Fused decode -> mono mean -> z-score ((x-mean)/(1e-8+std)).

    Uses the native data-plane (single pass over the PCM buffer) for 16-bit
    PCM; NumPy otherwise.  Matches the reference's audio preprocessing
    (reference features/audio.py:123-127).
    """
    fmt = _parse_header(path)
    bytes_per_sample = fmt.bits // 8
    frame_bytes = fmt.channels * bytes_per_sample
    total_frames = fmt.data_size // frame_bytes
    start = min(max(0, start), total_frames)
    if frames < 0:
        frames = total_frames - start
    frames = min(frames, total_frames - start)
    if fmt.audio_format == 1 and fmt.bits == 16:
        from ..native import decode_pcm16_mono_zscore, get_lib

        # probe library availability BEFORE the bulk read: without this, a
        # box with no native build read the whole PCM payload, discarded
        # it, and re-read it through the NumPy fallback below
        if get_lib() is not None:
            raw = np.fromfile(
                path,
                dtype=np.uint8,
                count=frames * frame_bytes,
                offset=fmt.data_offset + start * frame_bytes,
            )
            out = decode_pcm16_mono_zscore(raw, fmt.channels)
            if out is not None:
                return out
    data = read(path, start=start, frames=frames).mean(axis=1)
    return (data - data.mean()) / (1e-8 + data.std())
