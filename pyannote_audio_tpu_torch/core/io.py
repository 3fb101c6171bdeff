"""Audio decoding, resampling and random-access cropping.

Counterpart of pyannote_audio_tpu/core/io.py: ``Audio`` decodes (every
WAV variant: PCM 8/16/24/32, float32/64, WAVE_FORMAT_EXTENSIBLE; other
containers through FFmpeg where the codec library was built), selects a
channel, downmixes (or picks a random channel), resamples and crops, with
``get_audio_metadata`` reading headers only. WAV headers are untrusted:
every field is validated and the advertised data size clamped to the
bytes present. Decoding and resampling go through the native runtime that
``utils/native.py`` builds from the JAX package's C++ sources; a numpy
decoder serves byte buffers, file-like objects and ranged crops. Without
the codec library a file that is not a WAV raises.

Waveforms are float32 arrays shaped (channel, time).
"""

from __future__ import annotations

import os
import struct
from collections.abc import MutableMapping
from dataclasses import dataclass
from pathlib import Path
from typing import IO, Mapping, Optional, Tuple, Union

import numpy as np

from ..utils import native
from .segment import Segment

AudioFile = Union[str, Path, IO, Mapping]

AudioFileDocString = """
Audio files can be provided as:
  * a str or Path instance pointing at a WAV file
  * a file-like object with a read() method
  * a dict with an "audio" key (path/file-like), optionally "channel"
  * a dict with "waveform" (channel, time) float32 and "sample_rate" keys
"""


@dataclass(frozen=True)
class AudioMetadata:
    sample_rate: int
    num_channels: int
    num_samples: int
    bits_per_sample: int
    encoding: str

    @property
    def duration(self) -> float:
        return self.num_samples / self.sample_rate


def _parse_wav_header(raw: bytes, total_size: Optional[int] = None
                      ) -> Tuple[AudioMetadata, int, int]:
    """Parse a RIFF/WAVE header -> (metadata, data_offset, data_size).

    Every field is untrusted: channel count, bit depth and sample rate are
    validated, the format-vs-depth combination is checked, and the
    advertised data size is clamped to the bytes actually present
    (``total_size`` is the real file size when only a header prefix is in
    ``raw``), so a lying header can neither divide by zero nor promise
    samples that do not exist.
    """
    if len(raw) < 44 or raw[:4] != b"RIFF" or raw[8:12] != b"WAVE":
        raise ValueError("not a RIFF/WAVE file")
    if total_size is None:
        total_size = len(raw)
    pos = 12
    fmt = None
    fmt_body = fmt_size = 0
    data_offset = data_size = None
    while pos + 8 <= len(raw):
        chunk_id = raw[pos:pos + 4]
        chunk_size = struct.unpack_from("<I", raw, pos + 4)[0]
        body = pos + 8
        if chunk_id == b"fmt ":
            if chunk_size < 16 or body + 16 > len(raw):
                raise ValueError("corrupt WAV fmt chunk")
            fmt = struct.unpack_from("<HHIIHH", raw, body)
            fmt_body, fmt_size = body, chunk_size
        elif chunk_id == b"data":
            data_offset, data_size = body, chunk_size
            # do not break: fmt may (rarely) come after data
        pos = body + chunk_size + (chunk_size & 1)
        if fmt is not None and data_offset is not None:
            break
    if fmt is None or data_offset is None:
        raise ValueError("WAV file missing fmt or data chunk")
    audio_format, num_channels, sample_rate, _, block_align, bits = fmt
    if audio_format == 0xFFFE:
        # WAVE_FORMAT_EXTENSIBLE: the real format code is the first two
        # bytes of the SubFormat GUID at fmt+24 (after cbSize,
        # wValidBitsPerSample and dwChannelMask)
        if fmt_size >= 40 and len(raw) >= fmt_body + 26:
            audio_format = struct.unpack_from("<H", raw, fmt_body + 24)[0]
        else:
            audio_format = 1        # truncated extension: assume PCM
    encoding = {1: "pcm", 3: "float"}.get(audio_format)
    if encoding is None:
        raise ValueError(f"unsupported WAV format code {audio_format}")
    if num_channels < 1:
        raise ValueError("WAV header declares zero channels")
    if sample_rate < 1:
        raise ValueError("WAV header declares zero sample rate")
    if sample_rate > 1_000_000:
        # no real recording exceeds 384 kHz; an absurd rate is a corrupt
        # or hostile header, and letting it through makes the polyphase
        # resampler build a filter proportional to the rate (a claimed
        # 4.3 GHz rate = a 128 GiB firwin allocation)
        raise ValueError(f"implausible WAV sample rate {sample_rate}")
    valid_bits = (32, 64) if encoding == "float" else (8, 16, 24, 32)
    if bits not in valid_bits:
        raise ValueError(
            f"unsupported WAV bit depth {bits} for {encoding} encoding")
    bytes_per_frame = max(block_align, num_channels * (bits // 8))
    # clamp the advertised size to the bytes actually present
    avail = max(0, total_size - data_offset)
    data_size = min(data_size, avail)
    num_samples = data_size // bytes_per_frame
    meta = AudioMetadata(sample_rate=sample_rate, num_channels=num_channels,
                         num_samples=num_samples, bits_per_sample=bits,
                         encoding=encoding)
    return meta, data_offset, data_size


def _decode_wav_bytes(raw: bytes, frame_offset: int = 0,
                      num_frames: int = -1) -> Tuple[np.ndarray, int]:
    """Decode (a slice of) a WAV byte buffer → ((channel, time) f32, rate)."""
    meta, data_offset, data_size = _parse_wav_header(raw)
    bps = meta.bits_per_sample // 8
    stride = bps * meta.num_channels
    if num_frames < 0:
        num_frames = meta.num_samples - frame_offset
    num_frames = max(0, min(num_frames, meta.num_samples - frame_offset))
    start = data_offset + frame_offset * stride
    buf = raw[start:start + num_frames * stride]
    return _decode_pcm_frames(buf, meta), meta.sample_rate


def _decode_pcm_frames(buf: bytes, meta: "AudioMetadata") -> np.ndarray:
    """Raw PCM frame bytes → (channel, time) f32 (layout from ``meta``)."""
    bps = meta.bits_per_sample // 8
    stride = bps * meta.num_channels
    buf = buf[:(len(buf) // stride) * stride]  # tolerate truncated files
    if meta.encoding == "float":
        dtype = {4: "<f4", 8: "<f8"}[bps]
        x = np.frombuffer(buf, dtype=dtype).astype(np.float32)
    elif bps == 2:
        x = np.frombuffer(buf, dtype="<i2").astype(np.float32) / 32768.0
    elif bps == 1:
        x = (np.frombuffer(buf, dtype=np.uint8).astype(np.float32)
             - 128.0) / 128.0
    elif bps == 3:
        b = np.frombuffer(buf, dtype=np.uint8).reshape(-1, 3)
        x = ((b[:, 0].astype(np.int32))
             | (b[:, 1].astype(np.int32) << 8)
             | (b[:, 2].astype(np.int32) << 16))
        x = np.where(x >= 1 << 23, x - (1 << 24), x).astype(np.float32)
        x = x / float(1 << 23)
    elif bps == 4:
        x = np.frombuffer(buf, dtype="<i4").astype(np.float32) / float(1 << 31)
    else:
        raise ValueError(f"unsupported bit depth {meta.bits_per_sample}")
    x = x.reshape(-1, meta.num_channels).T  # (channel, time)
    return np.ascontiguousarray(x)


def _read_bytes(file: Union[str, Path, IO]) -> bytes:
    if isinstance(file, (str, Path)):
        with open(file, "rb") as f:
            return f.read()
    file.seek(0)
    return file.read()


def _codec_decode_or_raise(path: str) -> Tuple[np.ndarray, int]:
    """FFmpeg-backed decode of a non-WAV file, or an actionable error."""
    decoded = native.codec_decode(path)
    if decoded is None:
        raise ValueError(
            f"cannot decode {path}: not a RIFF/WAVE file and the native "
            f"codec library (libpat_codec.so, built against FFmpeg) is "
            f"unavailable or does not support this format")
    return decoded


def get_audio_metadata(file: AudioFile) -> AudioMetadata:
    """Metadata without decoding samples."""
    file = Audio.validate_file(file)
    if "waveform" in file:
        w = np.asarray(file["waveform"])
        return AudioMetadata(sample_rate=int(file["sample_rate"]),
                             num_channels=w.shape[0], num_samples=w.shape[1],
                             bits_per_sample=32, encoding="float")
    source = file["audio"]
    if isinstance(source, (str, Path)):
        with open(source, "rb") as f:
            header = f.read(65536)
        try:
            meta, _, _ = _parse_wav_header(
                header, total_size=os.path.getsize(source))
            return meta
        except ValueError:
            info = native.codec_info(str(source))
            if info is None:
                raise
            sample_rate, channels, num_frames = info
            return AudioMetadata(sample_rate=sample_rate,
                                 num_channels=channels,
                                 num_samples=num_frames,
                                 bits_per_sample=0,
                                 encoding="compressed")
    meta, _, _ = _parse_wav_header(_read_bytes(source))
    return meta


def write_wav(path: Union[str, Path], waveform: np.ndarray,
              sample_rate: int) -> None:
    """Write a (channel, time) float waveform as 16-bit PCM WAV."""
    waveform = np.asarray(waveform)
    if waveform.ndim == 1:
        waveform = waveform[None]
    pcm = np.clip(np.rint(waveform.T * 32768.0), -32768, 32767).astype("<i2")
    data = pcm.tobytes()
    num_channels = waveform.shape[0]
    byte_rate = sample_rate * num_channels * 2
    with open(path, "wb") as f:
        f.write(b"RIFF")
        f.write(struct.pack("<I", 36 + len(data)))
        f.write(b"WAVEfmt ")
        f.write(struct.pack("<IHHIIHH", 16, 1, num_channels, sample_rate,
                            byte_rate, num_channels * 2, 16))
        f.write(b"data")
        f.write(struct.pack("<I", len(data)))
        f.write(data)


def read_wav(path: Union[str, Path]) -> Tuple[np.ndarray, int]:
    """A WAV file -> ((channel, time) float32, sample_rate)."""
    return _decode_wav_bytes(_read_bytes(path))


class Audio:
    """Decode + channel selection + downmix + resample + crop."""

    PRECISION = 0.001

    @staticmethod
    def power_normalize(waveform: np.ndarray) -> np.ndarray:
        """Normalize to unit RMS power."""
        rms = np.sqrt(np.square(waveform).mean(axis=-1, keepdims=True))
        return waveform / (rms + 1e-8)

    @staticmethod
    def validate_file(file: AudioFile) -> Mapping:
        """An audio file as a dict: a mutable mapping in place (hooks and
        pipelines cache per-file state in it), any other mapping copied, a
        path as {"audio", "uri"}."""
        if isinstance(file, MutableMapping):
            pass
        elif isinstance(file, Mapping):
            file = dict(file)
        elif isinstance(file, (str, Path)):
            file = {"audio": str(file), "uri": Path(file).stem}
        elif hasattr(file, "read"):
            file = {"audio": file, "uri": getattr(file, "name", "stream")}
        else:
            raise ValueError(AudioFileDocString)
        if "waveform" in file:
            waveform = np.asarray(file["waveform"])
            if waveform.ndim != 2 or waveform.shape[0] > waveform.shape[1]:
                raise ValueError(
                    "'waveform' must be a (channel, time) array")
            if "sample_rate" not in file:
                raise ValueError(
                    "'waveform' must be provided with 'sample_rate'")
            file.setdefault("uri", "waveform")
        elif "audio" in file:
            if isinstance(file["audio"], (str, Path)):
                path = Path(file["audio"])
                if not path.is_file():
                    raise ValueError(f"File {path} does not exist")
                file.setdefault("uri", path.stem)
        else:
            raise ValueError(AudioFileDocString)
        return file

    def __init__(self, sample_rate: Optional[int] = None,
                 mono: Optional[str] = "downmix"):
        self.sample_rate = sample_rate
        self.mono = mono

    def downmix_and_resample(self, waveform: np.ndarray, sample_rate: int
                             ) -> Tuple[np.ndarray, int]:
        """Downmix (or pick a random channel) and resample to
        ``sample_rate`` with the native windowed-sinc resampler."""
        if self.mono and waveform.shape[0] > 1:
            if self.mono == "downmix":
                waveform = waveform.mean(axis=0, keepdims=True)
            elif self.mono == "random":
                ch = np.random.randint(waveform.shape[0])
                waveform = waveform[ch:ch + 1]
        if self.sample_rate is not None and sample_rate != self.sample_rate:
            waveform = native.resample(waveform, sample_rate,
                                       self.sample_rate)
            sample_rate = self.sample_rate
        return np.ascontiguousarray(waveform, dtype=np.float32), sample_rate

    def get_duration(self, file: AudioFile) -> float:
        file = self.validate_file(file)
        if "waveform" in file:
            return np.asarray(file["waveform"]).shape[1] / file["sample_rate"]
        return get_audio_metadata(file).duration

    def get_num_samples(self, duration: float,
                        sample_rate: Optional[int] = None) -> int:
        sample_rate = sample_rate or self.sample_rate
        if sample_rate is None:
            raise ValueError("sample_rate must be provided")
        return int(round(duration * sample_rate))

    def __call__(self, file: AudioFile) -> Tuple[np.ndarray, int]:
        """Decode the whole file → ((channel, time) float32, sample_rate)."""
        file = self.validate_file(file)
        if "waveform" in file:
            waveform = np.asarray(file["waveform"], dtype=np.float32)
            sample_rate = int(file["sample_rate"])
        elif isinstance(file["audio"], (str, Path)):
            path = str(file["audio"])
            info = native.wav_info(path)
            if info is not None:
                sample_rate = info[0]
                waveform = native.wav_decode(path)
            else:
                try:
                    waveform, sample_rate = _decode_wav_bytes(
                        _read_bytes(path))
                except ValueError:
                    # not a RIFF container: FFmpeg-backed decode
                    waveform, sample_rate = _codec_decode_or_raise(path)
        else:
            waveform, sample_rate = _decode_wav_bytes(
                _read_bytes(file["audio"]))
        channel = file.get("channel")
        # zero-indexed; a truthiness test would skip channel 0. Skipped
        # when the batch machinery decoded the waveform: it is already
        # channel-selected and downmixed (channel k >= 1 of a mono cache
        # would slice it empty)
        if channel is not None and not file.get("_batch_decoded"):
            waveform = waveform[channel:channel + 1]
        return self.downmix_and_resample(waveform, sample_rate)

    def crop(
        self,
        file: AudioFile,
        segment: Segment,
        duration: Optional[float] = None,
        mode: str = "raise",
    ) -> Tuple[np.ndarray, int]:
        """Random-access crop.

        ``duration``: optional fixed output duration. mode='raise' errors
        on out-of-bounds; mode='pad' zero-pads. A WAV path is read by
        ranges (its parsed header cached in a mutable file dict, keyed on
        the file's mtime and size); a compressed file is decoded once and
        its waveform cached in the dict.
        """
        file = self.validate_file(file)
        if "waveform" in file:
            waveform = np.asarray(file["waveform"])
            sample_rate = int(file["sample_rate"])
            total = waveform.shape[1]
        elif "_codec_waveform" in file:
            waveform, sample_rate = file["_codec_waveform"]
            total = waveform.shape[1]
        else:
            raw = file.get("_bytes")
            meta = ranged_path = None
            if raw is None and isinstance(file["audio"], (str, Path)):
                # ranged access: read only the header now and seek to the
                # requested frames later; a file rewritten at the same
                # path never serves a stale cached header
                try:
                    stat = os.stat(file["audio"])
                    stat_key = (str(file["audio"]), stat.st_mtime_ns,
                                stat.st_size)
                except OSError:
                    stat_key = None
                cached = file.get("_wav_header")
                if cached is not None and stat_key is not None \
                        and cached[0] == stat_key:
                    _, meta, data_offset = cached
                    sample_rate, total = meta.sample_rate, meta.num_samples
                    waveform = None
                    ranged_path = file["audio"]
                else:
                    try:
                        with open(file["audio"], "rb") as f:
                            header = f.read(65536)
                        # only a header prefix is in memory: pass the real
                        # file size so the untrusted-size clamp doesn't
                        # truncate num_samples to the prefix length
                        meta, data_offset, _ = _parse_wav_header(
                            header,
                            total_size=stat.st_size if stat_key is not None
                            else os.path.getsize(file["audio"]))
                        sample_rate, total = (meta.sample_rate,
                                              meta.num_samples)
                        waveform = None
                        ranged_path = file["audio"]
                        if stat_key is not None:
                            try:
                                file["_wav_header"] = (stat_key, meta,
                                                       data_offset)
                            except TypeError:
                                pass  # immutable mapping: skip caching
                    except ValueError:
                        meta = None
            if meta is None:
                if raw is None:
                    raw = _read_bytes(file["audio"])
                try:
                    meta, _, _ = _parse_wav_header(raw)
                    sample_rate, total = meta.sample_rate, meta.num_samples
                    waveform = None
                except ValueError:
                    if not isinstance(file["audio"], (str, Path)):
                        raise
                    # non-WAV: compressed formats have no cheap random
                    # access -> decode once, cache in the file dict,
                    # slice from memory
                    waveform, sample_rate = _codec_decode_or_raise(
                        str(file["audio"]))
                    total = waveform.shape[1]
                    try:
                        file["_codec_waveform"] = (waveform, sample_rate)
                    except TypeError:
                        pass

        start_frame = int(round(segment.start * sample_rate))
        if duration is None:
            num_frames = int(round(segment.end * sample_rate)) - start_frame
        else:
            num_frames = int(round(duration * sample_rate))

        # clamp the read region into the file, then derive both pads from
        # the request, so the output is always exactly num_frames wide and
        # a request entirely outside the file is all zeros
        lo = min(max(0, start_frame), total)
        hi = min(max(start_frame + num_frames, lo), total)
        pad_start = min(num_frames, max(0, lo - start_frame))
        pad_end = num_frames - (hi - lo) - pad_start
        if (pad_start or pad_end) and mode == "raise":
            if start_frame + num_frames > total:
                raise ValueError(
                    f"requested chunk [{segment.start:.3f}s, "
                    f"{segment.start + num_frames / sample_rate:.3f}s] lies "
                    f"beyond file duration {total / sample_rate:.3f}s. "
                    f"Use mode='pad' to zero-pad.")
            raise ValueError(f"negative start time {segment.start:.3f}")
        if waveform is not None:
            data = waveform[:, lo:hi].astype(np.float32)
        elif ranged_path is not None:
            stride = (meta.bits_per_sample // 8) * meta.num_channels
            with open(ranged_path, "rb") as f:
                f.seek(data_offset + lo * stride)
                buf = f.read(max(0, hi - lo) * stride)
            data = _decode_pcm_frames(buf, meta)
        else:
            data, _ = _decode_wav_bytes(raw, frame_offset=lo,
                                        num_frames=hi - lo)
        if pad_start or pad_end:
            data = np.pad(data, ((0, 0), (pad_start, pad_end)))
        channel = file.get("channel")
        # zero-indexed; batch-decoded waveforms are already
        # channel-selected (see __call__)
        if channel is not None and not file.get("_batch_decoded"):
            data = data[channel:channel + 1]
        data, sample_rate = self.downmix_and_resample(data, sample_rate)
        if duration is not None and self.sample_rate is not None:
            want = self.get_num_samples(duration)
            if data.shape[1] < want:
                data = np.pad(data, ((0, 0), (0, want - data.shape[1])))
            data = data[:, :want]
        return data, sample_rate
