"""Audio decoding: PCM16 WAV files and in-memory waveforms, mono 16 kHz.

Counterpart of pyannote_audio_tpu/core/io.py for the diarization path.
Pure numpy and the standard library. Waveforms are float32 arrays shaped
(channel, time), PCM16 samples scaled as i / 32768 exactly like the JAX
package's decoder. Other encodings, resampling, the native C++ decoder
and FFmpeg decode are not part of this module.
"""

from __future__ import annotations

import struct
from collections.abc import Mapping, MutableMapping
from pathlib import Path
from typing import Tuple, Union

import numpy as np

AudioFile = Union[str, Path, Mapping]


def _parse_pcm16_wav(raw: bytes) -> Tuple[int, int, int, int]:
    """RIFF/WAVE header -> (num_channels, sample_rate, data_offset,
    data_size), validated as 16-bit PCM; the advertised data size is
    clamped to the bytes present."""
    if len(raw) < 44 or raw[:4] != b"RIFF" or raw[8:12] != b"WAVE":
        raise ValueError("not a RIFF/WAVE file")
    pos, fmt, data = 12, None, None
    while pos + 8 <= len(raw) and (fmt is None or data is None):
        chunk_id = raw[pos:pos + 4]
        size = struct.unpack_from("<I", raw, pos + 4)[0]
        if chunk_id == b"fmt ":
            if size < 16 or pos + 24 > len(raw):
                raise ValueError("corrupt WAV fmt chunk")
            fmt = struct.unpack_from("<HHIIHH", raw, pos + 8)
        elif chunk_id == b"data":
            data = (pos + 8, size)
        pos += 8 + size + (size & 1)
    if fmt is None or data is None:
        raise ValueError("WAV file missing fmt or data chunk")
    audio_format, num_channels, sample_rate, _, _, bits = fmt
    if audio_format not in (1, 0xFFFE) or bits != 16:
        raise ValueError(f"only 16-bit PCM WAV is supported, got format "
                         f"{audio_format} with {bits} bits")
    if num_channels < 1 or sample_rate < 1:
        raise ValueError("WAV header declares no channels or no rate")
    offset, size = data
    return num_channels, sample_rate, offset, min(size, len(raw) - offset)


def read_wav(path: Union[str, Path]) -> Tuple[np.ndarray, int]:
    """16-bit PCM WAV -> ((channel, time) float32, sample_rate)."""
    raw = Path(path).read_bytes()
    num_channels, sample_rate, offset, size = _parse_pcm16_wav(raw)
    frame = 2 * num_channels
    pcm = np.frombuffer(raw, dtype="<i2", count=(size // frame)
                        * num_channels, offset=offset)
    waveform = pcm.astype(np.float32) / np.float32(32768.0)
    return np.ascontiguousarray(waveform.reshape(-1, num_channels).T), \
        sample_rate


def write_wav(path: Union[str, Path], waveform: np.ndarray,
              sample_rate: int) -> None:
    """Write a (channel, time) float waveform as 16-bit PCM WAV."""
    waveform = np.asarray(waveform)
    if waveform.ndim == 1:
        waveform = waveform[None]
    pcm = np.clip(np.rint(waveform.T * 32768.0), -32768, 32767).astype("<i2")
    data = pcm.tobytes()
    num_channels = waveform.shape[0]
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", 36 + len(data)) + b"WAVEfmt ")
        f.write(struct.pack("<IHHIIHH", 16, 1, num_channels, sample_rate,
                            sample_rate * num_channels * 2,
                            num_channels * 2, 16))
        f.write(b"data" + struct.pack("<I", len(data)) + data)


class Audio:
    """Decode + downmix to mono at a fixed sample rate."""

    def __init__(self, sample_rate: int = 16000):
        self.sample_rate = sample_rate

    @staticmethod
    def validate_file(file: AudioFile) -> MutableMapping:
        """Path -> {"audio", "uri"}; mappings are checked (mutable ones in
        place, so pipelines can cache per-file state in them)."""
        if isinstance(file, (str, Path)):
            file = {"audio": str(file), "uri": Path(file).stem}
        elif isinstance(file, Mapping) and \
                not isinstance(file, MutableMapping):
            file = dict(file)
        elif not isinstance(file, MutableMapping):
            raise ValueError("an audio file is a WAV path or a mapping with "
                             "'audio' or 'waveform' + 'sample_rate'")
        if "waveform" in file:
            waveform = np.asarray(file["waveform"])
            if waveform.ndim != 2 or waveform.shape[0] > waveform.shape[1]:
                raise ValueError("'waveform' must be a (channel, time) array")
            if "sample_rate" not in file:
                raise ValueError(
                    "'waveform' must be provided with 'sample_rate'")
            file.setdefault("uri", "waveform")
        elif "audio" in file:
            path = Path(file["audio"])
            if not path.is_file():
                raise ValueError(f"File {path} does not exist")
            file.setdefault("uri", path.stem)
        else:
            raise ValueError("an audio file mapping needs 'audio' or "
                             "'waveform'")
        return file

    def get_duration(self, file: AudioFile) -> float:
        """Seconds of audio: of the in-memory waveform, or from the WAV
        header (nothing is decoded)."""
        file = self.validate_file(file)
        if "waveform" in file:
            return np.asarray(file["waveform"]).shape[1] / file["sample_rate"]
        with open(file["audio"], "rb") as f:
            raw = f.read()
        num_channels, sample_rate, _, size = _parse_pcm16_wav(raw)
        return size // (2 * num_channels) / sample_rate

    def __call__(self, file: AudioFile) -> Tuple[np.ndarray, int]:
        """Decode the whole file -> ((1, time) float32, sample_rate)."""
        file = self.validate_file(file)
        if "waveform" in file:
            waveform = np.asarray(file["waveform"], dtype=np.float32)
            sample_rate = int(file["sample_rate"])
        else:
            waveform, sample_rate = read_wav(file["audio"])
        if sample_rate != self.sample_rate:
            raise ValueError(f"expected {self.sample_rate} Hz audio, got "
                             f"{sample_rate} Hz (resampling is not ported)")
        if waveform.shape[0] > 1:
            waveform = waveform.mean(axis=0, keepdims=True)
        return np.ascontiguousarray(waveform, dtype=np.float32), sample_rate
