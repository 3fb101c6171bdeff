"""ctypes bindings of the native audio runtime.

Counterpart of pyannote_audio_tpu/native/__init__.py. The port compiles
the same C++ sources itself (``utils/build.py``: ``g++ -O3 -shared -fPIC
-pthread -std=c++17`` into ``_build/`` at first use) and never loads the
JAX package's prebuilt libraries:

- ``native/pat_audio.cc``: WAV header parsing and decode (PCM 8/16/24/32,
  float32/64, WAVE_FORMAT_EXTENSIBLE), a windowed-sinc polyphase
  resampler and a multithreaded batch decode + downmix + resample. Its
  build is required: a failure raises.
- ``native/pat_codec.cc``: any format FFmpeg reads (FLAC, MP3, OGG, ...).
  It builds only where FFmpeg's headers and libraries are found; without
  them ``codec_info`` and ``codec_decode`` return None and ``core/io.py``
  raises on a file that is not a WAV.

The transport encoder of the JAX package's TPU upload (``pat_dpcm4_encode``)
is not bound. The C calls release the GIL, so decode in a worker thread
overlaps the caller's work.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, Optional, Tuple

import numpy as np

from .build import load_host

CODEC_LIBS = ("-lavformat", "-lavcodec", "-lavutil", "-lswresample")

_FLOATS = ctypes.POINTER(ctypes.c_float)


@functools.lru_cache(maxsize=None)
def _audio() -> ctypes.CDLL:
    lib = load_host("pat_audio")
    lib.pat_wav_info.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_longlong)]
    lib.pat_wav_info.restype = ctypes.c_int
    lib.pat_wav_decode.argtypes = [ctypes.c_char_p, ctypes.c_longlong,
                                   ctypes.c_longlong, _FLOATS]
    lib.pat_wav_decode.restype = ctypes.c_longlong
    lib.pat_resample.argtypes = [_FLOATS, ctypes.c_longlong, ctypes.c_int,
                                 ctypes.c_int, _FLOATS, ctypes.c_longlong]
    lib.pat_resample.restype = ctypes.c_longlong
    lib.pat_batch_decode_resample.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
        _FLOATS, ctypes.c_longlong, ctypes.POINTER(ctypes.c_longlong)]
    lib.pat_batch_decode_resample.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _codec() -> Optional[ctypes.CDLL]:
    try:
        lib = load_host("pat_codec", CODEC_LIBS)
    except (RuntimeError, OSError):     # no FFmpeg headers or libraries
        return None
    lib.pat_codec_info.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_longlong)]
    lib.pat_codec_info.restype = ctypes.c_int
    lib.pat_codec_decode_alloc.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(_FLOATS),
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
    lib.pat_codec_decode_alloc.restype = ctypes.c_longlong
    lib.pat_codec_free.argtypes = [_FLOATS]
    lib.pat_codec_free.restype = None
    return lib


def codec_available() -> bool:
    """Was the FFmpeg-backed decoder built (and does it load)?"""
    return _codec() is not None


def wav_info(path: str) -> Optional[Tuple[int, int, int]]:
    """(sample_rate, channels, num_frames) of a WAV file, or None when
    the file is not a WAV the decoder reads."""
    sr, ch, n = ctypes.c_int(), ctypes.c_int(), ctypes.c_longlong()
    if _audio().pat_wav_info(str(path).encode(), ctypes.byref(sr),
                             ctypes.byref(ch), ctypes.byref(n)) != 0:
        return None
    return sr.value, ch.value, n.value


def wav_decode(path: str, frame_offset: int = 0,
               num_frames: int = -1) -> Optional[np.ndarray]:
    """(channels, frames) float32 of a WAV file (zero-filled past its
    end), or None when it is not a WAV the decoder reads."""
    info = wav_info(path)
    if info is None:
        return None
    _, ch, total = info
    if num_frames < 0:
        num_frames = total - frame_offset
    out = np.empty((ch, num_frames), dtype=np.float32)
    if _audio().pat_wav_decode(str(path).encode(), frame_offset, num_frames,
                               out.ctypes.data_as(_FLOATS)) < 0:
        return None
    return out


def resample(waveform: np.ndarray, in_rate: int, out_rate: int
             ) -> np.ndarray:
    """Per-channel windowed-sinc resampling of a (channels, samples) or
    (samples,) float32 waveform to floor(samples * out / in) samples."""
    waveform = np.ascontiguousarray(waveform, dtype=np.float32)
    squeeze = waveform.ndim == 1
    if squeeze:
        waveform = waveform[None]
    out_len = int(waveform.shape[1] * out_rate / in_rate)
    out = np.empty((waveform.shape[0], out_len), dtype=np.float32)
    for c in range(waveform.shape[0]):
        n = _audio().pat_resample(waveform[c].ctypes.data_as(_FLOATS),
                                  waveform.shape[1], in_rate, out_rate,
                                  out[c].ctypes.data_as(_FLOATS), out_len)
        if n < 0:
            raise RuntimeError(f"pat_resample failed ({n}) from {in_rate} "
                               f"to {out_rate} Hz")
    return out[0] if squeeze else out


def batch_decode_resample(paths: List[str], target_rate: int,
                          max_seconds: float
                          ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Decode, downmix and resample WAV files in parallel into one
    (n, samples) buffer, short files zero-padded; returns it with each
    file's length, or None when a file could not be decoded."""
    n = len(paths)
    max_len = int(max_seconds * target_rate)
    out = np.empty((n, max_len), dtype=np.float32)
    lengths = np.empty(n, dtype=np.int64)
    names = (ctypes.c_char_p * n)(*[str(p).encode() for p in paths])
    if _audio().pat_batch_decode_resample(
            names, n, target_rate, out.ctypes.data_as(_FLOATS), max_len,
            lengths.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong))) < 0:
        return None
    return out, lengths


def codec_info(path: str) -> Optional[Tuple[int, int, int]]:
    """(sample_rate, channels, num_frames) of any FFmpeg-readable file
    (num_frames estimated from the duration for lossy codecs), or None."""
    lib = _codec()
    if lib is None:
        return None
    sr, ch, n = ctypes.c_int(), ctypes.c_int(), ctypes.c_longlong()
    if lib.pat_codec_info(str(path).encode(), ctypes.byref(sr),
                          ctypes.byref(ch), ctypes.byref(n)) != 0:
        return None
    return sr.value, ch.value, n.value


def codec_decode(path: str) -> Optional[Tuple[np.ndarray, int]]:
    """((channels, frames) float32, sample_rate) of any FFmpeg-readable
    file, or None."""
    lib = _codec()
    if lib is None:
        return None
    buf, ch, sr = _FLOATS(), ctypes.c_int(), ctypes.c_int()
    frames = lib.pat_codec_decode_alloc(str(path).encode(), ctypes.byref(buf),
                                        ctypes.byref(ch), ctypes.byref(sr))
    if frames < 0:
        return None
    try:
        out = np.ctypeslib.as_array(buf, shape=(ch.value, int(frames))).copy()
    finally:
        lib.pat_codec_free(buf)
    return out, sr.value
