"""The port's Audio and native runtime against the JAX package's.

Inputs are seeded numpy waveforms written as WAV files of every layout
the JAX decoder reads. Held:

- decode: equal, bit for bit (PCM 8/16/24/32, float32/64, extensible,
  stereo, ``channel`` 0 and 1, downmix);
- resampling (44.1, 48 and 8 kHz to 16 kHz): within 1e-6, since the port
  compiles the same ``native/pat_audio.cc`` with other flags;
- ``crop`` in both modes, chunks wholly outside the file included, and
  ``get_audio_metadata``: equal;
- the fuzz corpus of tests/test_native_fuzz.py (truncated and hostile
  headers): the same header, or the same refusal, from the Python parser
  and from the native one, and the same samples where both decode;
- ``_predecode_batch``: the same waveforms as one-by-one decode.
"""

import struct

import numpy as np
import pytest

from pyannote_audio_tpu import native as jax_native
from pyannote_audio_tpu.core import io as jax_io
from pyannote_audio_tpu.core.segment import Segment as JaxSegment
from pyannote_audio_tpu_torch.core import io
from pyannote_audio_tpu_torch.core.pipeline import Pipeline
from pyannote_audio_tpu_torch.core.segment import Segment
from pyannote_audio_tpu_torch.utils import native
from test_native_fuzz import make_corpus
from test_torch_port_models import one_torch_thread  # noqa: F401


def _wave(channels, samples, seed):
    rng = np.random.default_rng(seed)
    return np.clip(0.3 * rng.standard_normal((channels, samples)), -1, 1
                   ).astype(np.float32)


def write_any_wav(path, waveform, sample_rate, bits=16, fmt=1,
                  extensible=False):
    """A (channel, time) waveform as a WAV of the given depth and format
    code (1 PCM, 3 float), optionally WAVE_FORMAT_EXTENSIBLE."""
    channels = waveform.shape[0]
    x = waveform.T
    if fmt == 3:
        data = x.astype("<f4" if bits == 32 else "<f8").tobytes()
    elif bits == 8:
        data = np.clip(np.rint(x * 128 + 128), 0, 255).astype(
            np.uint8).tobytes()
    elif bits == 16:
        data = np.clip(np.rint(x * 32768), -32768, 32767).astype(
            "<i2").tobytes()
    elif bits == 24:
        v = np.clip(np.rint(x * 2 ** 23), -2 ** 23, 2 ** 23 - 1).astype(
            np.int32).reshape(-1)
        data = np.stack([v & 255, (v >> 8) & 255, (v >> 16) & 255],
                        axis=1).astype(np.uint8).tobytes()
    else:
        data = np.clip(np.rint(x.astype(np.float64) * 2 ** 31), -2 ** 31,
                       2 ** 31 - 1).astype("<i4").tobytes()
    block = channels * bits // 8
    body = struct.pack("<HHIIHH", 0xFFFE if extensible else fmt, channels,
                       sample_rate, sample_rate * block, block, bits)
    if extensible:
        body += struct.pack("<HHI", 22, bits, 0) + struct.pack("<H", fmt) \
            + b"\x00\x00" + bytes(range(12))
    riff = b"WAVE" + b"fmt " + struct.pack("<I", len(body)) + body \
        + b"data" + struct.pack("<I", len(data)) + data
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", len(riff)) + riff)


LAYOUTS = [(1, 8, False), (1, 16, False), (1, 24, False), (1, 32, False),
           (3, 32, False), (3, 64, False), (1, 16, True), (3, 32, True)]


@pytest.mark.parametrize("fmt,bits,extensible", LAYOUTS)
@pytest.mark.parametrize("channels", [1, 2])
def test_decode_equal(tmp_path, fmt, bits, extensible, channels):
    path = tmp_path / "x.wav"
    write_any_wav(path, _wave(channels, 16000 + 77, seed=bits + channels),
                  16000, bits=bits, fmt=fmt, extensible=extensible)
    for mono in ("downmix", None):
        ours, sr = io.Audio(16000, mono=mono)(str(path))
        theirs, sr_jax = jax_io.Audio(16000, mono=mono)(str(path))
        assert sr == sr_jax == 16000
        assert ours.shape == theirs.shape
        np.testing.assert_array_equal(ours, theirs)
    assert io.get_audio_metadata(str(path)) == \
        io.AudioMetadata(**vars(jax_io.get_audio_metadata(str(path))))


@pytest.mark.parametrize("channel", [0, 1])
def test_channel_key(tmp_path, channel):
    path = tmp_path / "stereo.wav"
    write_any_wav(path, _wave(2, 8000, seed=3), 16000, bits=24)
    file = {"audio": str(path), "channel": channel}
    ours, _ = io.Audio(16000)(dict(file))
    theirs, _ = jax_io.Audio(16000)(dict(file))
    np.testing.assert_array_equal(ours, theirs)
    assert ours.shape == (1, 8000)
    ours, _ = io.Audio(16000).crop(dict(file), Segment(0.1, 0.3))
    theirs, _ = jax_io.Audio(16000).crop(dict(file), JaxSegment(0.1, 0.3))
    np.testing.assert_array_equal(ours, theirs)
    # a batch-decoded waveform is already channel-selected
    decoded = {"waveform": ours, "sample_rate": 16000, "channel": channel,
               "_batch_decoded": True}
    assert io.Audio(16000)(decoded)[0].shape == (1, ours.shape[1])


@pytest.mark.parametrize("rate", [44100, 48000, 8000])
def test_resample_within_1e6(tmp_path, rate):
    path = tmp_path / "r.wav"
    write_any_wav(path, _wave(2, rate * 2 + 5, seed=rate), rate, bits=16)
    ours, sr = io.Audio(16000)(str(path))
    theirs, _ = jax_io.Audio(16000)(str(path))
    assert sr == 16000 and ours.shape == theirs.shape
    np.testing.assert_allclose(ours, theirs, rtol=0, atol=1e-6)
    x = _wave(1, rate, seed=1)[0]
    np.testing.assert_allclose(native.resample(x, rate, 16000),
                               jax_native.resample(x, rate, 16000), atol=1e-6)


@pytest.mark.parametrize("mode", ["pad", "raise"])
@pytest.mark.parametrize("start,end,duration", [
    (0.25, 0.75, None), (0.9, 1.4, None), (-0.3, 0.2, None),
    (2.5, 3.0, None), (-2.0, -1.0, None), (0.5, 0.6, 0.4)])
def test_crop(tmp_path, mode, start, end, duration):
    path = tmp_path / "c.wav"
    write_any_wav(path, _wave(2, 16000, seed=7), 16000, bits=32)

    def run(module, segment):
        try:
            return module.Audio(16000).crop({"audio": str(path)}, segment,
                                            duration=duration, mode=mode)
        except ValueError as error:
            return type(error)

    ours = run(io, Segment(start, end))
    theirs = run(jax_io, JaxSegment(start, end))
    if isinstance(theirs, type):
        assert ours is theirs
        return
    np.testing.assert_array_equal(ours[0], theirs[0])
    assert ours[1] == theirs[1]
    # a resampled crop and a crop of an in-memory waveform agree too
    path48 = tmp_path / "c48.wav"
    write_any_wav(path48, _wave(1, 48000, seed=8), 48000, bits=16)
    for file in ({"audio": str(path48)},
                 {"waveform": _wave(1, 16000, seed=9), "sample_rate": 16000}):
        a = io.Audio(16000).crop(dict(file), Segment(start, end),
                                 duration=duration, mode="pad")[0]
        b = jax_io.Audio(16000).crop(dict(file), JaxSegment(start, end),
                                     duration=duration, mode="pad")[0]
        np.testing.assert_allclose(a, b, atol=1e-6)


def _parsed(module, raw):
    try:
        meta, offset, size = module._parse_wav_header(raw)
    except ValueError:
        return None
    return vars(meta), offset, size


def test_hostile_headers_as_jax(tmp_path):
    corpus = make_corpus(400)
    agreed = 0
    for i, raw in enumerate(corpus):
        assert _parsed(io, raw) == _parsed(jax_io, raw), i
        path = str(tmp_path / f"case{i}.wav")
        with open(path, "wb") as f:
            f.write(raw)
        info = native.wav_info(path)
        assert info == jax_native.wav_info(path), i
        if info is not None and info[1] * max(info[2], 1) < 10 ** 7:
            ours, theirs = native.wav_decode(path), jax_native.wav_decode(path)
            np.testing.assert_array_equal(ours, theirs)
            agreed += 1
    assert agreed > 20


def test_predecode_batch_matches_one_by_one(tmp_path):
    files = []
    for k, (rate, bits, channels) in enumerate(
            [(16000, 16, 1), (44100, 24, 2), (48000, 16, 1)]):
        path = tmp_path / f"p{k}.wav"
        write_any_wav(path, _wave(channels, rate * (k + 1), seed=k), rate,
                      bits=bits)
        files.append({"audio": str(path), "uri": f"p{k}"})
    pipeline = Pipeline()
    batch = [dict(f) for f in files]
    pipeline._predecode_batch(batch)
    for f, g in zip(batch, files):
        assert f["_batch_decoded"] and f["sample_rate"] == 16000
        one, _ = io.Audio(16000)(dict(g))
        assert f["waveform"].shape == one.shape
        np.testing.assert_allclose(f["waveform"], one, atol=1e-6)
        # the batch-decoded dict reads back as it is
        np.testing.assert_array_equal(io.Audio(16000)(f)[0], f["waveform"])


def test_non_wav_without_codec_raises(tmp_path, monkeypatch):
    path = tmp_path / "x.flac"
    path.write_bytes(b"fLaC" + bytes(100))
    monkeypatch.setattr(native, "_codec", lambda: None)
    with pytest.raises(ValueError, match="native codec library"):
        io.Audio(16000)(str(path))


def test_codec_decode_as_jax(tmp_path):
    """FLAC through the FFmpeg-backed decoder, where the port could build
    it (it needs FFmpeg's headers) and the JAX package's loads."""
    if not native.codec_available() or not jax_native.codec_available():
        pytest.skip("the codec library was not built here (no FFmpeg "
                    "headers)")
    path = str(tmp_path / "x.flac")
    assert jax_native.codec_encode(path, _wave(1, 16000, seed=5), 16000)
    ours, sr = io.Audio(16000)(path)
    theirs, sr_jax = jax_io.Audio(16000)(path)
    assert sr == sr_jax
    np.testing.assert_array_equal(ours, theirs)
    assert io.get_audio_metadata(path) == \
        io.AudioMetadata(**vars(jax_io.get_audio_metadata(path)))


def test_read_and_write_wav_roundtrip(tmp_path):
    path = tmp_path / "w.wav"
    x = _wave(2, 1000, seed=11)
    io.write_wav(path, x, 16000)
    y, sr = io.read_wav(path)
    assert sr == 16000 and y.shape == x.shape
    np.testing.assert_allclose(y, x, atol=1 / 32768)
    assert io.Audio(16000).get_duration(str(path)) == 1000 / 16000
    assert io.Audio().get_num_samples(0.5, 16000) == 8000
    np.testing.assert_allclose(io.Audio.power_normalize(x),
                               jax_io.Audio.power_normalize(x))
