"""The port's pipelined ``apply_batch`` and the generic batch path, on the
CPU (the JAX package's tests/test_pipeline.py, tests/test_longfile.py and
tests/test_inference_extra.py checks of the same machinery).

Held, all exactly (the batch path runs the same programs as ``apply``):
- ``apply_batch`` equals sequential ``apply``: Annotations, exclusive
  Annotations and centroids, at every staging depth, whole and in slices;
- staging order and decode lead: file i + stage_ahead is staged before
  file i is finalized, and no file is decoded more than stage_ahead + 1
  files ahead of staging;
- eviction: a finalized file's ``_device_waveform`` and
  ``_longfile_uploads`` go, its waveform only when the batch decoded it;
- a missing or corrupt file raises a clean ValueError, and a clean batch
  runs afterwards;
- the generic ``_apply_batch`` path (no ``apply_batch``) matches too,
  preloading every file;
- a silent file yields empty Annotations and no centroid.
"""

import threading

import numpy as np
import pytest
import torch

from corpus import default_two_speaker_file
from pyannote_audio_tpu_torch.core.io import write_wav
from pyannote_audio_tpu_torch.pipelines.speaker_diarization import \
    SpeakerDiarization
from test_torch_port_longfile import PARAMS
from test_torch_port_models import (jax_pyannet, jax_wespeaker,
                                    torch_pyannet_from, torch_wespeaker_from)

SR = 16000


@pytest.fixture(scope="module")
def models():
    return jax_pyannet(duration=5.0, seed=41), jax_wespeaker(seed=42)


def _pipeline(models):
    seg, emb = models
    pipeline = SpeakerDiarization(
        torch_pyannet_from(seg), torch_wespeaker_from(emb),
        segmentation_batch_size=8, embedding_batch_size=8, device="cpu")
    return pipeline.instantiate(PARAMS)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """Three corpus files of 30, 34.3 and 29.5 s, a short quiet one between
    them (another chunk grid and its zero-padded tail) and one given as a
    waveform."""
    root = tmp_path_factory.mktemp("batch")
    out = []
    for i, seconds in enumerate((30.0, 34.3, 29.5)):
        f = default_two_speaker_file(root / f"s{i}.wav", duration=seconds)
        out.append({"audio": f["audio"], "uri": f"s{i}"})
    quiet = (0.001 * np.random.default_rng(0).standard_normal(
        (1, 12 * SR))).astype(np.float32)
    write_wav(root / "quiet.wav", quiet, SR)
    out.insert(1, {"audio": str(root / "quiet.wav"), "uri": "quiet"})
    wav = (0.1 * np.random.default_rng(1).standard_normal(
        (1, int(14.5 * SR)))).astype(np.float32)
    out.append({"waveform": wav, "sample_rate": SR, "uri": "in_memory"})
    return out


def _assert_same(outputs, expected):
    assert len(outputs) == len(expected)
    for ours, theirs in zip(outputs, expected):
        for name in ("speaker_diarization", "exclusive_speaker_diarization"):
            a, b = getattr(ours, name), getattr(theirs, name)
            assert a.uri == b.uri
            assert list(a.itertracks(yield_label=True)) == \
                list(b.itertracks(yield_label=True))
        np.testing.assert_array_equal(ours.speaker_embeddings,
                                      theirs.speaker_embeddings)


@pytest.fixture(scope="module")
def sequential(models, files):
    pipeline = _pipeline(models)
    return [pipeline(dict(f), max_speakers=3) for f in files]


@pytest.mark.parametrize("stage_ahead", [0, 1, 2, 4])
def test_apply_batch_equals_sequential(models, files, sequential,
                                       stage_ahead):
    pipeline = _pipeline(models)
    batch = [dict(f) for f in files]
    if stage_ahead == 2:                          # the default, via __call__
        outputs = pipeline(batch, max_speakers=3)
    else:
        outputs = pipeline.apply_batch(batch, stage_ahead=stage_ahead,
                                       max_speakers=3)
    _assert_same(outputs, sequential)
    assert [o.speaker_diarization.uri for o in outputs] == \
        [f["uri"] for f in files]


def test_apply_batch_in_slices_equals_sequential(models, files, monkeypatch):
    """Forced 12 s slices: the batch path shares the slice uploads between
    stages and evicts them with the file."""
    monkeypatch.setenv("PYANNOTE_TPU_SEGMENT_MINUTES", "0.2")
    monkeypatch.setenv("PYANNOTE_TPU_SEGMENT_HALO_SECONDS", "4.0")
    pipeline = _pipeline(models)
    expected = [pipeline(dict(f), max_speakers=3) for f in files]
    batch = [dict(f) for f in files]
    _assert_same(pipeline(batch, max_speakers=3), expected)
    for f in batch:
        assert "_longfile_uploads" not in f and "_device_waveform" not in f


def test_staging_order_and_decode_lead(models, files, monkeypatch):
    pipeline = _pipeline(models)
    events, lock = [], threading.Lock()
    stage, finalize = pipeline._stage, pipeline._finalize
    decode = pipeline._decode_into
    staged = {"count": 0}
    uris = [f["uri"] for f in files]

    def spy_stage(file, **kwargs):
        events.append(("stage", file["uri"]))
        out = stage(file, **kwargs)
        staged["count"] += 1
        return out

    def spy_finalize(state):
        events.append(("finalize", state["file"]["uri"]))
        return finalize(state)

    def spy_decode(file, preload=True):
        assert preload is False            # staging orders the uploads
        with lock:
            lead = uris.index(file["uri"]) - staged["count"]
            events.append(("decode", file["uri"], lead))
        return decode(file, preload)

    monkeypatch.setattr(pipeline, "_stage", spy_stage)
    monkeypatch.setattr(pipeline, "_finalize", spy_finalize)
    monkeypatch.setattr(pipeline, "_decode_into", spy_decode)
    pipeline.apply_batch([dict(f) for f in files], stage_ahead=1,
                         max_speakers=3)
    order = [e[:2] for e in events if e[0] != "decode"]
    expected = []
    for i, uri in enumerate(uris):
        expected.append(("stage", uri))
        if i >= 1:
            expected.append(("finalize", uris[i - 1]))
    expected.append(("finalize", uris[-1]))
    assert order == expected
    decoded = [e for e in events if e[0] == "decode"]
    assert sorted(e[1] for e in decoded) == sorted(uris)     # once each
    assert max(e[2] for e in decoded) <= 1 + 1               # stage_ahead + 1


def test_eviction_keeps_only_given_waveforms(models, files):
    pipeline = _pipeline(models)
    batch = [dict(f) for f in files]
    pipeline(batch, max_speakers=3)
    for f, given in zip(batch, files):
        assert "_device_waveform" not in f
        assert "_longfile_uploads" not in f
        assert "_batch_decoded" not in f
        if "waveform" in given:
            assert f["waveform"] is given["waveform"]
        else:
            assert "waveform" not in f and "sample_rate" not in f


def test_missing_and_corrupt_files_raise_cleanly(models, files, tmp_path):
    pipeline = _pipeline(models)
    with pytest.raises(ValueError, match="does not exist"):
        pipeline([dict(files[0]), {"audio": str(tmp_path / "nope.wav")}])
    corrupt = tmp_path / "corrupt.wav"
    corrupt.write_bytes(b"not a wav file at all" * 8)
    before = threading.active_count()
    with pytest.raises(ValueError, match="RIFF"):
        pipeline([dict(files[0]), {"audio": str(corrupt)}, dict(files[2])],
                 max_speakers=3)
    assert threading.active_count() == before        # decode threads joined
    out = pipeline([dict(files[0])], max_speakers=3)
    assert len(out) == 1 and len(out[0].speaker_diarization) > 0


def test_generic_batch_path_matches(models, files, sequential, monkeypatch):
    pipeline = _pipeline(models)
    preloaded = []
    preload = pipeline.preload
    monkeypatch.setattr(pipeline, "apply_batch", None)
    monkeypatch.setattr(pipeline, "preload",
                        lambda f: preloaded.append(f["uri"]) or preload(f))
    batch = [dict(f) for f in files]
    _assert_same(pipeline(batch, max_speakers=3), sequential)
    assert sorted(preloaded) == sorted(f["uri"] for f in files)
    for f, given in zip(batch, files):
        assert "_device_waveform" not in f
        assert ("waveform" in f) == ("waveform" in given)


def test_silent_file_in_a_batch(models, files, monkeypatch):
    """Scores of zeros everywhere: the count is 0, so ``_finalize`` returns
    empty Annotations, after the device program was queued anyway."""
    pipeline = _pipeline(models)
    monkeypatch.setattr(pipeline._segmentation, "_convert",
                        lambda out: torch.zeros(out.shape[:-1] + (3,)))
    outputs = pipeline([dict(f) for f in files[:2]], max_speakers=3)
    for out, f in zip(outputs, files):
        assert out.speaker_diarization.uri == f["uri"]
        assert not len(out.speaker_diarization)
        assert not len(out.exclusive_speaker_diarization)
        assert out.speaker_embeddings.shape == (
            0, pipeline._embedding.dimension)


def test_apply_is_stage_then_finalize(models, files):
    """On the CPU the staged results are the device tensors themselves,
    and there is no event to wait for."""
    pipeline = _pipeline(models)
    staged = pipeline._stage(dict(files[0]), max_speakers=3)
    assert staged["event"] is None
    assert set(staged["host"]) == {"count", "speaker_frames", "clean_frames",
                                   "embeddings"}
    assert staged["host"]["count"].dtype == torch.uint8
    num_chunks = staged["scores"].shape[0]
    assert staged["host"]["embeddings"].shape[:2] == (num_chunks, 3)
    _assert_same([pipeline._finalize(staged)],
                 [pipeline(dict(files[0]), max_speakers=3)])
