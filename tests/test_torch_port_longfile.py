"""Bounded device memory for long files: the port's core/longfile.py and
its slice paths against the JAX package's, on the CPU.

Held:
- the host functions (``plan_slices``, ``segment_minutes``,
  ``halo_samples``, ``retained_upload_bytes_ok`` with the JAX package's
  float32 transport, ``diarization_resident_hbm_bytes``) equal to the JAX
  package's, exactly, over a grid of lengths and settings;
- ``Inference.slide`` in forced slices equal to whole-file buffers within
  1e-5 (shared sinc front-end on and off, and the zero-padded tail that
  the last slice must cover), and to the JAX package's sliced slide
  within 2e-4 (the PyanNet bound of tests/test_torch_port_models.py), on
  log-probabilities;
- sliced ``get_embeddings`` against whole-file buffers at cosine > 0.999
  and atol / rtol 5e-3 (tests/test_longfile.py's bounds), on each of the
  three embedding paths, with no slice upload left cached;
- the whole pipeline on the 40 s corpus file, sliced against whole: the
  same labels and boundaries within 0.05 s.
"""

import numpy as np
import pytest
import torch

from corpus import default_two_speaker_file
from pyannote_audio_tpu.core import longfile as jax_longfile
from pyannote_audio_tpu.core.inference import Inference as JaxInference
from pyannote_audio_tpu.utils import flops as jax_flops
from pyannote_audio_tpu_torch.core import longfile
from pyannote_audio_tpu_torch.core.inference import Inference, _chunk_grid
from pyannote_audio_tpu_torch.core.io import Audio
from pyannote_audio_tpu_torch.pipelines.speaker_diarization import \
    SpeakerDiarization
from pyannote_audio_tpu_torch.utils import flops
from test_torch_port_fastpaths import PANELS
from test_torch_port_models import (jax_pyannet, jax_wespeaker,
                                    torch_pyannet_from, torch_wespeaker_from)

SR = 16000
KNOBS = ("PYANNOTE_TPU_SEGMENT_MINUTES", "PYANNOTE_TPU_HBM_BUDGET_GB",
         "PYANNOTE_TPU_SEGMENT_HALO_SECONDS")
PARAMS = {"segmentation": {"min_duration_off": 0.0},
          "clustering": {"method": "centroid", "threshold": 0.6,
                         "min_cluster_size": 1}}


def set_knobs(mp, minutes=None, budget=None, halo=None):
    for name, value in zip(KNOBS, (minutes, budget, halo)):
        if value is None:
            mp.delenv(name, raising=False)
        else:
            mp.setenv(name, value)


def _keys(cache):
    return [k for k in cache if isinstance(k, tuple)]


def _as_tuples(plan):
    return None if plan is None else [(s.a, s.b, s.i0, s.i1) for s in plan]


# -- host functions: exact equality with the JAX package ------------------

SETTINGS = [
    {}, {"minutes": "0"}, {"minutes": "3"}, {"minutes": "0.2", "halo": "4"},
    {"budget": "1.0"}, {"budget": "0.5", "halo": "5.0"},
    {"minutes": "60", "halo": "0"}, {"budget": "not-a-number"},
    {"minutes": "0.05", "halo": "20"}]
LENGTHS_SECONDS = [5.0, 41.007, 600.0, 3600.0, 2 * 3600.0, 132 * 60.0,
                   150 * 60.0, 6 * 3600.0, 40 * 3600.0]


@pytest.mark.parametrize("setting", SETTINGS,
                         ids=["-".join(f"{k}={v}" for k, v in s.items())
                              or "defaults" for s in SETTINGS])
def test_plan_matches_jax(monkeypatch, setting):
    set_knobs(monkeypatch, **setting)
    assert longfile.halo_samples(SR) == jax_longfile.halo_samples(SR)
    for window, step in ((10 * SR, SR), (2 * SR, SR // 2)):
        for seconds in LENGTHS_SECONDS:
            n = int(seconds * SR)
            assert longfile.segment_minutes(seconds, SR) == \
                jax_longfile.segment_minutes(seconds, SR)
            starts, _ = _chunk_grid(n, window, step)
            jax_starts, _ = jax_longfile_grid(n, window, step)
            np.testing.assert_array_equal(starts, jax_starts)
            plan = longfile.plan_slices(n, window, step, SR, starts)
            expected = jax_longfile.plan_slices(n, window, step, SR,
                                                jax_starts)
            assert _as_tuples(plan) == _as_tuples(expected), (seconds,
                                                              window)


def jax_longfile_grid(n, window, step):
    from pyannote_audio_tpu.core.inference import _chunk_grid as jax_grid
    return jax_grid(n, window, step, SR)


def test_bad_minutes_warns_and_falls_back_like_jax(monkeypatch):
    set_knobs(monkeypatch, minutes="auto")
    with pytest.warns(UserWarning, match="SEGMENT_MINUTES"):
        ours = longfile.segment_minutes(6 * 3600.0)
    with pytest.warns(UserWarning, match="SEGMENT_MINUTES"):
        expected = jax_longfile.segment_minutes(6 * 3600.0)
    assert ours == expected is not None                # auto mode slices


def test_forced_slice_past_int32_raises_like_jax(monkeypatch):
    set_knobs(monkeypatch, minutes="2400")                       # 40 h
    n = 45 * 3600 * SR
    starts = np.arange(0, n - 10 * SR + SR, SR, dtype=np.int64)
    for plan_slices in (longfile.plan_slices, jax_longfile.plan_slices):
        with pytest.raises(ValueError, match="SEGMENT_MINUTES"):
            plan_slices(n, 10 * SR, SR, SR, starts)


def test_150_minutes_takes_the_jax_plan(monkeypatch):
    """The auto plan of chip_smoke.py's check (h): 3 slices, bounds as the
    JAX package gives them."""
    import chip_smoke
    set_knobs(monkeypatch)
    n = int(150 * 60 * SR)
    starts, _ = _chunk_grid(n, 10 * SR, SR)
    plan = longfile.plan_slices(n, 10 * SR, SR, SR, starts)
    assert _as_tuples(plan) == chip_smoke.LONG_PLAN
    assert longfile.segment_minutes(150 * 60.0) == 60.0
    assert longfile.segment_minutes(120 * 60.0) is None


@pytest.mark.parametrize("budget", [None, "6.0", "0.1", "40"])
def test_retained_upload_bytes_match_jax_float32(monkeypatch, budget):
    set_knobs(monkeypatch, budget=budget)
    monkeypatch.setenv("PYANNOTE_TPU_UPLOAD_QUANT", "f32")
    for hours in (0.01, 0.5, 1.0, 1.6, 2.0, 10.0, 30.0):
        n = int(hours * 3600 * SR)
        assert longfile.retained_upload_bytes_ok(n) == \
            jax_longfile.retained_upload_bytes_ok(n), hours


def test_resident_memory_model_matches_jax():
    for seconds in [0.5, 10.0] + LENGTHS_SECONDS:
        for kwargs in ({}, {"window": 5.0, "step": 0.5}, {"trunk_stride": 4},
                       {"fixed_bytes": 0}):
            assert flops.diarization_resident_hbm_bytes(seconds, **kwargs) \
                == jax_flops.diarization_resident_hbm_bytes(seconds,
                                                            **kwargs)
    assert flops.conv1d_out(1000, 251, 10) == \
        jax_flops.conv1d_out(1000, 251, 10)


# -- slice_uploads ----------------------------------------------------------

def _plan_for(seconds, minutes, halo, window=2 * SR, step=SR // 2,
              mp=None):
    set_knobs(mp, minutes=minutes, halo=halo)
    n = int(seconds * SR)
    starts, _ = _chunk_grid(n, window, step)
    return longfile.plan_slices(n, window, step, SR, starts), starts


def test_slice_uploads_shared_released_and_fingerprinted(monkeypatch):
    plan, starts = _plan_for(20.0, "0.1", "1.0", mp=monkeypatch)
    assert plan is not None and len(plan) > 1
    wav = (0.05 * np.random.default_rng(0).standard_normal(
        (1, 20 * SR))).astype(np.float32)
    file = {}
    get, release = longfile.slice_uploads(file, wav, plan, SR, starts,
                                          2 * SR, "cpu")
    buf0 = get(0)
    assert buf0.dtype == torch.float32
    get_again, _ = longfile.slice_uploads(file, wav, plan, SR, starts,
                                          2 * SR, "cpu")
    assert get_again(0) is buf0                      # one upload, shared
    np.testing.assert_array_equal(
        buf0[:, :plan[0].b - plan[0].a].numpy(),
        wav[:, plan[0].a:plan[0].b])
    release(0)
    assert not _keys(file["_longfile_uploads"])
    buf0 = get(0)
    changed = wav.copy()
    changed[0, 1000] += 0.5
    get_changed, _ = longfile.slice_uploads(file, changed, plan, SR, starts,
                                            2 * SR, "cpu")
    assert get_changed(0) is not buf0                # stale audio refused
    # a tensor waveform is not cached in the file dict
    other = {}
    get_tensor, _ = longfile.slice_uploads(other, torch.from_numpy(wav),
                                           plan, SR, starts, 2 * SR, "cpu")
    get_tensor(1)
    assert "_longfile_uploads" not in other


def test_release_is_slice_scoped_with_shared_bounds(monkeypatch):
    plan, starts = _plan_for(10.0, "0.05", "20.0", mp=monkeypatch)
    assert len(plan) >= 2 and (plan[0].a, plan[0].b) == (plan[1].a,
                                                          plan[1].b)
    wav = np.zeros((1, 10 * SR), np.float32)
    file = {}
    get, release = longfile.slice_uploads(file, wav, plan, SR, starts,
                                          2 * SR, "cpu")
    buf1 = get(1)
    get(0)
    release(0)
    keys = _keys(file["_longfile_uploads"])
    assert keys and all(key[0] == 1 for key in keys)
    assert get(1) is buf1


def test_last_slice_covers_the_zero_padded_tail(monkeypatch):
    """The JAX package's tail-shortfall geometry (tests/test_longfile.py):
    the last chunk reaches past the end of the file, and its slice buffer
    must hold zeros there."""
    n = 2384160
    plan, starts = _plan_for(n / SR, "1.0", "1.0", mp=monkeypatch)
    sl = plan[-1]
    assert int(starts[sl.i1 - 1]) + 2 * SR > n == sl.b
    wav = np.ones((1, n), np.float32)
    get, _ = longfile.slice_uploads({}, wav, plan, SR, starts, 2 * SR, "cpu")
    buf = get(len(plan) - 1)
    assert buf.shape[1] >= int(starts[sl.i1 - 1]) - sl.a + 2 * SR
    assert not buf[:, sl.b - sl.a:].any() and buf[:, :sl.b - sl.a].all()


# -- Inference.slide ---------------------------------------------------------

@pytest.fixture(scope="module")
def segmentation():
    model = jax_pyannet(seed=31)
    return model, torch_pyannet_from(model)


def _logprobs(port, waveform, cache=None):
    inference = Inference(port, duration=2.0, step=0.5, batch_size=8,
                          skip_aggregation=True, device="cpu")
    inference._powerset = None
    return inference.slide(waveform, SR, cache=cache).data.numpy()


def _long_wave(samples=31 * SR + 11200, seed=32):
    return (0.1 * np.random.default_rng(seed).standard_normal(
        (1, samples))).astype(np.float32)


@pytest.mark.parametrize("shared_sinc", ["1", "0"])
def test_slide_sliced_matches_whole_and_jax(monkeypatch, segmentation,
                                            shared_sinc):
    """31.7 s in 9 s slices with 1 s halos: several slices and a
    zero-padded tail chunk; the uploads stay cached for the embedding
    stage (their total is far within the budget's quarter)."""
    jax_model, port = segmentation
    wav = _long_wave()
    monkeypatch.setenv("PYANNOTE_TPU_SHARED_SINC", shared_sinc)
    set_knobs(monkeypatch, minutes="0")
    whole = _logprobs(port, wav)
    set_knobs(monkeypatch, minutes="0.15", halo="1.0")
    cache = {}
    sliced = _logprobs(port, wav, cache=cache)
    starts, _ = _chunk_grid(wav.shape[1], 2 * SR, SR // 2)
    plan = longfile.plan_slices(wav.shape[1], 2 * SR, SR // 2, SR, starts)
    assert len(plan) > 2 and len(_keys(cache["_longfile_uploads"])) == \
        len(plan)
    assert sliced.shape == whole.shape == (len(starts), 115, 7)
    np.testing.assert_allclose(sliced, whole, atol=1e-5)
    expected = np.asarray(JaxInference(
        jax_model, duration=2.0, step=0.5, batch_size=8,
        skip_aggregation=True, skip_conversion=True).slide(wav, SR).data)
    np.testing.assert_allclose(sliced, expected, atol=2e-4)


def test_slide_sliced_tail_and_released_uploads(monkeypatch, segmentation):
    """The tail-shortfall geometry end to end, with a budget so small that
    the slice uploads are released as the slide goes."""
    _, port = segmentation
    wav = _long_wave(2384160, seed=33)
    set_knobs(monkeypatch, minutes="0")
    whole = _logprobs(port, wav)
    set_knobs(monkeypatch, minutes="1.0", budget="0.000001", halo="1.0")
    cache = {}
    sliced = _logprobs(port, wav, cache=cache)
    assert "_fingerprint" in cache["_longfile_uploads"]
    assert not _keys(cache["_longfile_uploads"])
    np.testing.assert_allclose(sliced, whole, atol=1e-5)


def test_preload_uploads_one_slice_or_the_whole_file(monkeypatch,
                                                     segmentation, tmp_path):
    from pyannote_audio_tpu_torch.core.io import write_wav
    _, port = segmentation
    path = tmp_path / "long.wav"
    write_wav(path, _long_wave(30 * SR, seed=34), SR)
    inference = Inference(port, duration=2.0, step=0.5, batch_size=8,
                          skip_aggregation=True, device="cpu")
    set_knobs(monkeypatch, minutes="0.15", halo="1.0")
    file = {"audio": str(path)}
    inference.preload(file)
    assert len(_keys(file["_longfile_uploads"])) == 1
    assert "_device_waveform" not in file
    set_knobs(monkeypatch, minutes="0")
    file = {"audio": str(path)}
    inference.preload(file)
    assert "_longfile_uploads" not in file
    buffer = file["_device_waveform"][1]
    # slide finds the preloaded upload
    inference.slide(*Audio()(file), cache=file)
    assert file["_device_waveform"][1] is buffer


# -- the embedding stage and the whole pipeline -------------------------------

@pytest.fixture(scope="module")
def corpus_40s(tmp_path_factory):
    path = tmp_path_factory.mktemp("corpus") / "long.wav"
    file = default_two_speaker_file(path, duration=40.0)
    return ({"audio": file["audio"], "uri": "long"},
            jax_pyannet(duration=5.0, seed=35), jax_wespeaker(seed=36))


def _pipeline(seg, emb, step=0.1):
    pipeline = SpeakerDiarization(
        torch_pyannet_from(seg), torch_wespeaker_from(emb),
        segmentation_step=step, segmentation_batch_size=8,
        embedding_batch_size=8, device="cpu")
    for name, value in PANELS.items():
        setattr(pipeline, name, value)
    return pipeline.instantiate(PARAMS)


# per-chunk: a 0.5005 s step is off the 160-sample fbank shift
EMBEDDING_PATHS = {"shared_trunk": ("1", 0.1), "shared_fbank": ("0", 0.1),
                   "per_chunk": ("0", 0.1001)}


@pytest.mark.parametrize("path", list(EMBEDDING_PATHS))
def test_embeddings_sliced_match_whole(monkeypatch, corpus_40s, path):
    file, seg, emb = corpus_40s
    gate, step = EMBEDDING_PATHS[path]
    monkeypatch.setenv("PYANNOTE_TPU_SHARED_TRUNK", gate)
    waveform, _ = Audio()(dict(file))
    pipeline = _pipeline(seg, emb, step)
    out, segmentations = {}, None
    for label, minutes in (("whole", "0"), ("sliced", "0.2")):
        set_knobs(monkeypatch, minutes=minutes, halo="4.0")
        cache = {}
        # the slide fills the upload cache; the masks are the whole-file
        # run's on both sides
        scores = pipeline._segmentation.slide(waveform, SR, cache=cache)
        segmentations = segmentations or scores
        pipeline.counts = dict.fromkeys(pipeline.counts, 0)
        out[label] = pipeline.get_embeddings(waveform, segmentations,
                                             cache=cache)
        out[label + "_counts"] = dict(pipeline.counts)
        out[label + "_cache"] = cache
    plan = pipeline._plan(waveform.shape[1])
    assert plan is not None and len(plan) >= 3
    # the uploads of the slices were shared by both stages, then released
    assert not _keys(out["sliced_cache"]["_longfile_uploads"])
    assert "_device_waveform" not in out["sliced_cache"]
    if path == "shared_trunk":
        assert out["sliced_counts"]["whole_fbank"] == len(plan)
        assert out["sliced_counts"]["trunk_panel_batches"] > 0
    elif path == "shared_fbank":
        assert out["sliced_counts"]["whole_fbank"] == len(plan)
    else:
        assert out["sliced_counts"]["whole_fbank"] == 0
    whole, sliced = out["whole"], out["sliced"]
    assert sliced.shape == whole.shape
    norms = np.minimum(np.linalg.norm(whole, axis=-1),
                       np.linalg.norm(sliced, axis=-1))
    live = norms > 1e-6
    assert live.any()
    a, b = whole[live], sliced[live]
    cos = np.sum(a * b, axis=-1) / (np.linalg.norm(a, axis=-1)
                                    * np.linalg.norm(b, axis=-1))
    assert cos.min() > 0.999, cos.min()
    np.testing.assert_allclose(sliced, whole, atol=5e-3, rtol=5e-3)


@pytest.mark.parametrize("gates", ["0", "1"], ids=["exact", "shared"])
def test_pipeline_sliced_matches_whole(monkeypatch, corpus_40s, gates):
    file, seg, emb = corpus_40s
    monkeypatch.setenv("PYANNOTE_TPU_SHARED_SINC", gates)
    monkeypatch.setenv("PYANNOTE_TPU_SHARED_TRUNK", gates)
    pipeline = _pipeline(seg, emb)
    out = {}
    for label, minutes in (("whole", "0"), ("sliced", "0.2")):
        set_knobs(monkeypatch, minutes=minutes, halo="4.0")
        pipeline._segmentation.counts["whole_conv"] = 0
        out[label] = pipeline(dict(file), max_speakers=3)
        out[label + "_convs"] = pipeline._segmentation.counts["whole_conv"]
    if gates == "1":
        plan = pipeline._plan(int(40.0 * SR))
        assert (out["whole_convs"], out["sliced_convs"]) == (1, len(plan))
    whole = list(out["whole"].speaker_diarization.itertracks(
        yield_label=True))
    sliced = list(out["sliced"].speaker_diarization.itertracks(
        yield_label=True))
    assert len(whole) == len(sliced) > 0
    for (s1, _, l1), (s2, _, l2) in zip(whole, sliced):
        assert l1 == l2
        assert abs(s1.start - s2.start) < 0.05
        assert abs(s1.end - s2.end) < 0.05

