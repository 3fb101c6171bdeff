"""The port's pipeline hooks against the JAX package's, on the CPU.

Held:
- the hook classes behave as the JAX package's (tests/test_hooks.py);
  ``TraceHook`` opens one ``torch.profiler.record_function`` region per
  step and, with a ``log_dir``, records the pipeline's spans and writes a
  Chrome trace there that holds both;
- the sequence of ``(step_name, artifact is None, total, completed)``
  calls of the port's pipeline equals the JAX pipeline's on the same file
  and weights, whole and in forced slices, and so do the progress calls
  of a sliced ``Inference``;
- the artifacts agree within the pipeline tolerances of
  tests/test_torch_port_pipeline.py: the same hard segmentation, speaker
  count and discrete diarization, embeddings within 2e-3;
- hooks are bound to their file: ``ArtifactHook`` writes into the dict
  the caller passed, and ``TimingHook`` keeps a record per file through
  ``apply_batch``.
"""

import json
import time

import numpy as np
import pytest
import torch

from corpus import default_two_speaker_file
from pyannote_audio_tpu.core.inference import Inference as JaxInference
from pyannote_audio_tpu.pipelines.speaker_diarization import \
    SpeakerDiarization as JaxSpeakerDiarization
from pyannote_audio_tpu.pipelines.utils.hook import \
    ArtifactHook as JaxArtifactHook
from pyannote_audio_tpu_torch.core.inference import Inference
from pyannote_audio_tpu_torch.pipelines.speaker_diarization import \
    SpeakerDiarization
from pyannote_audio_tpu_torch.pipelines.utils.hook import (ArtifactHook,
                                                           Hooks,
                                                           ProgressHook,
                                                           TimingHook,
                                                           TraceHook)
from pyannote_audio_tpu_torch.telemetry import spans
from test_torch_port_models import (jax_pyannet, jax_wespeaker,
                                    torch_pyannet_from, torch_wespeaker_from)
from test_torch_port_pipeline import PARAMS
from test_torch_port_models import one_torch_thread  # noqa: F401

SR = 16000
STEPS = ("segmentation", "speaker_counting", "embeddings",
         "discrete_diarization")


# -- the hook classes -----------------------------------------------------------

def test_artifact_hook_captures_requested_steps():
    file = {}
    with ArtifactHook("segmentation") as hook:
        hook("segmentation", np.ones(3), file=file)
        hook("embeddings", np.zeros(3), file=file)
        hook("segmentation", None, file=file, total=2, completed=1)
    assert list(file["artifact"]) == ["segmentation"]
    np.testing.assert_array_equal(file["artifact"]["segmentation"],
                                  np.ones(3))
    everything = {}
    with ArtifactHook(file_key="all") as hook:
        hook("a", 1, file=everything)
        hook("b", [2], file=everything)
    assert everything["all"] == {"a": 1, "b": [2]}


def test_timing_hook_accumulates_recurring_steps():
    file = {}
    with TimingHook() as hook:
        hook("step1", None, file=file)
        time.sleep(0.05)
        hook("step2", None, file=file)
        time.sleep(0.01)
        hook("step1", None, file=file)
        time.sleep(0.02)
    assert file["timing"]["step1"] >= 0.06
    assert file["timing"]["step2"] >= 0.01


def test_hooks_compose_and_progress_runs():
    file, calls = {}, []

    def spy(name, artifact, file=None, total=None, completed=None):
        calls.append((name, total, completed))

    with Hooks(ArtifactHook(), spy, ProgressHook(transient=True)) as hook:
        hook("x", 42, file=file)
        hook("y", None, total=2, completed=1)
        hook("y", None, total=2, completed=2)
    assert calls == [("x", None, None), ("y", 2, 1), ("y", 2, 2)]
    assert file["artifact"] == {"x": 42}


def test_trace_hook_regions_and_chrome_trace(tmp_path, pipelines):
    with TraceHook(str(tmp_path)) as hook:
        for step in ("segmentation", "segmentation", "embeddings"):
            hook(step, None)
            torch.ones(64).sum()
    trace = json.loads((tmp_path / "trace.json").read_text())
    names = [event.get("name") for event in trace["traceEvents"]]
    assert names.count("segmentation") == 1 and "embeddings" in names
    # without a log_dir, regions only: nothing is written
    with TraceHook() as hook:
        hook("segmentation", None)
    assert [p.name for p in tmp_path.iterdir()] == ["trace.json"]
    assert hook.recording is None
    # with one, the pipeline's spans are recorded while the hook is
    # entered and show in the trace as ranges beside the steps
    file, port, _ = pipelines
    with TraceHook(str(tmp_path / "apply")) as hook:
        port(dict(file), hook=hook)
    assert spans.span("probe") is spans.OFF
    trace = json.loads((tmp_path / "apply" / "trace.json").read_text())
    names = {event.get("name") for event in trace["traceEvents"]}
    assert {"apply", "stage", "finalize", "stage/segmentation",
            "finalize/clustering", "segmentation", "embeddings"} <= names
    assert {"stage", "finalize"} <= {s.path
                                     for s in hook.recording.closed()}


# -- the pipeline's calls against the JAX pipeline's --------------------------

class Recorder:
    """(step, artifact is None, total, completed, uri) of every call."""

    def __init__(self):
        self.calls = []

    def __call__(self, step_name, step_artifact, file=None, total=None,
                 completed=None):
        self.calls.append((step_name, step_artifact is None, total,
                           completed, None if file is None else file["uri"]))


@pytest.fixture(scope="module")
def pipelines(tmp_path_factory):
    path = tmp_path_factory.mktemp("hooks") / "two_speakers.wav"
    default_two_speaker_file(path, duration=31.3)
    seg, emb = jax_pyannet(duration=10.0, seed=2), jax_wespeaker(seed=22)
    port = SpeakerDiarization(torch_pyannet_from(seg),
                              torch_wespeaker_from(emb),
                              segmentation_batch_size=8,
                              embedding_batch_size=8, device="cpu")
    jax_pipeline = JaxSpeakerDiarization(
        segmentation=seg, embedding=emb,
        clustering="AgglomerativeClustering",
        segmentation_batch_size=8, embedding_batch_size=8)
    for pipeline in (port, jax_pipeline):
        pipeline.instantiate(PARAMS)
    return {"audio": str(path), "uri": "two_speakers"}, port, jax_pipeline


@pytest.mark.parametrize("minutes", ["0", "0.2"], ids=["whole", "sliced"])
def test_hook_calls_match_jax(pipelines, monkeypatch, minutes):
    file, port, jax_pipeline = pipelines
    monkeypatch.setenv("PYANNOTE_TPU_SEGMENT_MINUTES", minutes)
    monkeypatch.setenv("PYANNOTE_TPU_SEGMENT_HALO_SECONDS", "4.0")
    ours, theirs = Recorder(), Recorder()
    port(dict(file), max_speakers=4, hook=ours)
    jax_pipeline(dict(file), max_speakers=4, hook=theirs)
    assert ours.calls == theirs.calls
    steps = [call[0] for call in ours.calls]
    assert [s for s in dict.fromkeys(steps)] == ["segmentation",
                                                 "embeddings",
                                                 "speaker_counting",
                                                 "discrete_diarization"]
    # 23 chunks in batches of 8 (per slice when sliced), then the artifact
    progress = [c[2:4] for c in ours.calls if c[0] == "segmentation"]
    assert progress == ([(23, 8), (23, 16), (23, 23), (None, None)]
                        if minutes == "0" else
                        [(23, 8), (23, 12), (23, 20), (23, 23),
                         (None, None)])
    assert {call[4] for call in ours.calls} == {"two_speakers"}


def test_sliced_inference_progress_matches_jax(pipelines, monkeypatch):
    file, port, jax_pipeline = pipelines
    monkeypatch.setenv("PYANNOTE_TPU_SEGMENT_MINUTES", "0.2")
    monkeypatch.setenv("PYANNOTE_TPU_SEGMENT_HALO_SECONDS", "4.0")
    calls = {"port": [], "jax": []}
    Inference(port._segmentation.model, duration=10.0, step=1.0,
              batch_size=8, skip_aggregation=True, device="cpu")(
        dict(file), hook=lambda **kw: calls["port"].append(
            (kw["completed"], kw["total"])))
    JaxInference(jax_pipeline._segmentation.model, duration=10.0, step=1.0,
                 batch_size=8, skip_aggregation=True)(
        dict(file), hook=lambda **kw: calls["jax"].append(
            (kw["completed"], kw["total"])))
    assert calls["port"] == calls["jax"]
    assert len(calls["port"]) > 3                  # one per batch per slice
    assert calls["port"][-1] == (23, 23)


def _artifacts(pipeline, hook_class, file):
    f = dict(file)
    with hook_class() as hook:
        pipeline(f, max_speakers=4, hook=hook)
    return f["artifact"]


def test_artifacts_match_jax(pipelines):
    file, port, jax_pipeline = pipelines
    ours = _artifacts(port, ArtifactHook, file)
    theirs = _artifacts(jax_pipeline, JaxArtifactHook, file)
    assert sorted(ours) == sorted(theirs) == sorted(STEPS)
    segmentation = ours["segmentation"].data.numpy()
    np.testing.assert_array_equal(segmentation,
                                  np.asarray(theirs["segmentation"].data))
    np.testing.assert_array_equal(ours["speaker_counting"].data,
                                  np.asarray(theirs["speaker_counting"].data))
    assert ours["speaker_counting"].sliding_window.step == \
        theirs["speaker_counting"].sliding_window.step
    a, b = ours["embeddings"], np.asarray(theirs["embeddings"])
    assert a.shape == b.shape
    np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
    np.testing.assert_allclose(a[~np.isnan(a)], b[~np.isnan(b)], atol=2e-3)
    np.testing.assert_array_equal(
        ours["discrete_diarization"].data,
        np.asarray(theirs["discrete_diarization"].data, dtype=np.float32))


def test_hooks_bind_to_the_callers_file(pipelines, tmp_path):
    file, port, _ = pipelines
    given = dict(file)
    with ArtifactHook("speaker_counting") as hook:
        port(given, max_speakers=4, hook=hook)
    assert list(given["artifact"]) == ["speaker_counting"]
    batch = [dict(file, uri=f"copy{i}") for i in range(3)]
    recorder = Recorder()
    with TimingHook() as timing:
        port(batch, max_speakers=4, hook=Hooks(timing, recorder))
    for f in batch:
        assert "segmentation" in f["timing"]
    # every call names its own file, in staging then finalizing order
    uris = [call[4] for call in recorder.calls]
    assert uris[0] == "copy0" and uris[-1] == "copy2"
    for uri in ("copy0", "copy1", "copy2"):
        steps = [c[0] for c in recorder.calls if c[4] == uri]
        assert steps[-1] == "discrete_diarization"
        assert steps.count("speaker_counting") == 1
