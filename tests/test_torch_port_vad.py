"""The slice as a whole: the port's VoiceActivityDetection,
OracleVoiceActivityDetection, MultiLabelSegmentation and non-powerset
SpeakerDiarization against the JAX package's, on the synthetic
two-speaker corpus file, with the same small seeded weights carried
across; and every new entry point's device default.

Held: the same annotations (same labels and tracks, boundaries within
1e-6 s) and the same metric values (within 1e-9) for the VAD, oracle VAD
and multilabel pipelines; for non-powerset diarization the same hard
clusters and the same annotations (boundaries within one segmentation
frame, as tests/test_torch_port_pipeline.py holds the powerset path).
The models' scores agree within 1e-3 (the PyanNet bound of 2e-4 on
log-probabilities, scaled by the gain of 40 that the multi-label head
gets so that its sigmoids reach the thresholds); each test first asserts
that the port's and the JAX package's scores lie on the same side of
every threshold it uses, so equality is what a correct port must give.
"""

import numpy as np
import pytest

from corpus import default_two_speaker_file
from pyannote_audio_tpu.pipelines import clustering as jax_clustering
from pyannote_audio_tpu.pipelines.multilabel import \
    MultiLabelSegmentation as JaxMultiLabelSegmentation
from pyannote_audio_tpu.pipelines.speaker_diarization import \
    SpeakerDiarization as JaxSpeakerDiarization
from pyannote_audio_tpu.utils.rttm import load_rttm as jax_load_rttm
from pyannote_audio_tpu.pipelines.voice_activity_detection import (
    OracleVoiceActivityDetection as JaxOracleVoiceActivityDetection,
    VoiceActivityDetection as JaxVoiceActivityDetection)
from pyannote_audio_tpu_torch import Pipeline
from pyannote_audio_tpu_torch.core.inference import Inference
from pyannote_audio_tpu_torch.pipelines import clustering
from pyannote_audio_tpu_torch.pipelines.multilabel import \
    MultiLabelSegmentation
from pyannote_audio_tpu_torch.pipelines.speaker_diarization import \
    SpeakerDiarization
from pyannote_audio_tpu_torch.pipelines.voice_activity_detection import (
    OracleVoiceActivityDetection, VoiceActivityDetection)
from pyannote_audio_tpu_torch.utils.convert import (pyannet_state_dict,
                                                    write_reference_checkpoint)
from pyannote_audio_tpu_torch.utils.rttm import load_rttm
from test_torch_port_inference import jax_segmenter, torch_segmenter_from
from test_torch_port_models import jax_wespeaker, torch_wespeaker_from
from test_torch_port_pipeline import _assert_same_annotation, \
    _capture_clusters
from test_torch_port_vbx import port_annotation


def _tracks(annotation):
    return [(s.start, s.end, str(t), lbl)
            for s, t, lbl in annotation.itertracks(yield_label=True)]


def _same_tracks(ours, theirs):
    a, b = _tracks(ours), _tracks(theirs)
    assert len(a) == len(b) > 0
    for x, y in zip(a, b):
        assert x[2:] == y[2:]
        assert abs(x[0] - y[0]) <= 1e-6 and abs(x[1] - y[1]) <= 1e-6


def _same_side(ours, theirs, thresholds):
    ours = ours.numpy() if hasattr(ours, "numpy") else np.asarray(ours)
    theirs = np.asarray(theirs)
    np.testing.assert_allclose(ours, theirs, atol=1e-3)
    for t in thresholds:
        assert np.array_equal(ours > t, theirs > t)
        assert np.array_equal(ours < t, theirs < t)


@pytest.fixture(scope="module")
def corpus_file(tmp_path_factory):
    path = tmp_path_factory.mktemp("corpus") / "two_speakers.wav"
    return default_two_speaker_file(path, duration=30.0)


@pytest.fixture(scope="module")
def powerset_pair():
    model = jax_segmenter(powerset=True, duration=5.0, seed=11)
    return model, torch_segmenter_from(model)


@pytest.fixture(scope="module")
def multilabel_pair():
    model = jax_segmenter(powerset=False, duration=5.0, seed=12, layers=2,
                          head_gain=40.0)
    return model, torch_segmenter_from(model)


def test_vad_matches_jax(powerset_pair, corpus_file):
    jax_model, port = powerset_pair
    ours = VoiceActivityDetection(port, step=0.5, device="cpu")
    theirs = JaxVoiceActivityDetection(jax_model, step=0.5)
    params = {"min_duration_on": 0.1, "min_duration_off": 0.2}
    ours.instantiate(params)
    theirs.instantiate(params)
    _same_side(ours._segmentation(dict(corpus_file)).data,
               theirs._segmentation(dict(corpus_file)).data, [0.5])
    steps = []
    a = ours(dict(corpus_file), hook=lambda name, artifact, **kw:
             steps.append((name, artifact is None, kw["file"]["uri"])))
    b = theirs(dict(corpus_file))
    assert steps == [("segmentation", True, "two_speakers"),
                     ("segmentation", False, "two_speakers")]
    assert a.labels() == ["SPEECH"] and a.uri == "two_speakers"
    _same_tracks(a, b)
    reference = port_annotation(corpus_file["annotation"])
    for fscore in (False, True):
        ours.fscore = theirs.fscore = fscore
        m, n = ours.get_metric(), theirs.get_metric()
        assert m(reference, a) == pytest.approx(
            n(corpus_file["annotation"], b), abs=1e-9)
        assert abs(m) == pytest.approx(abs(n), abs=1e-9)
        assert ours.get_direction() == theirs.get_direction()
    # a list goes file by file, decoding ahead
    outs = ours([dict(corpus_file), dict(corpus_file)])
    assert all(_tracks(o) == _tracks(a) for o in outs)


def test_vad_hysteresis_on_a_multilabel_model(multilabel_pair, corpus_file):
    jax_model, port = multilabel_pair
    ours = VoiceActivityDetection(port, step=0.5, device="cpu")
    theirs = JaxVoiceActivityDetection(jax_model, step=0.5)
    params = {"onset": 0.55, "offset": 0.45, "min_duration_on": 0.0,
              "min_duration_off": 0.0}
    ours.instantiate(params)
    theirs.instantiate(params)
    _same_side(ours._segmentation(dict(corpus_file)).data,
               theirs._segmentation(dict(corpus_file)).data, [0.55, 0.45])
    _same_tracks(ours(dict(corpus_file)), theirs(dict(corpus_file)))


def test_oracle_vad(corpus_file):
    file = dict(corpus_file, annotation=port_annotation(
        corpus_file["annotation"]))
    ours = OracleVoiceActivityDetection(device="cpu")(file)
    theirs = JaxOracleVoiceActivityDetection.apply(dict(corpus_file))
    assert _tracks(ours) == _tracks(theirs) and len(ours) == 6


def test_oracle_vad_from_rttm(corpus_file, tmp_path):
    """The reference written by ``Annotation.write_rttm`` and read back by
    the port's and the JAX package's ``load_rttm``: the same tracks (RTTM
    keeps 3 decimals), and the oracle VAD of it as JAX's."""
    path = tmp_path / "reference.rttm"
    with open(path, "w") as f:
        port_annotation(corpus_file["annotation"]).write_rttm(f)
    ours = load_rttm(path)["two_speakers"]
    theirs = jax_load_rttm(path)["two_speakers"]
    assert [(round(s.start, 3), round(s.end, 3), lbl)
            for s, _, lbl in ours.itertracks(yield_label=True)] == \
        [(round(s.start, 3), round(s.end, 3), lbl)
         for s, _, lbl in corpus_file["annotation"].itertracks(
             yield_label=True)]
    _same_tracks(ours, theirs)
    speech = OracleVoiceActivityDetection(device="cpu")(
        dict(corpus_file, annotation=ours))
    _same_tracks(speech, JaxOracleVoiceActivityDetection.apply(
        dict(corpus_file, annotation=theirs)))


@pytest.mark.parametrize("share_min_duration", [False, True])
def test_multilabel_matches_jax(multilabel_pair, corpus_file,
                                share_min_duration):
    jax_model, port = multilabel_pair
    ours = MultiLabelSegmentation(port, step=0.5, device="cpu",
                                  share_min_duration=share_min_duration)
    theirs = JaxMultiLabelSegmentation(
        jax_model, step=0.5, share_min_duration=share_min_duration)
    thresholds = {"c0": {"onset": 0.6, "offset": 0.4},
                  "c1": {"onset": 0.5, "offset": 0.5},
                  "c2": {"onset": 0.45, "offset": 0.35}}
    if share_min_duration:
        params = {"min_duration_on": 0.1, "min_duration_off": 0.05,
                  "thresholds": thresholds}
    else:
        params = {"thresholds": {
            k: dict(v, min_duration_on=0.05 * i, min_duration_off=0.1)
            for i, (k, v) in enumerate(thresholds.items())}}
    ours.instantiate(params)
    theirs.instantiate(params)
    _same_side(ours._segmentation(dict(corpus_file)).data,
               theirs._segmentation(dict(corpus_file)).data,
               [0.6, 0.4, 0.5, 0.45, 0.35])
    seen = []
    a = ours(dict(corpus_file), hook=lambda name, artifact, file=None, **kw:
             seen.append((name, file["uri"])))
    b = theirs(dict(corpus_file))
    assert seen == [("segmentation", "two_speakers")]
    assert ours.classes() == ["c0", "c1", "c2"]
    _same_tracks(a, b)
    reference = port_annotation(corpus_file["annotation"]).rename_labels(
        {"alice": "c0", "bob": "c1"})
    jax_reference = corpus_file["annotation"].rename_labels(
        {"alice": "c0", "bob": "c1"})
    for fscore in (False, True):
        ours.fscore = theirs.fscore = fscore
        m, n = ours.get_metric(), theirs.get_metric()
        assert m(reference, a) == pytest.approx(n(jax_reference, b),
                                                abs=1e-9)
        assert abs(m) == pytest.approx(abs(n), abs=1e-9)


def _snapshot(root, jax_model):
    write_reference_checkpoint(
        pyannet_state_dict(jax_model.params, jax_model.hparams), "PyanNet",
        dict(jax_model.hparams, sample_rate=16000, num_channels=1),
        jax_model.specifications.to_dict(), root / "segmentation")


@pytest.mark.parametrize("name,params", [
    ("pyannote.audio.pipelines.VoiceActivityDetection",
     {"min_duration_on": 0.0, "min_duration_off": 0.0}),
    ("pyannote_audio_tpu.pipelines.voice_activity_detection."
     "VoiceActivityDetection", {"min_duration_on": 0.1,
                                "min_duration_off": 0.0}),
    ("pyannote.audio.pipelines.MultiLabelSegmentation", None),
    ("pyannote_audio_tpu.pipelines.multilabel.MultiLabelSegmentation",
     None),
    ("pyannote.audio.pipelines.OracleVoiceActivityDetection", None)])
def test_from_pretrained_config_dict(tmp_path, powerset_pair,
                                     multilabel_pair, corpus_file, name,
                                     params):
    oracle = "Oracle" in name
    jax_model = (multilabel_pair if "MultiLabel" in name
                 else powerset_pair)[0]
    _snapshot(tmp_path, jax_model)
    config = {"checkpoint": str(tmp_path),
              "pipeline": {"name": name, "params": {} if oracle else {
                  "segmentation": "$model/segmentation", "step": 0.5}}}
    if params is not None:
        config["params"] = params
    with pytest.raises(RuntimeError, match='device="cpu"'):
        Pipeline.from_pretrained(config)
    pipeline = Pipeline.from_pretrained(config, device="cpu")
    assert type(pipeline).__module__.startswith("pyannote_audio_tpu_torch.")
    assert str(pipeline.device) == "cpu"
    file = dict(corpus_file, annotation=port_annotation(
        corpus_file["annotation"]))
    assert len(pipeline(file)) > 0


def test_device_defaults_raise_without_a_card(powerset_pair,
                                              multilabel_pair):
    _, port = powerset_pair
    _, multi = multilabel_pair
    emb = torch_wespeaker_from(jax_wespeaker(seed=1))
    for build in (lambda: Inference(port),
                  lambda: VoiceActivityDetection(port),
                  lambda: MultiLabelSegmentation(multi),
                  lambda: OracleVoiceActivityDetection(),
                  lambda: SpeakerDiarization(multi, emb)):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            build()


NON_POWERSET = {"segmentation": {"threshold": 0.54, "min_duration_off": 0.0},
                "clustering": {"method": "centroid", "threshold": 0.05,
                               "min_cluster_size": 1}}


def test_non_powerset_diarization_matches_jax(multilabel_pair, corpus_file,
                                              monkeypatch):
    jax_model, port_model = multilabel_pair
    emb = jax_wespeaker(seed=23)
    port = SpeakerDiarization(port_model, torch_wespeaker_from(emb),
                              segmentation_batch_size=16,
                              embedding_batch_size=16, device="cpu")
    jax_pipeline = JaxSpeakerDiarization(
        segmentation=jax_model, embedding=emb,
        clustering="AgglomerativeClustering",
        segmentation_batch_size=16, embedding_batch_size=16)
    assert set(port.parameters()) == set(jax_pipeline.parameters())
    with pytest.raises(RuntimeError, match="instantiate"):
        port(dict(corpus_file))
    port.instantiate(NON_POWERSET)
    jax_pipeline.instantiate(NON_POWERSET)
    _same_side(port._segmentation(dict(corpus_file)).data,
               jax_pipeline.get_segmentations(dict(corpus_file)).data, [0.54])
    clusters = {"jax": [], "port": []}
    _capture_clusters(monkeypatch, jax_clustering.AgglomerativeClustering,
                      clusters["jax"])
    _capture_clusters(monkeypatch, clustering.AgglomerativeClustering,
                      clusters["port"])
    expected = jax_pipeline(dict(corpus_file), max_speakers=4)
    ours = port(dict(corpus_file), max_speakers=4)
    np.testing.assert_array_equal(clusters["port"][0], clusters["jax"][0])
    frame = jax_model.receptive_field.step
    assert ours.speaker_diarization.labels() == \
        expected.speaker_diarization.labels()
    _assert_same_annotation(ours.speaker_diarization,
                            expected.speaker_diarization, frame)
    _assert_same_annotation(ours.exclusive_speaker_diarization,
                            expected.exclusive_speaker_diarization, frame)
    np.testing.assert_allclose(ours.speaker_embeddings,
                               np.asarray(expected.speaker_embeddings),
                               atol=2e-3)
    # with the device AHC gate, the same partition
    monkeypatch.setenv("PYANNOTE_TPU_DEVICE_AHC", "1")
    gated = port(dict(corpus_file), max_speakers=4)
    assert gated.speaker_diarization == ours.speaker_diarization
