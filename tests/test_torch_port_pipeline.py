"""The slice as a whole: the port's SpeakerDiarization against the JAX
package's, on the synthetic two-speaker corpus file, with the same
weights carried across. On the CPU the JAX pipeline takes its exact
path, which is the path the port implements.

Held: the same hard clusters, and the same Annotations (same labels,
segment boundaries within one segmentation frame); centroids within the
embedding tolerance of 2e-3.
"""

import pkgutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from corpus import default_two_speaker_file
from pyannote_audio_tpu.pipelines import clustering as jax_clustering
from pyannote_audio_tpu.pipelines.speaker_diarization import \
    SpeakerDiarization as JaxSpeakerDiarization
from pyannote_audio_tpu_torch.pipelines import clustering
from pyannote_audio_tpu_torch.pipelines.speaker_diarization import \
    SpeakerDiarization
from test_torch_port_models import (jax_pyannet, jax_wespeaker,
                                    torch_pyannet_from, torch_wespeaker_from)

# bench.py's settings, but a cut distance that splits these random-weight
# embeddings (their centroid-linkage merges span 0.01-0.13) into more
# clusters than max_speakers, so the dendrogram re-cut runs too
PARAMS = {"segmentation": {"min_duration_off": 0.0},
          "clustering": {"method": "centroid", "threshold": 0.05,
                         "min_cluster_size": 1}}


def _capture_clusters(monkeypatch, klass, store):
    original = klass.__call__

    def wrapped(self, *args, **kwargs):
        out = original(self, *args, **kwargs)
        store.append(np.array(out[0]))
        return out
    monkeypatch.setattr(klass, "__call__", wrapped)


@pytest.fixture(scope="module")
def both_outputs(tmp_path_factory):
    path = tmp_path_factory.mktemp("corpus") / "two_speakers.wav"
    default_two_speaker_file(path, duration=30.0)
    file = {"audio": str(path), "uri": "two_speakers"}
    seg, emb = jax_pyannet(duration=10.0, seed=2), jax_wespeaker(seed=22)
    port = SpeakerDiarization(torch_pyannet_from(seg),
                              torch_wespeaker_from(emb),
                              segmentation_batch_size=16,
                              embedding_batch_size=16, device="cpu")
    port.instantiate(PARAMS)
    jax_pipeline = JaxSpeakerDiarization(
        segmentation=seg, embedding=emb,
        clustering="AgglomerativeClustering",
        segmentation_batch_size=16, embedding_batch_size=16)
    jax_pipeline.instantiate(PARAMS)

    clusters = {"jax": [], "port": []}
    with pytest.MonkeyPatch.context() as mp:
        _capture_clusters(mp, jax_clustering.AgglomerativeClustering,
                          clusters["jax"])
        _capture_clusters(mp, clustering.AgglomerativeClustering,
                          clusters["port"])
        expected = jax_pipeline(dict(file), max_speakers=4)
        ours = port(dict(file), max_speakers=4)
        # list input runs the files one after another
        ours_list = port([dict(file), dict(file)], max_speakers=4)
    frame = seg.receptive_field.step
    return expected, ours, ours_list, clusters, frame


def _tracks(annotation):
    return list(annotation.itertracks(yield_label=True))


def _assert_same_annotation(ours, expected, frame):
    a, b = _tracks(ours), _tracks(expected)
    assert len(a) == len(b) > 0
    for (seg_a, _, label_a), (seg_b, _, label_b) in zip(a, b):
        assert label_a == label_b
        assert abs(seg_a.start - seg_b.start) <= frame
        assert abs(seg_a.end - seg_b.end) <= frame


def test_same_hard_clusters(both_outputs):
    _, _, _, clusters, _ = both_outputs
    assert len(clusters["jax"]) == 1 and len(clusters["port"]) == 3
    assert len(np.unique(clusters["jax"][0])) == 4     # max_speakers
    np.testing.assert_array_equal(clusters["port"][0], clusters["jax"][0])


def test_same_annotations(both_outputs):
    expected, ours, _, _, frame = both_outputs
    assert ours.speaker_diarization.uri == "two_speakers"
    assert ours.speaker_diarization.labels() == \
        expected.speaker_diarization.labels()
    _assert_same_annotation(ours.speaker_diarization,
                            expected.speaker_diarization, frame)
    _assert_same_annotation(ours.exclusive_speaker_diarization,
                            expected.exclusive_speaker_diarization, frame)


def test_same_centroids_and_list_input(both_outputs):
    expected, ours, ours_list, _, _ = both_outputs
    np.testing.assert_allclose(ours.speaker_embeddings,
                               np.asarray(expected.speaker_embeddings),
                               atol=2e-3)
    assert len(ours_list) == 2
    for out in ours_list:
        assert out.speaker_diarization == ours.speaker_diarization
        np.testing.assert_array_equal(out.speaker_embeddings,
                                      ours.speaker_embeddings)


def test_port_imports_no_jax():
    """The package and every one of its modules (walked with pkgutil, so
    each new module is checked) load without JAX, the JAX package,
    scikit-learn or PyYAML (none of which the card machine may have), and
    a config's JAX-package class path resolves to the port without
    importing the JAX package."""
    root = Path(__file__).resolve().parent.parent
    package = root / "pyannote_audio_tpu_torch"
    modules = ["pyannote_audio_tpu_torch"] + sorted(
        info.name for info in pkgutil.walk_packages(
            [str(package)], prefix="pyannote_audio_tpu_torch."))
    assert "pyannote_audio_tpu_torch.pipelines.speech_separation" in modules
    assert "pyannote_audio_tpu_torch.models.blocks.ssl" in modules
    for name in ("tasks.embedding", "tasks.separation",
                 "utils.preprocessors", "models.embedding.convert"):
        assert f"pyannote_audio_tpu_torch.{name}" in modules
    code = ("import importlib, sys\n"
            f"for name in {modules!r}:\n"
            "    importlib.import_module(name)\n"
            "import pyannote_audio_tpu_torch as port\n"
            "port.Pipeline, port.Model\n"
            "from pyannote_audio_tpu_torch.core.pipeline import \\\n"
            "    get_class_by_name\n"
            "for name in ('pyannote_audio_tpu.pipelines.speaker_diarization.'\n"
            "             'SpeakerDiarization',\n"
            "             'pyannote.audio.pipelines.VoiceActivityDetection',\n"
            "             'pyannote.audio.pipelines.'\n"
            "             'OracleVoiceActivityDetection',\n"
            "             'pyannote_audio_tpu.pipelines.multilabel.'\n"
            "             'MultiLabelSegmentation',\n"
            "             'pyannote.audio.pipelines.SpeakerEmbedding',\n"
            "             'pyannote_audio_tpu.pipelines.SpeakerEmbedding',\n"
            "             'pyannote.audio.pipelines.SpeechSeparation',\n"
            "             'pyannote.audio.utils.preprocessors.Waveform',\n"
            "             'pyannote_audio_tpu.utils.preprocessors.'\n"
            "             'DeriveMetaLabels'):\n"
            "    klass = get_class_by_name(name)\n"
            "    assert klass.__module__.startswith(\n"
            "        'pyannote_audio_tpu_torch.'), name\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in (\n"
            "    'jax', 'flax', 'jaxlib', 'pyannote_audio_tpu', 'sklearn',\n"
            "    'yaml'))\n"
            "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=root,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    # and no file of the package names them
    for source in (root / "pyannote_audio_tpu_torch").rglob("*.py"):
        text = source.read_text()
        assert "import jax" not in text and "from jax" not in text, source
        assert "import flax" not in text and "from flax" not in text, source
