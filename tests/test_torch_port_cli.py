"""The port's command line and its pipeline's training caches, against the
JAX package on the same inputs.

Both packages' ``main`` run on one community-1 style snapshot
(``test_torch_port_config.write_snapshot``: a small PyanNet, a small
WeSpeaker ResNet, VBx) and one corpus (``tests/corpus.py``, a registry
written by the port's YAML writer). The JAX package reads the snapshot's
reference checkpoints; its ``WeSpeakerResNet34`` takes no depth from a
checkpoint, so the JAX runs name the small trunk (``SmallWeSpeaker``) for
that architecture.

- ``apply`` (one file, a directory): the JSON of every file equal to the
  JAX package's, RTTM turns within one frame (and equal labels);
- ``benchmark``: per-file and total DER within 1e-9, the same
  speaker-count table, ``speed.yml`` read back by PyYAML and by the port;
- ``optimize``: the same journal (parameters equal, objectives within
  1e-9) and, in training mode, one segmentation and one embedding pass
  per file whatever the number of trials;
- the training caches of ``SpeakerDiarization`` (powerset and
  multi-label): a second pass over one file dict runs neither model in
  either package, a changed ``segmentation.threshold`` reruns only the
  multi-label model's embeddings, and outputs equal a fresh run's;
- ``strip``, ``export``, ``download``; ``--device`` parsing, and no CPU
  fallback without a card; ``SAMPLE_FILE`` equal to the JAX package's
  (samples at 0.0); RTTM and UEM files byte-equal to the JAX package's.
"""

import csv
import json

import numpy as np
import pytest
import torch
import yaml

import pyannote_audio_tpu.models.embedding.wespeaker as jax_wespeaker_module
from pyannote_audio_tpu.__main__ import main as jax_main
from pyannote_audio_tpu.core.inference import Inference as JaxInference
from pyannote_audio_tpu.pipelines.speaker_diarization import \
    SpeakerDiarization as JaxSpeakerDiarization
from pyannote_audio_tpu_torch import Model, Pipeline
from pyannote_audio_tpu_torch.__main__ import main, parse_device
from pyannote_audio_tpu_torch.core.inference import Inference
from pyannote_audio_tpu_torch.pipelines.speaker_diarization import \
    SpeakerDiarization
from pyannote_audio_tpu_torch.utils import yaml_subset
from corpus import default_two_speaker_file, make_file
from test_torch_port_config import write_snapshot
from test_torch_port_inference import jax_segmenter, torch_segmenter_from
from test_torch_port_models import (SmallWeSpeaker, jax_pyannet,
                                    jax_wespeaker, torch_wespeaker_from)
from test_torch_port_vbx import plda_params
from test_torch_port_models import one_torch_thread  # noqa: F401

CLUSTERING = {"threshold": 0.1, "Fa": 0.07, "Fb": 0.8}
PROTOCOL = "CliDB.SpeakerDiarization.P"
DER_ATOL = 1e-9
OPTIMIZE_TRIALS = 3


def write_cli_snapshot(root):
    """A community-1 style snapshot of small seeded models under
    ``root``; returns the frame step of its segmentation model."""
    segmentation = jax_pyannet(duration=5.0, seed=2)
    write_snapshot(root, segmentation, jax_wespeaker(seed=22),
                   plda_params(21), clustering=CLUSTERING)
    return segmentation.receptive_field.step


def write_cli_corpus(root):
    """Two files (30 s and 14 s), their RTTM and UEM, and a registry
    written by the port's YAML writer; returns the registry's path."""
    files = [default_two_speaker_file(root / "f0.wav"),
             make_file(root / "f1.wav", [("carol", 1.0, 6.0),
                                         ("dave", 7.0, 12.0)],
                       duration=14.0, seed=3)]
    with open(root / "all.rttm", "w") as f:
        for file in files:
            file["annotation"].write_rttm(f)
    with open(root / "all.uem", "w") as f:
        for file in files:
            for seg in file["annotated"]:
                f.write(f"{file['uri']} 1 {seg.start:.3f} {seg.end:.3f}\n")
    subset = {"annotation": str(root / "all.rttm"),
              "annotated": str(root / "all.uem")}
    registry = {"Databases": {"CliDB": f"{root}/{{uri}}.wav"},
                "Protocols": {"CliDB": {"SpeakerDiarization": {"P": {
                    "test": subset, "development": dict(subset)}}}}}
    path = yaml_subset.dump_file(registry, root / "database.yml")
    assert yaml.safe_load(path.read_text()) == registry
    return path


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli")
    (root / "snapshot").mkdir()
    (root / "corpus").mkdir()
    frame = write_cli_snapshot(root / "snapshot")
    registry = write_cli_corpus(root / "corpus")
    return root, frame, registry


def jax_main_small(argv):
    """The JAX CLI, with the snapshot's WeSpeakerResNet34 read as the
    small trunk it holds."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_wespeaker_module, "WeSpeakerResNet34", SmallWeSpeaker)
        return jax_main(argv)


def rttm_turns(path):
    turns = []
    for line in path.read_text().splitlines():
        fields = line.split()
        start, duration = float(fields[3]), float(fields[4])
        turns.append((fields[1], start, start + duration, fields[7]))
    return turns


@pytest.fixture(scope="module")
def applied(workspace):
    root, _, _ = workspace
    corpus = root / "corpus"
    out = {}
    for mode, audio in (("file", corpus / "f1.wav"), ("directory", corpus)):
        for name, run, extra in (("port", main, ["--device", "cpu"]),
                                 ("jax", jax_main_small, [])):
            into = root / f"apply-{mode}-{name}"
            assert run(["apply", str(root / "snapshot"), str(audio),
                        "--into", str(into)] + extra) == 0
            out[mode, name] = into
    return out


@pytest.mark.parametrize("mode,uris", [("file", ["f1"]),
                                       ("directory", ["f0", "f1"])])
def test_apply_matches_jax(workspace, applied, mode, uris):
    _, frame, _ = workspace
    ours, theirs = applied[mode, "port"], applied[mode, "jax"]
    assert sorted(p.stem for p in ours.glob("*.rttm")) == uris
    for uri in uris:
        a = json.loads((ours / f"{uri}.json").read_text())
        b = json.loads((theirs / f"{uri}.json").read_text())
        assert a == b and a["diarization"]
        x, y = rttm_turns(ours / f"{uri}.rttm"), rttm_turns(
            theirs / f"{uri}.rttm")
        assert len(x) == len(y) > 0
        for (u1, s1, e1, l1), (u2, s2, e2, l2) in zip(x, y):
            assert (u1, l1) == (u2, l2)
            assert abs(s1 - s2) <= frame and abs(e1 - e2) <= frame


def test_apply_to_stdout(workspace, capsys):
    root, _, _ = workspace
    assert main(["apply", str(root / "snapshot"),
                 str(root / "corpus" / "f1.wav"), "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert out.startswith("SPEAKER f1 1")
    assert len(out.splitlines()[0].split()) == 10


@pytest.fixture(scope="module")
def benchmarked(workspace):
    root, _, registry = workspace
    out = {}
    for name, run, extra in (("port", main, ["--device", "cpu"]),
                             ("jax", jax_main_small, [])):
        into = root / f"benchmark-{name}"
        assert run(["benchmark", str(root / "snapshot"), PROTOCOL,
                    str(into), "--registry", str(registry)] + extra) == 0
        out[name] = into
    return out


def test_benchmark_matches_jax(benchmarked):
    ours, theirs = benchmarked["port"], benchmarked["jax"]

    def rows(path):
        with open(path / "metric.csv") as f:
            return list(csv.DictReader(f))
    a, b = rows(ours), rows(theirs)
    assert [r["uri"] for r in a] == [r["uri"] for r in b] == ["f0", "f1"]
    for x, y in zip(a, b):
        for key in ("diarization error rate", "false alarm",
                    "missed detection", "confusion", "total"):
            assert abs(float(x[key]) - float(y[key])) <= DER_ATOL, key
    assert (ours / "speaker_count_confusion.csv").read_text() == \
        (theirs / "speaker_count_confusion.csv").read_text()
    assert (ours / "metric.txt").read_text() == \
        (theirs / "metric.txt").read_text()
    speed = (ours / "speed.yml").read_text()
    assert yaml.safe_load(speed) == yaml_subset.safe_load(speed)
    assert yaml_subset.safe_load(speed)["seconds_per_hour"] > 0


def test_benchmark_optimizes_min_duration_off(workspace):
    root, _, registry = workspace
    into = root / "benchmark-collar"
    assert main(["benchmark", str(root / "snapshot"), PROTOCOL, str(into),
                 "--registry", str(registry), "--device", "cpu",
                 "--exact", "--optimize-min-duration-off"]) == 0
    result = yaml.safe_load((into / "min_duration_off.yml").read_text())
    assert 0.0 <= result["min_duration_off"] <= 1.0
    assert result == yaml_subset.load_file(into / "min_duration_off.yml")


class Recorder(dict):
    """A file dict that records which training caches were written."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.writes = []

    def __setitem__(self, key, value):
        if str(key).startswith("training_cache/"):
            self.writes.append(key)
        super().__setitem__(key, value)


def count_port_models(mp, pipeline):
    """Counts of the port's segmentation slides and embedding batches."""
    counts = {"slide": 0, "embed": 0}
    slide, embed = Inference.slide, pipeline._embedding.embed

    def counted_slide(self, *args, **kwargs):
        counts["slide"] += 1
        return slide(self, *args, **kwargs)

    def counted_embed(*args, **kwargs):
        counts["embed"] += 1
        return embed(*args, **kwargs)
    mp.setattr(Inference, "slide", counted_slide)
    mp.setattr(pipeline._embedding, "embed", counted_embed)
    return counts


@pytest.fixture(scope="module")
def optimized(workspace):
    root, _, registry = workspace
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        # the CLI builds its own pipeline: count at the class level
        counts = {"slide": 0, "embed": 0}
        slide = Inference.slide
        embed = SpeakerDiarization.get_embeddings

        def counted_slide(self, *args, **kwargs):
            counts["slide"] += 1
            return slide(self, *args, **kwargs)

        def counted_embeddings(self, waveform, *args, **kwargs):
            computed = self._cached_embeddings(kwargs.get("cache")) is None
            counts["embed"] += int(computed)
            return embed(self, waveform, *args, **kwargs)
        mp.setattr(Inference, "slide", counted_slide)
        mp.setattr(SpeakerDiarization, "get_embeddings", counted_embeddings)
        into = root / "optimize-port"
        assert main(["optimize", str(root / "snapshot"), PROTOCOL,
                     str(into), "--registry", str(registry), "--trials",
                     str(OPTIMIZE_TRIALS), "--device", "cpu"]) == 0
    out["port"], out["counts"] = into, counts
    into = root / "optimize-jax"
    assert jax_main_small(["optimize", str(root / "snapshot"), PROTOCOL,
                           str(into), "--registry", str(registry),
                           "--trials", str(OPTIMIZE_TRIALS)]) == 0
    out["jax"] = into
    return out


def test_optimize_matches_jax_and_reuses_the_models(optimized):
    ours = [json.loads(line) for line in
            (optimized["port"] / "journal.jsonl").read_text().splitlines()]
    theirs = [json.loads(line) for line in
              (optimized["jax"] / "journal.jsonl").read_text().splitlines()]
    assert len(ours) == len(theirs) == OPTIMIZE_TRIALS
    for a, b in zip(ours, theirs):
        assert a["trial"] == b["trial"]
        assert a["params"] == b["params"]
        assert abs(a["objective"] - b["objective"]) <= DER_ATOL
    # two files: one segmentation and one embedding pass each, for all
    # the trials
    assert optimized["counts"] == {"slide": 2, "embed": 2}


@pytest.fixture(scope="module")
def corpus_file(workspace):
    root, _, _ = workspace
    return {"audio": str(root / "corpus" / "f1.wav"), "uri": "f1"}


POWERSET_PARAMS = [
    {"segmentation": {"min_duration_off": 0.0}, "clustering": CLUSTERING},
    {"segmentation": {"min_duration_off": 0.2},
     "clustering": dict(CLUSTERING, threshold=0.3)}]
MULTILABEL_PARAMS = [
    {"segmentation": {"min_duration_off": 0.0, "threshold": 0.5},
     "clustering": {"method": "centroid", "threshold": 0.6,
                    "min_cluster_size": 1}},
    {"segmentation": {"min_duration_off": 0.1, "threshold": 0.5},
     "clustering": {"method": "centroid", "threshold": 0.4,
                    "min_cluster_size": 1}},
    {"segmentation": {"min_duration_off": 0.1, "threshold": 0.6},
     "clustering": {"method": "centroid", "threshold": 0.4,
                    "min_cluster_size": 1}}]


def pipelines(kind, workspace):
    """(port, JAX) pipelines on the same weights."""
    root, _, _ = workspace
    if kind == "powerset":
        port = Pipeline.from_pretrained(root / "snapshot", device="cpu")
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jax_wespeaker_module, "WeSpeakerResNet34",
                       SmallWeSpeaker)
            from pyannote_audio_tpu.core.pipeline import \
                Pipeline as JaxPipeline
            theirs = JaxPipeline.from_pretrained(root / "snapshot")
        return port, theirs, POWERSET_PARAMS
    segmentation = jax_segmenter(powerset=False, duration=5.0, seed=12,
                                 layers=2, head_gain=40.0)
    embedding = jax_wespeaker(seed=23)
    port = SpeakerDiarization(torch_segmenter_from(segmentation),
                              torch_wespeaker_from(embedding),
                              segmentation_batch_size=16,
                              embedding_batch_size=16, device="cpu")
    theirs = JaxSpeakerDiarization(
        segmentation=segmentation, embedding=embedding,
        clustering="AgglomerativeClustering", segmentation_batch_size=16,
        embedding_batch_size=16)
    return port, theirs, MULTILABEL_PARAMS


@pytest.mark.parametrize("kind", ["powerset", "multi-label"])
def test_training_caches_match_jax(workspace, corpus_file, kind):
    """In training mode the JAX package caches a file dict's segmentation
    and embeddings (the latter keyed on the binarization threshold of a
    multi-label model), and so does the port: a second pass with new
    clustering parameters runs no model, a new threshold reruns only the
    embeddings, and each output equals a fresh pass's."""
    port, theirs, params = pipelines(kind, workspace)
    expected_writes = ["training_cache/segmentation",
                       "training_cache/embeddings"]
    if kind == "multi-label":
        expected_writes.append("training_cache/embeddings")
    for name, pipeline in (("jax", theirs), ("port", port)):
        pipeline.training = True
        file = Recorder(corpus_file)
        with pytest.MonkeyPatch.context() as mp:
            calls = []
            if name == "port":
                counts = count_port_models(mp, pipeline)
            else:
                call = JaxInference.__call__
                mp.setattr(JaxInference, "__call__",
                           lambda self, *a, **k: calls.append(1)
                           or call(self, *a, **k))
            outputs = []
            for p in params:
                pipeline.instantiate(p)
                outputs.append(pipeline(file).serialize())
            if name == "port":
                assert counts["slide"] == 1
                embeds_per_pass = counts["embed"] // (
                    len(expected_writes) - 1)
                assert counts["embed"] == embeds_per_pass * (
                    len(expected_writes) - 1) > 0
            else:
                assert len(calls) == 1
        assert file.writes == expected_writes, name
        pipeline.training = False
        for p, output in zip(params, outputs):
            pipeline.instantiate(p)
            assert pipeline(dict(corpus_file)).serialize() == output, name


def test_strip_keeps_the_inference_files(workspace, tmp_path):
    root, _, _ = workspace
    checkpoint = tmp_path / "epoch_0"
    checkpoint.mkdir()
    source = root / "snapshot" / "segmentation" / "pytorch_model.bin"
    (checkpoint / "pytorch_model.bin").write_bytes(source.read_bytes())
    (checkpoint / "train_state.pt").write_bytes(b"optimizer state")
    assert main(["strip", str(checkpoint), str(tmp_path / "out")]) == 0
    assert sorted(p.name for p in (tmp_path / "out").iterdir()) == \
        ["pytorch_model.bin"]
    from pyannote_audio_tpu_torch.__main__ import strip
    assert strip(str(root / "snapshot"), str(tmp_path / "pipeline")) == 0
    assert sorted(p.name for p in (tmp_path / "pipeline").iterdir()) == \
        ["config.yaml"]
    with pytest.raises(SystemExit):
        main(["strip", str(tmp_path / "out" / "nothing"),
              str(tmp_path / "x")])


def test_export_writes_a_checkpoint_both_packages_read(workspace, tmp_path,
                                                      capsys):
    from pyannote_audio_tpu.core.model import Model as JaxModel
    root, _, _ = workspace
    source = root / "snapshot" / "segmentation"
    assert main(["export", str(source), str(tmp_path / "out")]) == 0
    assert "pytorch_model.bin" in capsys.readouterr().out
    ours, exported = Model.from_pretrained(source), Model.from_pretrained(
        tmp_path / "out")
    for key, value in ours.state_dict().items():
        assert torch.equal(value, exported.state_dict()[key]), key
    wav = (0.1 * np.random.default_rng(0).standard_normal((1, 1, 80000))
           ).astype(np.float32)
    theirs = JaxModel.from_pretrained(tmp_path / "out" / "pytorch_model.bin")
    import jax
    import jax.numpy as jnp
    expected = np.asarray(theirs.module.apply(
        jax.tree_util.tree_map(jnp.asarray, theirs.params),
        jnp.asarray(wav)))
    with torch.no_grad():
        got = exported(torch.from_numpy(wav)).numpy()
    np.testing.assert_allclose(got, expected, atol=1e-5)
    torch.save({"state_dict": {}, "pyannote.audio": {"architecture": {
        "class": "SincTDNN"}}}, tmp_path / "pytorch_model.bin")
    assert main(["export", str(tmp_path), str(tmp_path / "out2")]) == 1
    assert "not ported" in capsys.readouterr().out


def test_download_loads_local_snapshots_only(workspace, capsys, tmp_path,
                                             monkeypatch):
    """A local snapshot loads; so does a hub id whose snapshot lies under
    a ``PYANNOTE_TPU_HUB`` root (tests/test_torch_port_utils.py serves
    one over HTTP); one that resolves nowhere fails."""
    from pyannote_audio_tpu_torch.__main__ import download
    root, _, _ = workspace
    # hub ids resolve through utils/hf_hub.py: no snapshot root, an empty
    # cache and a closed local endpoint, so nothing leaves the machine
    monkeypatch.setenv("PYANNOTE_TPU_HUB", "")
    monkeypatch.setenv("PYANNOTE_TPU_CACHE", str(tmp_path / "hub_cache"))
    monkeypatch.setenv("HF_ENDPOINT", "http://127.0.0.1:9")

    assert main(["download", str(root / "snapshot"), "--device", "cpu"]) \
        == 0
    assert "SpeakerDiarization" in capsys.readouterr().out
    assert download(str(root / "snapshot" / "config.yaml"),
                    device="cpu") == 0
    assert "SpeakerDiarization" in capsys.readouterr().out
    assert main(["download", "pyannote/speaker-diarization-community-1",
                 "--device", "cpu"]) == 1
    out = capsys.readouterr().out
    assert "Could not load" in out and "local" in out
    (tmp_path / "roots" / "pyannote").mkdir(parents=True)
    (tmp_path / "roots" / "pyannote" / "speaker-diarization-community-1"
     ).symlink_to(root / "snapshot")
    monkeypatch.setenv("PYANNOTE_TPU_HUB", str(tmp_path / "roots"))
    assert main(["download", "pyannote/speaker-diarization-community-1",
                 "--device", "cpu"]) == 0
    assert "SpeakerDiarization" in capsys.readouterr().out


def test_device_parsing_has_no_cpu_fallback(workspace, monkeypatch):
    root, _, _ = workspace
    assert parse_device("cpu") == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for value in (None, "auto", "cuda", "cuda:0"):
        with pytest.raises(RuntimeError, match="CUDA"):
            parse_device(value)
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["apply", str(root / "snapshot"),
              str(root / "corpus" / "f1.wav")])
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["download", str(root / "snapshot")])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert parse_device("auto") == torch.device("cuda")
    assert parse_device("cuda:1") == torch.device("cuda", 1)


def test_rttm_and_uem_writers_match_jax(workspace, tmp_path):
    """``dump_rttm`` / ``dump_uem`` write the JAX package's bytes, from
    the annotations and timelines each package reads back."""
    from pyannote_audio_tpu.utils import rttm as jax_rttm
    from pyannote_audio_tpu_torch.utils import rttm
    root, _, _ = workspace
    corpus = root / "corpus"
    ours, theirs = rttm.load_rttm(corpus / "all.rttm"), \
        jax_rttm.load_rttm(corpus / "all.rttm")
    rttm.dump_rttm(ours, tmp_path / "ours.rttm")
    jax_rttm.dump_rttm(theirs, tmp_path / "theirs.rttm")
    assert (tmp_path / "ours.rttm").read_bytes() == \
        (tmp_path / "theirs.rttm").read_bytes()
    assert len(rttm.load_rttm(tmp_path / "ours.rttm")) == 2
    rttm.dump_uem(rttm.load_uem(corpus / "all.uem"), tmp_path / "ours.uem")
    jax_rttm.dump_uem(jax_rttm.load_uem(corpus / "all.uem"),
                      tmp_path / "theirs.uem")
    assert (tmp_path / "ours.uem").read_bytes() == \
        (tmp_path / "theirs.uem").read_bytes() == \
        (corpus / "all.uem").read_bytes()


def test_sample_file_matches_jax():
    from pyannote_audio_tpu.core.io import Audio as JaxAudio
    from pyannote_audio_tpu.sample import SAMPLE_FILE as JAX_SAMPLE
    from pyannote_audio_tpu_torch.core.io import Audio
    from pyannote_audio_tpu_torch.sample import SAMPLE_FILE, load_stm
    ours, _ = Audio(sample_rate=16000)(SAMPLE_FILE)
    theirs, _ = JaxAudio(sample_rate=16000)(JAX_SAMPLE)
    np.testing.assert_array_equal(ours, np.asarray(theirs))
    assert SAMPLE_FILE["uri"] == JAX_SAMPLE["uri"] == "sample"
    assert [(s.start, s.end, label) for s, _, label in
            SAMPLE_FILE["annotation"].itertracks(yield_label=True)] == \
        [(s.start, s.end, label) for s, _, label in
         JAX_SAMPLE["annotation"].itertracks(yield_label=True)]
    assert [(s.start, s.end) for s in SAMPLE_FILE["annotated"]] == [
        (s.start, s.end) for s in JAX_SAMPLE["annotated"]]
    assert callable(load_stm)
