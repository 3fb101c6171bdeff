"""The port's speaker-embedding and verification product against the JAX
package's: the four ``PretrainedSpeakerEmbedding`` routes (a reference
checkpoint, a WeSpeaker ``.onnx`` file, a SpeechBrain snapshot, a NeMo
archive), ``SpeakerEmbedding`` with and without VAD weighting (and from a
config through ``Pipeline.from_pretrained``), ``Model.from_pretrained``
for every new architecture name, the EER, and ``SpeakerDiarization``
with an x-vector embedding. Everything runs with ``device="cpu"``; each
entry point without a device raises on this machine (no card).

Weights go across through the JAX models' exporters and the port's
writers. Tolerances: x-vectors 2e-4; ECAPA and TitaNet rtol 2e-3 / atol
2e-4; the ONNX route's bf16 trunk bit-equal to the port's model of the
same weights, and within 2e-2 of the largest embedding value from the
JAX float32 module; NaN rows equal; EER exact (the JAX package's tie
semantics); diarization with an x-vector: equal hard clusters on the
exact path.
"""

import numpy as np
import pytest
import torch

import jax

from corpus import default_two_speaker_file
from pyannote_audio_tpu.core.io import write_wav
from pyannote_audio_tpu.metrics import streaming as jax_streaming
from pyannote_audio_tpu.models.embedding import ecapa as jax_ecapa
from pyannote_audio_tpu.models.embedding import titanet as jax_titanet
from pyannote_audio_tpu.models.embedding import wespeaker as jax_wespeaker
from pyannote_audio_tpu.models.embedding import xvector as jax_xvector
from pyannote_audio_tpu.pipelines import clustering as jax_clustering
from pyannote_audio_tpu.pipelines import speaker_verification as jax_sv
from pyannote_audio_tpu.pipelines.speaker_diarization import \
    SpeakerDiarization as JaxSpeakerDiarization
from pyannote_audio_tpu_torch import Model, Pipeline
from pyannote_audio_tpu_torch.metrics import streaming
from pyannote_audio_tpu_torch.models.embedding import wespeaker, xvector
from pyannote_audio_tpu_torch.pipelines import clustering
from pyannote_audio_tpu_torch.pipelines import speaker_verification as sv
from pyannote_audio_tpu_torch.pipelines.speaker_diarization import \
    SpeakerDiarization
from pyannote_audio_tpu_torch.utils.convert import (pyannet_state_dict,
                                                    write_reference_checkpoint)
from pyannote_audio_tpu_torch.utils.onnx import write_onnx_initializers
from test_torch_port_embedders import (ECAPA_CFG, TITANET_CFG, _built,
                                       _close, _wave)
from test_torch_port_models import jax_pyannet, torch_pyannet_from
from test_torch_port_pipeline import _capture_clusters

HYPERPARAMS = ("n_mels: 24\nembedding_model: !new:speechbrain.lobes.models."
               "ECAPA_TDNN.ECAPA_TDNN\n    channels: [32, 32, 32, 32, 96]\n"
               "    dilations: [1, 2, 3, 4, 1]\n    lin_neurons: 32\n")
PARAMS = {"segmentation": {"min_duration_off": 0.0},
          "clustering": {"method": "centroid", "threshold": 0.05,
                         "min_cluster_size": 1}}


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    """One JAX model of each route, with its checkpoint as the route reads
    it, and a PyanNet segmentation (5 s chunks) as a reference checkpoint;
    a few synthetic files."""
    root = tmp_path_factory.mktemp("verification")
    out = {"root": root}
    xv = _built(jax_xvector.XVectorSincNet(), seed=31)
    port_xv = xvector.XVectorSincNet().load_reference_state_dict(
        xv.export_torch_state_dict())
    write_reference_checkpoint(port_xv.state_dict(), "XVectorSincNet",
                               port_xv.reference_hparams(), None,
                               root / "xvector")
    out["xvector"] = xv

    seg = jax_pyannet(duration=5.0, seed=32)
    write_reference_checkpoint(
        pyannet_state_dict(seg.params, seg.hparams), "PyanNet",
        dict(seg.hparams, sample_rate=16000, num_channels=1),
        seg.specifications.to_dict(), root / "segmentation")
    out["segmentation"] = seg

    ec = _built(jax_ecapa.ECAPA_TDNN(**ECAPA_CFG), seed=33)
    (root / "ecapa").mkdir()
    torch.save({k: torch.from_numpy(np.array(v)) for k, v in
                ec.export_speechbrain_state_dict().items()},
               root / "ecapa" / "embedding_model.ckpt")
    (root / "ecapa" / "hyperparams.yaml").write_text(HYPERPARAMS)

    tn = _built(jax_titanet.TitaNet(**TITANET_CFG), seed=34)
    out["nemo"] = jax_titanet.export_nemo_checkpoint(tn, root / "titanet")

    files = []
    for k in range(3):
        path = root / f"file_{k}.wav"
        write_wav(str(path), _wave(1, 16000 * 8 + 1000 * k, seed=35 + k)[0],
                  16000)
        files.append({"audio": str(path), "uri": path.stem})
    out["files"] = files
    return out


def _xvector_masks():
    """(4, 58) masks: full, partial, too short (1 frame = 551 samples <
    640) and silent."""
    masks = (np.random.default_rng(36).uniform(size=(4, 58)) > 0.4
             ).astype(np.float32)
    masks[0] = 1.0
    masks[2] = 0.0
    masks[2, 7] = 1.0
    masks[3] = 0.0
    return masks


def _compacting_masks(frames, short):
    """(4, frames) masks for the compacting routes: full, partial, too
    short (``short`` frames), silent."""
    masks = (np.random.default_rng(37).uniform(size=(4, frames)) > 0.4
             ).astype(np.float32)
    masks[0] = 1.0
    masks[2] = 0.0
    masks[2, :short] = 1.0
    masks[3] = 0.0
    return masks


# -- the four routes ------------------------------------------------------------

def test_checkpoint_route_matches_jax(assets):
    path = str(assets["root"] / "xvector")
    ours = sv.PretrainedSpeakerEmbedding(path, device="cpu")
    theirs = jax_sv.PretrainedSpeakerEmbedding(path)
    assert isinstance(ours, sv.PyannoteAudioPretrainedSpeakerEmbedding)
    assert isinstance(ours.model, xvector.XVectorSincNet)
    assert (ours.dimension, ours.sample_rate, ours.metric,
            ours.min_num_samples) == (theirs.dimension, theirs.sample_rate,
                                      theirs.metric, theirs.min_num_samples)
    wav, masks = _wave(4, 32000, seed=38), _xvector_masks()
    for m in (None, masks):
        _close(ours(wav, m), theirs(wav, m), rtol=0, atol=2e-4)
    emb = ours(wav, masks)
    assert np.isnan(emb[2:]).all() and np.isfinite(emb[:2]).all()


def _onnx_file(path, state):
    """An .onnx file of initializers named as the exported bare ResNet
    (no ``resnet.`` prefix, no BatchNorm counters)."""
    write_onnx_initializers(path, {
        k[len("resnet."):]: v for k, v in state.items()
        if not k.endswith("num_batches_tracked")})
    return str(path)


class Tiny34(jax_wespeaker.BaseWeSpeakerResNet):
    """ResNet34's blocks at 4 channels, float32."""

    def build_module(self):
        return jax_wespeaker.WeSpeakerModule(
            num_blocks=self.NUM_BLOCKS, m_channels=4,
            compute_dtype=jax.numpy.float32)


def test_onnx_route(assets, tmp_path):
    model = _built(Tiny34(), seed=39)
    state = model.export_torch_state_dict()
    path = _onnx_file(tmp_path / "tiny-wespeaker.onnx", state)
    ours = sv.PretrainedSpeakerEmbedding(path, device="cpu")
    assert isinstance(ours, sv.ONNXWeSpeakerPretrainedSpeakerEmbedding)
    assert type(ours.model) is wespeaker.WeSpeakerResNet34
    assert ours.model.m_channels == 4
    assert ours.model.compute_dtype == torch.bfloat16
    assert ours.min_num_samples == 400 + 7 * 160
    same = wespeaker.WeSpeakerResNet34(m_channels=4)
    same.load_reference_state_dict(state).eval()
    wav = _wave(4, 32000, seed=40)
    masks = _compacting_masks(117, short=3)     # 3 / 117 of 2 s < 1520
    emb = ours(wav, masks)
    with torch.no_grad():
        direct = same(torch.from_numpy(wav), torch.from_numpy(masks))
    np.testing.assert_array_equal(emb[:2], direct.numpy()[:2])
    assert np.isnan(emb[2:]).all()
    expected = np.asarray(model(wav, masks))[:2]
    assert np.abs(emb[:2] - expected).max() <= 2e-2 * np.abs(expected).max()


@pytest.mark.parametrize("depth", [34, 152, 221, 293])
def test_onnx_route_recognises_depths(tmp_path, depth):
    model = getattr(wespeaker, f"WeSpeakerResNet{depth}")(m_channels=1)
    path = _onnx_file(tmp_path / "wespeaker.onnx",
                      {k: v.numpy() for k, v in model.state_dict().items()})
    ours = sv.PretrainedSpeakerEmbedding(path, device="cpu")
    assert type(ours.model) is type(model)
    loaded = ours.model.state_dict()
    for key, value in model.state_dict().items():
        np.testing.assert_array_equal(loaded[key], value)


def test_onnx_route_refuses_unknown_depths(tmp_path):
    model = wespeaker.WeSpeakerResNet18(m_channels=1)
    path = _onnx_file(tmp_path / "r18.onnx",
                      {k: v.numpy() for k, v in model.state_dict().items()})
    with pytest.raises(ValueError, match="could not infer"):
        sv.PretrainedSpeakerEmbedding(path, device="cpu")


def test_speechbrain_route_matches_jax(assets):
    path = str(assets["root"] / "ecapa")
    ours = sv.PretrainedSpeakerEmbedding(path, device="cpu")
    theirs = jax_sv.PretrainedSpeakerEmbedding(path)
    assert isinstance(ours, sv.SpeechBrainPretrainedSpeakerEmbedding)
    assert (ours.dimension, ours.min_num_samples) == \
        (theirs.dimension, theirs.min_num_samples) == (32, 640)
    wav = _wave(4, 16000, seed=41)
    masks = _compacting_masks(50, short=1)          # 320 samples < 640
    for m in (None, masks):
        _close(ours(wav, m), theirs(wav, m))
    emb = ours(wav, masks)
    assert np.isnan(emb[2:]).all() and np.isfinite(emb[:2]).all()


@pytest.mark.parametrize("form", ["archive", "directory"])
def test_nemo_route_matches_jax(assets, tmp_path, form):
    import tarfile
    path = assets["nemo"]
    if form == "directory":
        with tarfile.open(path) as tar:
            tar.extractall(tmp_path / "nemo", filter="data")
        path = tmp_path / "nemo"
    ours = sv.PretrainedSpeakerEmbedding(str(path), device="cpu")
    theirs = jax_sv.PretrainedSpeakerEmbedding(str(path))
    assert isinstance(ours, sv.NeMoPretrainedSpeakerEmbedding)
    assert ours.min_num_samples == theirs.min_num_samples == 1600
    wav = _wave(4, 16000, seed=42)
    masks = _compacting_masks(50, short=4)         # 1280 samples < 1600
    for m in (None, masks):
        _close(ours(wav, m), theirs(wav, m))
    emb = ours(wav, masks)
    assert np.isnan(emb[2:]).all() and np.isfinite(emb[:2]).all()


@pytest.mark.parametrize("name", [
    "pyannote/embedding", "speechbrain/spkrec-ecapa-voxceleb",
    "nvidia/speakerverification_en_titanet_large",
    "pyannote/wespeaker-voxceleb-resnet34-LM"])
def test_hub_ids_raise(name):
    with pytest.raises(ValueError, match="hub"):
        sv.PretrainedSpeakerEmbedding(name, device="cpu")


@pytest.mark.parametrize("route", ["xvector", "ecapa", "nemo", "onnx",
                                   "pipeline"])
def test_entry_points_default_to_the_card(assets, tmp_path, route):
    """Without ``device`` each entry point takes the CUDA card, and raises
    on this machine, which has none."""
    if route == "onnx":
        model = wespeaker.WeSpeakerResNet34(m_channels=1)
        path = _onnx_file(tmp_path / "r34.onnx", {
            k: v.numpy() for k, v in model.state_dict().items()})
    else:
        path = str(assets["nemo"] if route == "nemo"
                   else assets["root"] / {"pipeline": "xvector"}.get(
                       route, route))
    with pytest.raises(RuntimeError, match='device="cpu"'):
        if route == "pipeline":
            sv.SpeakerEmbedding(path,
                                segmentation=str(assets["root"]
                                                 / "segmentation"))
        else:
            sv.PretrainedSpeakerEmbedding(path)


# -- SpeakerEmbedding -------------------------------------------------------------

@pytest.mark.parametrize("embedding", ["xvector", "ecapa"])
@pytest.mark.parametrize("vad", [False, True])
def test_speaker_embedding_matches_jax(assets, embedding, vad):
    path = str(assets["root"] / embedding)
    seg_path = str(assets["root"] / "segmentation") if vad else None
    ours = sv.SpeakerEmbedding(path, segmentation=seg_path, device="cpu")
    theirs = jax_sv.SpeakerEmbedding(
        path, segmentation=assets["segmentation"] if vad else None)
    file = dict(assets["files"][1])
    emb = ours(dict(file))
    assert emb.shape == (1, ours._embedding.dimension)
    _close(emb, np.asarray(theirs(dict(file))),
           **({"rtol": 0, "atol": 2e-4} if embedding == "xvector" else {}))
    assert np.isfinite(emb).all()


def test_speaker_embedding_from_pretrained(assets):
    config = {"checkpoint": str(assets["root"]), "pipeline": {
        "name": "pyannote.audio.pipelines.SpeakerEmbedding",
        "params": {"embedding": "$model/xvector",
                   "segmentation": "$model/segmentation"}}}
    pipeline = Pipeline.from_pretrained(config, device="cpu")
    assert isinstance(pipeline, sv.SpeakerEmbedding)
    assert isinstance(pipeline._embedding.model, xvector.XVectorSincNet)
    direct = sv.SpeakerEmbedding(
        str(assets["root"] / "xvector"),
        segmentation=str(assets["root"] / "segmentation"), device="cpu")
    file = dict(assets["files"][0])
    np.testing.assert_array_equal(pipeline(dict(file)), direct(dict(file)))
    # the same config as a snapshot's config.yaml, the JAX package's path
    import yaml
    config["pipeline"]["name"] = "pyannote_audio_tpu.pipelines." \
        "SpeakerEmbedding"
    with open(assets["root"] / "config.yaml", "w") as f:
        yaml.safe_dump({"pipeline": config["pipeline"]}, f)
    from_dir = Pipeline.from_pretrained(assets["root"], device="cpu")
    np.testing.assert_array_equal(from_dir(dict(file)), direct(dict(file)))


# -- Model.from_pretrained round trips --------------------------------------------

@pytest.mark.parametrize("name", ["XVectorMFCC", "XVectorSincNet"] + [
    f"WeSpeakerResNet{depth}" for depth in (18, 34, 50, 101, 152, 221, 293)])
def test_model_from_pretrained_round_trip(tmp_path, name):
    generator = torch.Generator().manual_seed(43)
    if name.startswith("XVector"):
        model = getattr(xvector, name)(generator=generator)
    else:
        model = getattr(wespeaker, name)(m_channels=1,
                                         compute_dtype=torch.float32,
                                         generator=generator)
    path = write_reference_checkpoint(model.state_dict(), name,
                                      model.reference_hparams(), None,
                                      tmp_path)
    loaded = Model.from_pretrained(path)
    assert type(loaded) is type(model) and not loaded.training
    state = loaded.state_dict()
    for key, value in model.state_dict().items():
        torch.testing.assert_close(state[key], value, rtol=0, atol=0)
    wav = torch.from_numpy(_wave(2, 16000, seed=44))
    with torch.no_grad():
        torch.testing.assert_close(loaded(wav), model.eval()(wav),
                                   rtol=0, atol=0)


# -- EER ----------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["separable", "ties", "random"])
def test_eer_matches_jax(case):
    rng = np.random.default_rng(45)
    if case == "separable":
        scores, labels = np.array([0.9, 0.8, 0.3, 0.2]), np.array([1, 1, 0, 0])
    elif case == "ties":
        scores = np.array([0.5, 0.5, 0.5, 0.7, 0.2, 0.7, 0.1])
        labels = np.array([1, 0, 1, 1, 0, 0, 0])
    else:
        scores = np.round(rng.uniform(size=200), 2)
        labels = (rng.uniform(size=200) < scores).astype(int)
    ours, theirs = streaming.EqualErrorRate(), jax_streaming.EqualErrorRate()
    for half in (slice(None, len(scores) // 2), slice(len(scores) // 2,
                                                      None)):
        assert ours(scores[half], labels[half]) == \
            theirs(scores[half], labels[half])
    assert ours.compute() == theirs.compute()
    for a, b in zip(streaming.det_curve(scores, labels),
                    jax_streaming.det_curve(scores, labels)):
        np.testing.assert_array_equal(a, b)
    assert np.isnan(streaming.EqualErrorRate().compute())


def test_verification_trials_eer_matches_jax(assets):
    files = assets["files"]
    trials = [{"file1": files[0], "file2": files[1], "reference": 1},
              {"file1": files[0], "file2": files[2], "reference": 0},
              {"file1": files[1], "file2": files[2], "reference": 1},
              {"file1": files[2], "file2": files[2], "reference": 0}]
    path = str(assets["root"] / "xvector")
    ours = sv.verification_trials_eer(
        sv.SpeakerEmbedding(path, device="cpu"), [
            {k: dict(v) if isinstance(v, dict) else v
             for k, v in t.items()} for t in trials])
    theirs = jax_sv.verification_trials_eer(
        jax_sv.SpeakerEmbedding(path), trials)
    assert ours == theirs


# -- SpeakerDiarization with an x-vector -------------------------------------------

@pytest.fixture(scope="module")
def xvector_diarization(tmp_path_factory, assets):
    path = tmp_path_factory.mktemp("corpus") / "two_speakers.wav"
    default_two_speaker_file(path, duration=30.0)
    file = {"audio": str(path), "uri": "two_speakers"}
    seg = jax_pyannet(duration=10.0, seed=2)
    emb = assets["xvector"]
    port = SpeakerDiarization(
        torch_pyannet_from(seg),
        Model.from_pretrained(assets["root"] / "xvector"),
        segmentation_batch_size=16, embedding_batch_size=16, device="cpu")
    port.instantiate(PARAMS)
    jax_pipeline = JaxSpeakerDiarization(
        segmentation=seg, embedding=emb,
        clustering="AgglomerativeClustering", segmentation_batch_size=16,
        embedding_batch_size=16)
    jax_pipeline.instantiate(PARAMS)
    clusters = {"jax": [], "port": []}
    with pytest.MonkeyPatch.context() as mp:
        _capture_clusters(mp, jax_clustering.AgglomerativeClustering,
                          clusters["jax"])
        _capture_clusters(mp, clustering.AgglomerativeClustering,
                          clusters["port"])
        expected = jax_pipeline(dict(file), max_speakers=4)
        ours = port(dict(file), max_speakers=4)
        counts = dict(port.counts)
        # a long file's slices take the same path
        mp.setenv("PYANNOTE_TPU_SEGMENT_MINUTES", "0.2")
        port.counts = dict.fromkeys(port.counts, 0)
        sliced = port(dict(file), max_speakers=4)
        sliced_counts = dict(port.counts, slices=len(port._plan(30 * 16000)))
    return expected, ours, sliced, clusters, counts, sliced_counts


def test_xvector_diarization_matches_jax(xvector_diarization):
    expected, ours, _, clusters, counts, _ = xvector_diarization
    assert len(clusters["jax"]) == 1 and len(clusters["port"]) == 2
    np.testing.assert_array_equal(clusters["port"][0], clusters["jax"][0])
    assert ours.speaker_diarization.labels() == \
        expected.speaker_diarization.labels()
    assert ours.speaker_embeddings.shape[1] == 512
    np.testing.assert_allclose(ours.speaker_embeddings,
                               np.asarray(expected.speaker_embeddings),
                               atol=2e-4)
    # the per-chunk path: no whole-file fbank, no trunk panels
    assert counts["chunk_trunk_batches"] == 2
    assert counts["whole_fbank"] == counts["trunk_panel_batches"] == 0


def test_xvector_diarization_in_slices(xvector_diarization):
    _, ours, sliced, clusters, counts, sliced_counts = xvector_diarization
    np.testing.assert_array_equal(clusters["port"][1], clusters["port"][0])
    assert sliced.speaker_diarization == ours.speaker_diarization
    # 21 chunks in slices of 12: one batch of 16 per slice
    assert sliced_counts == {"slices": 2, "chunk_trunk_batches": 2,
                             "whole_fbank": 0, "trunk_panel_batches": 0}
