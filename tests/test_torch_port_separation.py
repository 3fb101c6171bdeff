"""The port's DPRNN, ToTaToNet, multi-task Inference and SpeechSeparation
against the JAX package, at tiny widths (16 filters, DPRNN bn and hid 16,
chunk 10, 1-2 repeats; a WavLM branch of hidden 32 and 1 layer).

Weights are carried with ``utils/convert.py`` (held equal to the JAX
model's own ``export_torch_state_dict``). Tolerances: DPRNN masks and
ToTaToNet's diarization 1e-4; sources within a relative L2 of 1e-4; the
Inference tuple outputs the same. SpeechSeparation on the 30 s corpus
file without an embedding model (leakage removal on and off) and with
one (on):
equal hard clusters and labels, segment boundaries within one output
frame, sources within a relative L2 of 1e-4.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from corpus import default_two_speaker_file
from pyannote_audio_tpu.core.inference import Inference as JaxInference
from pyannote_audio_tpu.core.model import Model as JaxModel
from pyannote_audio_tpu.models.blocks.dprnn import DPRNN as JaxDPRNN
from pyannote_audio_tpu.models.separation.totatonet import \
    ToTaToNet as JaxToTaToNet
from pyannote_audio_tpu.pipelines import clustering as jax_clustering
from pyannote_audio_tpu.pipelines.speech_separation import \
    SpeechSeparation as JaxSpeechSeparation
from pyannote_audio_tpu_torch.core.inference import Inference
from pyannote_audio_tpu_torch.core.model import Model
from pyannote_audio_tpu_torch.core.pipeline import get_class_by_name
from pyannote_audio_tpu_torch.models.blocks.dprnn import DPRNN
from pyannote_audio_tpu_torch.models.separation.totatonet import ToTaToNet
from pyannote_audio_tpu_torch.pipelines import clustering
from pyannote_audio_tpu_torch.pipelines.speech_separation import (
    SeparationOutput, SpeechSeparation)
from pyannote_audio_tpu_torch.utils.convert import (totatonet_state_dict,
                                                    write_reference_checkpoint)
from test_torch_port_models import (_wave, jax_wespeaker, perturb,
                                    torch_wespeaker_from)

HPARAMS = dict(dprnn={"n_repeats": 2, "bn_chan": 16, "hid_size": 16,
                      "chunk_size": 20},
               encoder_decoder={"n_filters": 16},
               linear={"hidden_size": 16, "num_layers": 1})
# the pipelines' model: one repeat, and the default chunk of 100 frames,
# so that a 5 s chunk's 4999 frames fold into 101 chunks (not 1000 of 10,
# each a step of the inter-chunk recurrence)
PIPELINE_HPARAMS = dict(HPARAMS, dprnn={"n_repeats": 1, "bn_chan": 16,
                                        "hid_size": 16, "chunk_size": 100})
# the pipelines' chunk step (a fifth of the 5 s chunk: 26 chunks of the
# 30 s file) and batch
STEP = 1.0
BATCH = 16
WAVLM = dict(hidden=32, layers=1, heads=4, ffn=64, conv_channels=16,
             rel_pos_bias=True, pre_ln=True, conv_norm="layer")


def rel_l2(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def jax_totatonet(wavlm=False, seed=0, hparams=HPARAMS):
    kwargs = dict(use_wavlm=True, wavlm_config=dict(WAVLM)) if wavlm else {}
    model = JaxToTaToNet(**hparams, **kwargs)
    model.build(jax.random.PRNGKey(seed))
    model.params = perturb(jax.tree_util.tree_map(np.asarray, model.params),
                           np.random.default_rng(seed))
    return model


def torch_totatonet_from(model, hparams=HPARAMS):
    kwargs = dict(use_wavlm=True, wavlm_config=dict(WAVLM)) \
        if model.use_wavlm else {}
    port = ToTaToNet(**hparams, **kwargs)
    state = totatonet_state_dict(model.params, model.hparams,
                                 WAVLM["layers"])
    return port.load_reference_state_dict(state).eval()


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU work here is thousands of tiny ops (the plain
    recurrence steps), which torch's thread pool only slows, and slows
    badly when parallel test workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    path = tmp_path_factory.mktemp("corpus") / "two_speakers.wav"
    default_two_speaker_file(path, duration=30.0)
    return {"audio": str(path), "uri": "two_speakers"}


def test_dprnn_masks_match_jax():
    module = JaxDPRNN(in_chan=12, out_chan=16, n_src=3, bn_chan=16,
                      hid_size=16, chunk_size=10, n_repeats=2)
    x = np.random.default_rng(0).standard_normal((2, 47, 12)).astype(
        np.float32)
    params = perturb(jax.tree_util.tree_map(np.asarray, jax.jit(
        module.init)(jax.random.PRNGKey(0), jnp.asarray(x))),
        np.random.default_rng(1))
    params["params"]["mask_prelu"]["negative_slope"] = np.float32(0.3)
    expected = np.asarray(jax.jit(module.apply)(
        jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(x)))
    # the masker's keys of a ToTaToNet checkpoint
    state = {k[len("masker."):]: v for k, v in totatonet_state_dict(
        {"params": {"encoder": {"kernel": np.zeros((4, 1, 16))},
                    "decoder": {"kernel": np.zeros((4, 16, 1))},
                    "masker": params["params"],
                    "linears_0": {"kernel": np.zeros((16, 16)),
                                  "bias": np.zeros(16)},
                    "classifier": {"kernel": np.zeros((16, 1)),
                                   "bias": np.zeros(1)}}},
        HPARAMS).items() if k.startswith("masker.")}
    port = DPRNN(in_chan=12, out_chan=16, n_src=3, bn_chan=16, hid_size=16,
                 chunk_size=10, n_repeats=2)
    port.load_state_dict({k: torch.from_numpy(np.array(v, np.float32))
                          for k, v in state.items()})
    with torch.no_grad():
        ours = port(torch.from_numpy(x)).numpy()
    assert ours.shape == expected.shape == (2, 3, 47, 16)
    np.testing.assert_allclose(ours, expected, atol=1e-4)


@pytest.mark.parametrize("wavlm", [False, True])
def test_totatonet_matches_jax(wavlm):
    model = jax_totatonet(wavlm, seed=2)
    ours_state = totatonet_state_dict(model.params, model.hparams,
                                      WAVLM["layers"])
    theirs = model.export_torch_state_dict()
    assert ours_state.keys() == theirs.keys()
    for key in theirs:
        np.testing.assert_array_equal(ours_state[key], theirs[key],
                                      err_msg=key)
    port = torch_totatonet_from(model)
    assert set(port.state_dict()) == set(theirs)
    wav = _wave(2, 2.0, seed=3)
    diar, sources = (np.asarray(o) for o in model(jnp.asarray(wav)))
    with torch.no_grad():
        ours_diar, ours_sources = (o.numpy()
                                   for o in port(torch.from_numpy(wav)))
    assert ours_diar.shape == diar.shape == (2, port.num_frames(32000), 3)
    assert ours_sources.shape == sources.shape == (2, 32000, 3)
    np.testing.assert_allclose(ours_diar, diar, atol=1e-4)
    assert rel_l2(ours_sources, sources) <= 1e-4
    assert port.num_frames(32000) == model.num_frames(32000)
    for attr in ("duration", "step", "start"):
        assert getattr(port.receptive_field, attr) == \
            getattr(model.receptive_field, attr)


def test_checkpoint_with_embedded_wavlm(tmp_path):
    """A checkpoint whose hyper-parameters name no WavLM branch but whose
    state dict embeds ``wavlm.*`` (a PixIT checkpoint) builds the branch
    from the weights, in the port as in the JAX package."""
    model = jax_totatonet(wavlm=True, seed=4)
    hparams = {k: v for k, v in model.hparams.items()
               if k not in ("use_wavlm", "wavlm_config")}
    path = write_reference_checkpoint(
        model.export_torch_state_dict(), "ToTaToNet", hparams,
        [s.to_dict() for s in model.specifications], tmp_path)
    port = Model.from_pretrained(tmp_path)
    assert port.use_wavlm and port.wavlm_config["hidden"] == 32
    assert isinstance(port.specifications, tuple)
    theirs = JaxModel.from_pretrained(str(path))
    wav = _wave(1, 2.0, seed=5)
    diar, sources = (np.asarray(o) for o in theirs(jnp.asarray(wav)))
    with torch.no_grad():
        ours_diar, ours_sources = (o.numpy()
                                   for o in port(torch.from_numpy(wav)))
    np.testing.assert_allclose(ours_diar, diar, atol=1e-4)
    assert rel_l2(ours_sources, sources) <= 1e-4
    # and the port writes it back in the same layout
    again = port.export_torch_state_dict()
    assert again.keys() == model.export_torch_state_dict().keys()


@pytest.fixture(scope="module")
def calibrated(corpus):
    """A random ToTaToNet whose diarization head is rescaled so that its
    logits spread by 1.5 around 0 on the corpus file (at init they spread
    by about 6e-3: every score would be a near tie at any threshold); the
    JAX package's and the port's Inference outputs of the rescaled model
    at the pipelines' step; and the candidate threshold farthest from any
    score (a float32 flip at a near tie is no fault)."""
    model = jax_totatonet(seed=7, hparams=PIPELINE_HPARAMS)
    inference = JaxInference(model, step=STEP, batch_size=BATCH)
    scores = np.asarray(inference(dict(corpus))[0].data, np.float64)
    logit = np.log(scores) - np.log1p(-scores)
    gain = 1.5 / logit.std()
    head = model.params["params"]["classifier"]
    head["kernel"] = (head["kernel"] * gain).astype(np.float32)
    head["bias"] = ((head["bias"] - np.median(logit)) * gain).astype(
        np.float32)
    model._jitted_apply = None
    expected = inference(dict(corpus))
    ours = Inference(torch_totatonet_from(model, PIPELINE_HPARAMS),
                     step=STEP, batch_size=BATCH, device="cpu")(dict(corpus))
    scores = np.asarray(expected[0].data)
    margins = {t: np.abs(scores - t).min()
               for t in np.round(np.arange(0.35, 0.655, 0.01), 2)}
    threshold = max(margins, key=margins.get)
    return model, expected, ours, threshold


def test_inference_tuple_outputs_match_jax(calibrated):
    _, expected, ours, threshold = calibrated
    assert isinstance(ours, tuple) and len(ours) == len(expected) == 2
    for a, b in zip(ours, expected):
        assert a.data.shape == np.asarray(b.data).shape
        assert a.sliding_window.step == b.sliding_window.step
        assert a.sliding_window.duration == b.sliding_window.duration
    np.testing.assert_allclose(ours[0].data, np.asarray(expected[0].data),
                               atol=1e-4)
    assert rel_l2(ours[1].data, np.asarray(expected[1].data)) <= 1e-4
    # the pipelines' threshold is farther from every score than 4x the
    # largest difference, so the comparison below holds them
    assert np.abs(np.asarray(expected[0].data) - threshold).min() > \
        4 * np.abs(ours[0].data - np.asarray(expected[0].data)).max()


def _capture_clusters(monkeypatch, klass, store):
    original = klass.__call__

    def wrapped(self, *args, **kwargs):
        out = original(self, *args, **kwargs)
        store.append(np.array(out[0]))
        return out
    monkeypatch.setattr(klass, "__call__", wrapped)


def _tracks(annotation):
    return list(annotation.itertracks(yield_label=True))


def _params(threshold, leakage_removal):
    return {"segmentation": {"min_duration_off": 0.0,
                             "threshold": threshold},
            "separation": {"leakage_removal": leakage_removal,
                           "asr_collar": 0.1},
            # a cut that splits the local sources into several clusters
            "clustering": {"method": "centroid", "threshold": 0.1,
                           "min_cluster_size": 1}}


@pytest.fixture(scope="module")
def pipelines(calibrated):
    """(JAX pipeline, port pipeline) without and with an embedding model,
    each built once (the JAX one keeps its compiled programs)."""
    model = calibrated[0]
    built = {}

    def get(embedder):
        if embedder not in built:
            emb = jax_wespeaker(seed=8) if embedder else None
            built[embedder] = (
                JaxSpeechSeparation(
                    segmentation=model, embedding=emb,
                    segmentation_step=STEP / 5.0,
                    segmentation_batch_size=BATCH,
                    embedding_batch_size=BATCH),
                SpeechSeparation(
                    torch_totatonet_from(model, PIPELINE_HPARAMS),
                    torch_wespeaker_from(emb) if embedder else None,
                    segmentation_step=STEP / 5.0,
                    segmentation_batch_size=BATCH,
                    embedding_batch_size=BATCH, device="cpu"))
        return built[embedder]
    return get


# leakage removal on and off without an embedding model, on with one
@pytest.mark.parametrize("embedder,leakage_removal",
                         [(False, True), (False, False), (True, True)])
def test_speech_separation_matches_jax(corpus, calibrated, pipelines,
                                       embedder, leakage_removal):
    threshold = calibrated[3]
    jax_pipeline, port = pipelines(embedder)
    frame = port._segmentation.model.receptive_field.step
    params = _params(threshold, leakage_removal)
    jax_pipeline.instantiate(params)
    port.instantiate(params)
    clusters = {"jax": [], "port": []}
    with pytest.MonkeyPatch.context() as mp:
        _capture_clusters(mp, jax_clustering.AgglomerativeClustering,
                          clusters["jax"])
        _capture_clusters(mp, clustering.AgglomerativeClustering,
                          clusters["port"])
        expected = jax_pipeline(dict(corpus), max_speakers=3)
        ours = port(dict(corpus), max_speakers=3)
    assert isinstance(ours, SeparationOutput)
    np.testing.assert_array_equal(clusters["port"][0], clusters["jax"][0])
    assert len(np.unique(clusters["port"][0])) >= 2
    for name in ("speaker_diarization", "exclusive_speaker_diarization"):
        a = _tracks(getattr(ours, name))
        b = _tracks(getattr(expected, name))
        assert len(a) == len(b) > 0
        for (seg_a, _, label_a), (seg_b, _, label_b) in zip(a, b):
            assert label_a == label_b
            assert abs(seg_a.start - seg_b.start) <= frame
            assert abs(seg_a.end - seg_b.end) <= frame
    assert ours.sources.shape == expected.sources.shape
    assert ours.sources.shape[0] == 30 * 16000
    assert rel_l2(ours.sources, np.asarray(expected.sources)) <= 1e-4
    if embedder:
        np.testing.assert_allclose(ours.speaker_embeddings,
                                   expected.speaker_embeddings, atol=2e-3)


def test_speech_separation_from_config_and_metric(tmp_path):
    """A config naming pyannote.audio.pipelines.SpeechSeparation resolves
    to the port; without a card the default device raises."""
    assert get_class_by_name("pyannote.audio.pipelines.SpeechSeparation") \
        is SpeechSeparation
    model = ToTaToNet(**HPARAMS, generator=torch.Generator().manual_seed(0))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            SpeechSeparation(model)
    pipeline = SpeechSeparation(model, device="cpu")
    assert type(pipeline.get_metric()).__name__ == \
        "GreedyDiarizationErrorRate"
