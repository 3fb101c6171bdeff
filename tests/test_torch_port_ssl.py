"""The port's SSL encoder, SSeRiouSS and the debug models against the JAX
package, at tiny widths (SSL hidden 32, 1-2 layers, 16 conv channels).

Each test builds the JAX model from a seed, perturbs its norms, carries
the weights across with ``utils/convert.py`` (held equal to the JAX
model's own ``export_torch_state_dict``), feeds both sides the same numpy
waveforms and compares. Tolerances: every SSL state 1e-4 (both trunk
kinds), SSeRiouSS log-probs 2e-4 (PyanNet's bound), the debug models
2e-4; the WavLM buckets exactly.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pyannote_audio_tpu.core.model import Model as JaxModel
from pyannote_audio_tpu.core.model import (Problem, Resolution,
                                           Specifications)
from pyannote_audio_tpu.models.blocks.ssl import RelPositionBias
from pyannote_audio_tpu.models.blocks.ssl import SSLEncoder as JaxSSLEncoder
from pyannote_audio_tpu.models.embedding.debug import \
    SimpleEmbeddingModel as JaxSimpleEmbedding
from pyannote_audio_tpu.models.segmentation.debug import \
    SimpleSegmentationModel as JaxSimpleSegmentation
from pyannote_audio_tpu.models.segmentation.sseriouss import \
    SSeRiouSS as JaxSSeRiouSS
from pyannote_audio_tpu.models.segmentation.sseriouss import \
    _infer_ssl_config as jax_infer_ssl_config
from pyannote_audio_tpu_torch.core.model import Model
from pyannote_audio_tpu_torch.core.model import \
    Specifications as TorchSpecifications
from pyannote_audio_tpu_torch.models.blocks.ssl import (
    SSLEncoder, infer_ssl_config, relative_position_buckets,
    torchaudio_layout)
from pyannote_audio_tpu_torch.models.embedding.debug import \
    SimpleEmbeddingModel
from pyannote_audio_tpu_torch.models.segmentation.debug import \
    SimpleSegmentationModel
from pyannote_audio_tpu_torch.models.segmentation.sseriouss import SSeRiouSS
from pyannote_audio_tpu_torch.utils.convert import (
    debug_embedding_state_dict, debug_segmentation_state_dict,
    sseriouss_state_dict, ssl_state_dict, write_reference_checkpoint)
from test_torch_port_models import _wave, perturb

# the two trunk kinds: BASE (post-LN, group-norm convs, WavLM's gated
# relative position bias) and LARGE (pre-LN, layer-norm convs)
TRUNKS = {
    "base": dict(hidden=32, layers=2, heads=4, ffn=64, conv_channels=16,
                 rel_pos_bias=True, pre_ln=False, conv_norm="group"),
    "large": dict(hidden=32, layers=2, heads=4, ffn=64, conv_channels=16,
                  rel_pos_bias=False, pre_ln=True, conv_norm="layer"),
}


def _jax_encoder(config, normalize_last=True):
    return JaxSSLEncoder(hidden=config["hidden"], layers=config["layers"],
                         heads=config["heads"], ffn=config["ffn"],
                         conv_channels=config["conv_channels"],
                         rel_pos_bias=config["rel_pos_bias"],
                         pre_ln=config["pre_ln"],
                         conv_norm_mode=config["conv_norm"],
                         normalize_last=normalize_last)


def _perturbed(params, seed):
    return perturb(jax.tree_util.tree_map(np.asarray, params),
                   np.random.default_rng(seed))


@pytest.mark.parametrize("kind", sorted(TRUNKS))
def test_ssl_encoder_matches_jax(kind):
    config = TRUNKS[kind]
    module = _jax_encoder(config)
    wav = _wave(2, 1.0, seed=3)[:, 0]
    params = _perturbed(jax.jit(module.init)(jax.random.PRNGKey(1),
                                             jnp.asarray(wav)), 1)
    expected = jax.jit(module.apply)(
        jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(wav))
    port = SSLEncoder(**config).eval()
    port.load_ssl_state_dict(ssl_state_dict(params["params"],
                                            config["layers"]))
    with torch.no_grad():
        ours = port(torch.from_numpy(wav))
    assert len(ours) == len(expected) == config["layers"] + 1
    for i, (a, b) in enumerate(zip(ours, expected)):
        assert a.shape == b.shape == (2, SSLEncoder.num_frames(16000),
                                      config["hidden"])
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4,
                                   err_msg=f"state {i}")
    # the torchaudio nesting loads into the same weights
    other = SSLEncoder(**config).load_ssl_state_dict(torchaudio_layout(
        ssl_state_dict(params["params"], config["layers"])))
    for (name, a), b in zip(port.state_dict().items(),
                            other.state_dict().values()):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=name)


def test_relative_position_buckets_match_jax():
    """WavLM's buckets, bucket for bucket, past the largest distance."""
    seq_len = 1700
    pos = np.arange(seq_len)
    rel = jnp.asarray(pos[None, :] - pos[:, None])
    expected = np.asarray(RelPositionBias(num_heads=4)._bucket(rel))
    ours = relative_position_buckets(seq_len).numpy()
    np.testing.assert_array_equal(ours, expected)
    # every bucket but 160 (a positive distance is at least 1)
    assert len(np.unique(ours)) == 319


def _jax_sseriouss(wav2vec_layer=-1, seed=0):
    model = JaxSSeRiouSS(wav2vec=dict(TRUNKS["base"]),
                         wav2vec_layer=wav2vec_layer,
                         lstm={"hidden_size": 16, "num_layers": 2},
                         linear={"hidden_size": 16})
    model.specifications = Specifications(
        problem=Problem.MONO_LABEL_CLASSIFICATION,
        resolution=Resolution.FRAME, duration=1.0, classes=["a", "b", "c"],
        powerset_max_classes=2)
    model.build(jax.random.PRNGKey(seed))
    params = _perturbed(model.params, seed)
    if wav2vec_layer < 0:
        # move the layer weights off their uniform init
        params["params"]["layer_weights"] = np.asarray(
            [0.3, -0.4], np.float32)
    model.params = params
    return model


def _torch_sseriouss_from(model):
    spec = model.specifications
    port = SSeRiouSS(TorchSpecifications(
        duration=spec.duration, classes=spec.classes,
        powerset_max_classes=spec.powerset_max_classes),
        wav2vec=dict(TRUNKS["base"]), wav2vec_layer=model.wav2vec_layer,
        lstm={"hidden_size": 16, "num_layers": 2},
        linear={"hidden_size": 16})
    state = sseriouss_state_dict(model.params, model.hparams,
                                 TRUNKS["base"]["layers"])
    return port.load_reference_state_dict(state).eval()


@pytest.mark.parametrize("wav2vec_layer", [-1, 1])
def test_sseriouss_matches_jax(wav2vec_layer):
    model = _jax_sseriouss(wav2vec_layer, seed=4)
    ours_state = sseriouss_state_dict(model.params, model.hparams,
                                      TRUNKS["base"]["layers"])
    theirs = model.export_torch_state_dict()
    assert ours_state.keys() == theirs.keys()
    for key in theirs:
        np.testing.assert_array_equal(ours_state[key], theirs[key],
                                      err_msg=key)
    port = _torch_sseriouss_from(model)
    wav = _wave(2, 1.0, seed=5)
    expected = np.asarray(model(jnp.asarray(wav)))
    with torch.no_grad():
        ours = port(torch.from_numpy(wav)).numpy()
    assert ours.shape == expected.shape == (2, 49, 7)
    np.testing.assert_allclose(ours, expected, atol=2e-4)
    assert port.num_frames(16000) == model.num_frames(16000)
    for attr in ("duration", "step", "start"):
        assert getattr(port.receptive_field, attr) == \
            getattr(model.receptive_field, attr)


def test_sseriouss_checkpoint_roundtrip(tmp_path):
    """The port writes the reference layout (trunk in torchaudio's
    nesting); the JAX package and the port both read it back to the same
    log-probs."""
    model = _jax_sseriouss(seed=6)
    port = _torch_sseriouss_from(model)
    state = port.export_torch_state_dict()
    assert "wav2vec.encoder.transformer.layers.0.attention.q_proj.weight" \
        in state and "wav2vec.encoder.feature_projection.projection.weight" \
        in state
    path = write_reference_checkpoint(state, "SSeRiouSS",
                                      port.reference_hparams(),
                                      port.specifications, tmp_path)
    loaded = Model.from_pretrained(tmp_path)
    theirs = JaxModel.from_pretrained(str(path))
    wav = _wave(1, 1.0, seed=7)
    with torch.no_grad():
        ours = loaded(torch.from_numpy(wav)).numpy()
        np.testing.assert_array_equal(ours, port(torch.from_numpy(wav))
                                      .numpy())
    np.testing.assert_allclose(ours, np.asarray(theirs(jnp.asarray(wav))),
                               atol=2e-4)


def test_sseriouss_per_layer_lstm_layout():
    """The per-layer ``lstm.{i}.weight_ih_l0`` layout (``monolithic``
    False) loads into the same weights in the port, and the JAX
    package's converter reads it back to the same parameters."""
    model = _jax_sseriouss(seed=10)
    state = sseriouss_state_dict(model.params, model.hparams,
                                 TRUNKS["base"]["layers"])
    per_layer = {}
    for key, value in state.items():
        parts = key.split(".")
        if parts[0] == "lstm":
            layer = parts[1].split("_l")[1][0]
            key = f"lstm.{layer}." + parts[1].replace(f"_l{layer}", "_l0", 1)
        per_layer[key] = value
    assert "lstm.1.weight_hh_l0_reverse" in per_layer
    port = _torch_sseriouss_from(model)
    other = _torch_sseriouss_from(model).load_reference_state_dict(per_layer)
    for (name, a), b in zip(port.state_dict().items(),
                            other.state_dict().values()):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=name)
    theirs = model.convert_torch_state_dict(per_layer)["params"]["lstm"]
    for key, value in model.params["params"]["lstm"].items():
        np.testing.assert_array_equal(theirs[key], value, err_msg=key)


@pytest.mark.parametrize("layout", ["hf", "torchaudio"])
def test_infer_ssl_config_matches_jax(layout):
    for config in TRUNKS.values():
        state = {k: v.numpy() for k, v in
                 SSLEncoder(**config).state_dict().items()}
        if layout == "torchaudio":
            state = torchaudio_layout(state)
        expected = jax_infer_ssl_config(state)
        assert infer_ssl_config(state) == expected
        # the head count is read off WavLM's weights only (else 64 per
        # head, as in the released models)
        assert {k: expected[k] for k in config if k != "heads"} == \
            {k: v for k, v in config.items() if k != "heads"}
        assert expected["heads"] == (4 if config["rel_pos_bias"] else 1)


def test_debug_models_match_jax(tmp_path):
    seg = JaxSimpleSegmentation()
    seg.specifications = Specifications(
        problem=Problem.MONO_LABEL_CLASSIFICATION,
        resolution=Resolution.FRAME, duration=2.0, classes=["a", "b", "c"],
        powerset_max_classes=2)
    seg.build(jax.random.PRNGKey(2))
    emb = JaxSimpleEmbedding()
    emb.build(jax.random.PRNGKey(3))
    wav = _wave(2, 2.0, seed=8)
    weights = np.random.default_rng(9).uniform(size=(2, 3, 50)).astype(
        np.float32)

    state = debug_segmentation_state_dict(seg.params)
    port_seg = SimpleSegmentationModel(TorchSpecifications(
        duration=2.0, classes=["a", "b", "c"], powerset_max_classes=2))
    port_seg.load_reference_state_dict(state).eval()
    write_reference_checkpoint(state, "SimpleSegmentationModel",
                               port_seg.reference_hparams(),
                               port_seg.specifications, tmp_path / "seg")
    port_emb = SimpleEmbeddingModel().load_reference_state_dict(
        debug_embedding_state_dict(emb.params)).eval()
    write_reference_checkpoint(port_emb.state_dict(), "SimpleEmbeddingModel",
                               port_emb.reference_hparams(), None,
                               tmp_path / "emb")
    with torch.no_grad():
        x = torch.from_numpy(wav)
        np.testing.assert_allclose(port_seg(x).numpy(),
                                   np.asarray(seg(jnp.asarray(wav))),
                                   atol=2e-4)
        np.testing.assert_allclose(
            port_emb(x, torch.from_numpy(weights)).numpy(),
            np.asarray(emb(jnp.asarray(wav), jnp.asarray(weights))),
            atol=2e-4)
        # Model.from_pretrained reads both back
        np.testing.assert_array_equal(
            Model.from_pretrained(tmp_path / "seg")(x).numpy(),
            port_seg(x).numpy())
        np.testing.assert_array_equal(
            Model.from_pretrained(tmp_path / "emb")(x).numpy(),
            port_emb(x).numpy())
    assert port_seg.num_frames(32000) == seg.num_frames(32000)
    assert port_emb.num_frames(32000) == emb.num_frames(32000)
