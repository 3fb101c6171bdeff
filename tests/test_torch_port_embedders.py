"""The port's speaker embedders and their front-ends against the JAX
package: every WeSpeaker depth (the Bottleneck block), the x-vectors,
ECAPA-TDNN, TitaNet, the SpeechBrain / NeMo / MFCC front-ends, the
statistics pooling on x-vector shapes and the ONNX weight reader.

Each JAX model is built once per file from a seed, its norms perturbed so
that they matter, and carried across through its own exporter
(``export_torch_state_dict``, ``export_speechbrain_state_dict``,
``export_nemo_state_dict``); the port's exporters must give back what its
loaders read. Tolerances: front-ends 1e-3 (log-mel through another FFT);
ECAPA and TitaNet rtol 2e-3 / atol 2e-4 (as the JAX package's replica
tests); x-vectors 2e-4; WeSpeaker float32 2e-3 and the bf16 trunk by the
bound of tests/test_torch_port_models.py; pooling 1e-5; NaN rows equal.
ECAPA and TitaNet run at the JAX tests' tiny widths
(tests/test_ecapa_parity.py ``CFG``, tests/test_titanet_parity.py
``SMALL_BLOCKS``); the x-vectors at their published widths.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pyannote_audio_tpu.models.blocks.pooling import \
    stats_pool as jax_stats_pool
from pyannote_audio_tpu.models.embedding import ecapa as jax_ecapa
from pyannote_audio_tpu.models.embedding import titanet as jax_titanet
from pyannote_audio_tpu.models.embedding import wespeaker as jax_wespeaker
from pyannote_audio_tpu.models.embedding import xvector as jax_xvector
from pyannote_audio_tpu.ops.fbank import (nemo_mel_spectrogram as
                                          jax_nemo_mel,
                                          speechbrain_fbank as
                                          jax_speechbrain_fbank)
from pyannote_audio_tpu.utils import onnx as jax_onnx
from pyannote_audio_tpu_torch.core.inference import pad_to_grid
from pyannote_audio_tpu_torch.models.blocks.pooling import stats_pool
from pyannote_audio_tpu_torch.models.embedding import (ecapa, titanet,
                                                       wespeaker, xvector)
from pyannote_audio_tpu_torch.models.segmentation.pyannet import PyanNet
from pyannote_audio_tpu_torch.ops import fbank
from pyannote_audio_tpu_torch.ops.fbank import fbank_num_frames
from pyannote_audio_tpu_torch.pipelines.speaker_diarization import \
    SpeakerDiarization
from pyannote_audio_tpu_torch.utils import onnx
from pyannote_audio_tpu_torch.utils.convert import wespeaker_state_dict
from test_torch_port_models import perturb

ECAPA_CFG = dict(n_mels=24, channels=(32, 32, 32, 32, 96),
                 kernel_sizes=(5, 3, 3, 3, 1), dilations=(1, 2, 3, 4, 1),
                 attention_channels=16, res2net_scale=4, se_channels=16,
                 global_context=True, lin_neurons=32)
TITANET_BLOCKS = [
    dict(filters=16, repeat=1, kernel=3, residual=False, separable=True,
         se=True),
    dict(filters=16, repeat=2, kernel=7, residual=True, separable=True,
         se=True),
    dict(filters=24, repeat=1, kernel=1, residual=False, separable=False,
         se=True),
]
TITANET_CFG = dict(n_mels=12, blocks=TITANET_BLOCKS, emb_dim=16,
                   attention_channels=8)
DEPTHS = (18, 34, 50, 101, 152, 221, 293)


def _wave(batch, samples, seed):
    rng = np.random.default_rng(seed)
    return (0.1 * rng.standard_normal((batch, 1, samples))).astype(
        np.float32)


def _masks(batch, frames, seed):
    """Binary (batch, frames) masks: row 0 full, row 1 partly silent, the
    last row all silent."""
    rng = np.random.default_rng(seed)
    masks = (rng.uniform(size=(batch, frames)) > 0.3).astype(np.float32)
    masks[0] = 1.0
    masks[-1] = 0.0
    return masks


def _built(model, seed):
    model.build(jax.random.PRNGKey(seed))
    model.params = perturb(jax.tree_util.tree_map(np.asarray, model.params),
                           np.random.default_rng(seed))
    return model


def _close(ours, expected, rtol=2e-3, atol=2e-4):
    ours, expected = np.asarray(ours), np.asarray(expected)
    assert ours.shape == expected.shape
    np.testing.assert_array_equal(np.isnan(ours), np.isnan(expected))
    np.testing.assert_allclose(ours, expected, rtol=rtol, atol=atol,
                               equal_nan=True)


def _run(model, *args):
    with torch.no_grad():
        return model(*[None if a is None else torch.from_numpy(a)
                       for a in args]).numpy()


# -- front-ends -----------------------------------------------------------------

def test_speechbrain_fbank_matches_jax():
    wav = _wave(3, 16000 + 77, seed=1)
    expected = np.asarray(jax_speechbrain_fbank(jnp.asarray(wav)))
    ours = fbank.speechbrain_fbank(torch.from_numpy(wav)).numpy()
    assert ours.shape == expected.shape == (3, 101, 80)
    np.testing.assert_allclose(ours, expected, atol=1e-3)


@pytest.mark.parametrize("masking", ["none", "lengths", "frame_mask"])
def test_nemo_mel_matches_jax(masking):
    wav = _wave(3, 16000, seed=2)
    kwargs_jax, kwargs = {}, {}
    if masking == "lengths":
        lengths = np.array([16000, 9000, 3000])
        kwargs_jax["lengths"] = jnp.asarray(lengths)
        kwargs["lengths"] = torch.from_numpy(lengths)
    elif masking == "frame_mask":
        mask = _masks(3, 101, seed=3)
        mask[2, :40] = 1.0              # holes inside as well as a tail
        kwargs_jax["frame_mask"] = jnp.asarray(mask)
        kwargs["frame_mask"] = torch.from_numpy(mask)
    expected = np.asarray(jax_nemo_mel(
        jnp.asarray(wav), **kwargs_jax))
    ours = fbank.nemo_mel_spectrogram(torch.from_numpy(wav), **kwargs).numpy()
    assert ours.shape == expected.shape == (3, 101, 80)
    np.testing.assert_allclose(ours, expected, atol=1e-3)


def test_mfcc_matches_jax():
    wav = _wave(2, 16000 + 123, seed=4)
    wav[1] *= 1e-3                  # another level: the per-item top_db
    expected = np.asarray(jax_xvector.mfcc_features(jnp.asarray(wav)))
    ours = fbank.mfcc_features(torch.from_numpy(wav)).numpy()
    assert ours.shape == expected.shape == (2, 81, 40)
    np.testing.assert_allclose(ours, expected, atol=1e-3)


@pytest.mark.parametrize("weights", ["none", "slower_rate", "speakers"])
def test_stats_pool_on_xvector_shapes(weights):
    rng = np.random.default_rng(5)
    sequences = rng.standard_normal((3, 1500, 149)).astype(np.float32)
    w = {"none": None,
         "slower_rate": rng.uniform(size=(3, 58)).astype(np.float32),
         "speakers": rng.uniform(size=(3, 2, 589)).astype(np.float32)
         }[weights]
    expected = np.asarray(jax_stats_pool(
        jnp.asarray(sequences), None if w is None else jnp.asarray(w)))
    ours = stats_pool(torch.from_numpy(sequences),
                      None if w is None else torch.from_numpy(w)).numpy()
    assert ours.shape == expected.shape
    np.testing.assert_allclose(ours, expected, rtol=1e-5, atol=1e-5)


# -- ONNX -------------------------------------------------------------------------

def test_onnx_reader_and_writer_match_jax(tmp_path):
    rng = np.random.default_rng(6)
    weights = {"layer1.0.conv1.weight":
               rng.standard_normal((4, 2, 3, 3)).astype(np.float32),
               "bn1.running_mean": rng.standard_normal(4).astype(np.float64),
               "bn1.num_batches_tracked": np.asarray(-1, dtype=np.int64),
               "half": rng.standard_normal(5).astype(np.float16)}
    ours_file, theirs_file = tmp_path / "port.onnx", tmp_path / "jax.onnx"
    onnx.write_onnx_initializers(ours_file, weights)
    jax_onnx.write_onnx_initializers(theirs_file, weights)
    assert ours_file.read_bytes() == theirs_file.read_bytes()
    for read in (onnx.read_onnx_initializers,
                 jax_onnx.read_onnx_initializers):
        back = read(ours_file)
        assert back.keys() == weights.keys()
        for key, value in weights.items():
            assert back[key].dtype == value.dtype
            np.testing.assert_array_equal(back[key], value)


# -- WeSpeaker depths ---------------------------------------------------------------

@pytest.mark.parametrize("depth", DEPTHS)
def test_wespeaker_depths_as_jax(depth):
    """Every depth under the JAX name, with its blocks and block type, and
    the bare ResNet alias."""
    ours = getattr(wespeaker, f"WeSpeakerResNet{depth}")
    theirs = getattr(jax_wespeaker, f"WeSpeakerResNet{depth}")
    assert ours.NUM_BLOCKS == theirs.NUM_BLOCKS
    assert ours.BOTTLENECK == theirs.BOTTLENECK
    assert getattr(wespeaker, f"ResNet{depth}") is ours
    assert issubclass(ours, wespeaker.BaseWeSpeakerResNet)


class SmallBottleneck(jax_wespeaker.BaseWeSpeakerResNet):
    """A shallow, narrow Bottleneck ResNet (``COMPUTE_DTYPE`` trunk)."""

    NUM_BLOCKS = (1, 1, 1, 1)
    BOTTLENECK = True
    COMPUTE_DTYPE = jnp.float32

    def build_module(self):
        return jax_wespeaker.WeSpeakerModule(
            num_blocks=self.NUM_BLOCKS, m_channels=4, bottleneck=True,
            compute_dtype=self.COMPUTE_DTYPE)


class SmallBottleneckBF16(SmallBottleneck):
    COMPUTE_DTYPE = jnp.bfloat16


@pytest.fixture(scope="module")
def bottleneck_pair():
    model = _built(SmallBottleneck(), seed=7)
    state = model.export_torch_state_dict()
    port = wespeaker.WeSpeakerResNet50(
        num_blocks=(1, 1, 1, 1), m_channels=4, compute_dtype=torch.float32)
    return model, state, port.load_reference_state_dict(state).eval()


def test_bottleneck_state_dict_both_ways(bottleneck_pair):
    model, state, port = bottleneck_pair
    assert any(".conv3." in k for k in state)
    assert set(port.state_dict()) == set(state)
    ours = wespeaker_state_dict(model.params)
    assert ours.keys() == state.keys()
    for key, value in port.state_dict().items():
        np.testing.assert_array_equal(value.numpy(), state[key], err_msg=key)
        np.testing.assert_array_equal(ours[key], state[key], err_msg=key)


def test_bottleneck_masked_embeddings_match_jax(bottleneck_pair):
    model, _, port = bottleneck_pair
    wav = _wave(3, 32000, seed=8)
    masks = (np.random.default_rng(9).uniform(size=(3, 2, 117)) > 0.4
             ).astype(np.float32)
    expected = np.asarray(model(wav, masks))
    ours = _run(port, wav, masks)
    assert ours.shape == expected.shape == (3, 2, 256)
    np.testing.assert_allclose(ours, expected, atol=2e-3)
    with torch.no_grad():
        frames = port.frames(torch.from_numpy(wav))
    assert port.resnet.num_frames(fbank_num_frames(32000)) == \
        model.num_frames(32000) == frames.shape[1]


def test_bottleneck_bf16_trunk_matches_jax_default_bf16(bottleneck_pair):
    """The bound of tests/test_torch_port_models.py for ResNet34's bf16
    trunk, on the Bottleneck block's embeddings."""
    model, state, _ = bottleneck_pair
    port = wespeaker.WeSpeakerResNet50(num_blocks=(1, 1, 1, 1), m_channels=4)
    assert port.compute_dtype == torch.bfloat16           # the default
    port.load_reference_state_dict(state).eval()
    wav = _wave(3, 32000, seed=10)
    f32 = np.asarray(model(wav))
    bf16 = np.asarray(_built(SmallBottleneckBF16(), seed=7)(wav))
    port_bf16 = _run(port, wav)
    scale = np.abs(f32).max()
    assert np.abs(port_bf16 - bf16).max() <= 2e-2 * scale
    assert np.abs(port_bf16 - bf16).mean() <= 2e-3 * scale
    for reduce in (np.max, np.mean):
        jax_err = reduce(np.abs(bf16 - f32))
        assert jax_err > 0                           # bf16 really ran
        assert reduce(np.abs(port_bf16 - f32)) <= 2 * jax_err


def test_trunk_panel_halo_covers_resnet293():
    """The shared trunk's panel halo at ResNet293's real depth (narrow
    channels: depth, not width, sets the receptive field). An impulse in
    the fbank moves trunk frames up to about 35 frames away, within
    TRUNK_PANEL_HALO = 64; panels then equal one unpanelled pass over the
    same layout, while a halo of 8 frames parts from it at the panel
    borders (so the check can fail)."""
    emb = wespeaker.WeSpeakerResNet293(m_channels=2,
                                       compute_dtype=torch.float32,
                                       generator=torch.Generator()
                                       .manual_seed(11)).eval()
    pipeline = SpeakerDiarization(PyanNet(), emb, device="cpu")
    halo = pipeline.TRUNK_PANEL_HALO
    with torch.no_grad():
        x = torch.from_numpy(_wave(1, 700 * 80, seed=12).reshape(1, 700, 80))
        moved = x.clone()
        moved[0, 352] += 1.0
        changed = torch.nonzero((emb.frames_from_fbank(moved, centered=True)
                                 - emb.frames_from_fbank(x, centered=True))
                                .abs().amax(-1)[0] > 0).flatten()
    reach = max(352 // 8 - changed.min().item(),
                changed.max().item() - 352 // 8)
    assert 8 < reach < halo

    # 12 s in panels of 64 trunk frames, 2 per batch: borders at 64, 128
    pipeline.TRUNK_PANEL_CORE, pipeline.TRUNK_PANEL_BATCH = 64, 2
    window = 10 * 16000
    waveform = torch.from_numpy(_wave(1, 16000 * 12, seed=13)[0])
    padded = pad_to_grid(waveform, window, 16000)
    num_real = fbank_num_frames(waveform.shape[1])
    total = -(-fbank_num_frames(padded.shape[1]) // 8)
    errors = {}
    with torch.no_grad():
        for pipeline.TRUNK_PANEL_HALO in (halo, 8):
            trunk = pipeline.compute_trunk(padded, num_real, window)
            layout = pipeline.prepare(pipeline._whole_fbank(padded),
                                      num_real, window)
            whole = emb.frames_from_fbank(layout[None], centered=True)[0]
            ref = whole[pipeline.TRUNK_PANEL_HALO:][:total]
            errors[pipeline.TRUNK_PANEL_HALO] = (
                (trunk[:total] - ref).abs().max() / ref.abs().max()).item()
    assert pipeline.counts["trunk_panel_batches"] == 4
    assert errors[halo] <= 1e-6
    assert errors[8] > 10 * max(errors[halo], 1e-7)


# -- x-vectors --------------------------------------------------------------------

@pytest.fixture(scope="module", params=["XVectorMFCC", "XVectorSincNet"])
def xvector_pair(request):
    model = _built(getattr(jax_xvector, request.param)(), seed=13)
    state = model.export_torch_state_dict()
    port = getattr(xvector, request.param)()
    return model, state, port.load_reference_state_dict(state).eval()


def test_xvector_state_dict_both_ways(xvector_pair):
    model, state, port = xvector_pair
    assert set(port.state_dict()) == set(state)
    for key, value in port.state_dict().items():
        np.testing.assert_array_equal(value.numpy(), state[key], err_msg=key)
    back = model.convert_torch_state_dict(
        {k: v.numpy() for k, v in port.state_dict().items()})
    for path, leaf in jax.tree_util.tree_leaves_with_path(back):
        np.testing.assert_array_equal(leaf, _get(model.params, path))


def _get(tree, path):
    for key in path:
        tree = tree[key.key]
    return tree


@pytest.mark.parametrize("weights", ["none", "speakers"])
def test_xvector_matches_jax(xvector_pair, weights):
    model, _, port = xvector_pair
    wav = _wave(3, 32000, seed=14)
    w = None if weights == "none" else np.random.default_rng(15).uniform(
        size=(3, 2, 58)).astype(np.float32)
    expected = np.asarray(model(wav, w))
    ours = _run(port, wav, w)
    assert ours.shape == expected.shape
    np.testing.assert_allclose(ours, expected, atol=2e-4)
    with torch.no_grad():
        frames = port.frames(torch.from_numpy(wav))
    assert frames.shape == (3, model.num_frames(32000), 1500)
    assert port.num_frames(32000) == model.num_frames(32000)
    for n in (1, 5):
        assert port.receptive_field_size(n) == model.receptive_field_size(n)
        assert port.receptive_field_center(n) == \
            model.receptive_field_center(n)
    assert port.dimension == model.dimension == 512


def test_xvector_mfcc_buffers_are_ignored():
    """A reference XVectorMFCC checkpoint carries torchaudio's buffers
    (``mfcc.*``), which the port derives."""
    port = xvector.XVectorMFCC()
    state = {k: v.numpy() for k, v in port.state_dict().items()}
    state["mfcc.MelSpectrogram.spectrogram.window"] = np.ones(400)
    state["mfcc.dct_mat"] = np.ones((128, 40))
    port.load_reference_state_dict(state)


# -- ECAPA-TDNN ---------------------------------------------------------------------

@pytest.fixture(scope="module")
def ecapa_pair():
    model = _built(jax_ecapa.ECAPA_TDNN(**ECAPA_CFG), seed=16)
    state = model.export_speechbrain_state_dict()
    port = ecapa.ECAPA_TDNN(**ECAPA_CFG)
    return model, state, port.convert_speechbrain_state_dict(state).eval()


def test_ecapa_state_dict_both_ways(ecapa_pair):
    model, state, port = ecapa_pair
    ours = port.export_speechbrain_state_dict()
    assert ours.keys() == state.keys()
    for key in state:
        np.testing.assert_array_equal(ours[key], state[key], err_msg=key)
    assert ecapa._infer_ecapa_config(ours, {}) == \
        jax_ecapa._infer_ecapa_config(state, {})


@pytest.mark.parametrize("masked", [False, True])
def test_ecapa_matches_jax(ecapa_pair, masked):
    model, _, port = ecapa_pair
    wav = _wave(4, 16000, seed=17)
    w = _masks(4, 37, seed=18) if masked else None
    expected = np.asarray(model(wav, w))
    ours = _run(port, wav, w)
    _close(ours, expected)
    if masked:                        # the all-silent row is the sentinel
        assert np.isnan(ours[-1]).all() and np.isfinite(ours[:-1]).all()


def test_ecapa_frame_mask_entry_matches_jax(ecapa_pair):
    model, _, port = ecapa_pair
    signals = _wave(3, 12000, seed=19)[:, 0]
    mask = (np.arange(76)[None, :] < np.array([[76], [50], [20]])
            ).astype(np.float32)
    expected = np.asarray(model.forward_with_frame_mask(signals, mask))
    with torch.no_grad():
        ours = port.forward_with_frame_mask(torch.from_numpy(signals),
                                            torch.from_numpy(mask)).numpy()
    _close(ours, expected)


@pytest.mark.parametrize("extra", [0, 1])
def test_ecapa_at_its_minimum_length(ecapa_pair, extra):
    """Reflect padding with dilation: lengths at and just above
    ``min_num_samples`` run and match; one hop below it fails."""
    model, _, port = ecapa_pair
    assert port.min_num_samples == model.min_num_samples == 640
    wav = _wave(2, port.min_num_samples + extra, seed=20)
    _close(_run(port, wav), np.asarray(model(wav)))
    with pytest.raises(RuntimeError):
        _run(port, _wave(1, port.min_num_samples - 160, seed=20))


def test_ecapa_from_speechbrain_snapshot(ecapa_pair, tmp_path):
    model, state, port = ecapa_pair
    torch.save({k: torch.from_numpy(np.array(v)) for k, v in state.items()},
               tmp_path / "embedding_model.ckpt")
    text = ("sample_rate: 16000\nn_mels: 24\n"
            "embedding_model: !new:speechbrain.lobes.models.ECAPA_TDNN."
            "ECAPA_TDNN\n    input_size: !ref <n_mels>\n"
            "    channels: [32, 32, 32, 32, 96]\n"
            "    kernel_sizes: [5, 3, 3, 3, 1]\n"
            "    dilations: [1, 2, 3, 4, 1]\n    global_context: True\n"
            "    lin_neurons: 32\n")
    (tmp_path / "hyperparams.yaml").write_text(text)
    assert ecapa._parse_hyperparams(text) == \
        jax_ecapa._parse_hyperparams(text)
    loaded = ecapa.ECAPA_TDNN.from_speechbrain(tmp_path)
    assert not loaded.training
    wav = _wave(2, 16000, seed=21)
    np.testing.assert_array_equal(_run(loaded, wav), _run(port, wav))
    jax_loaded = jax_ecapa.ECAPA_TDNN.from_speechbrain(tmp_path)
    _close(_run(loaded, wav), np.asarray(jax_loaded(wav)))
    with pytest.raises(ValueError, match="no hub access"):
        ecapa.ECAPA_TDNN.from_speechbrain("speechbrain/spkrec-ecapa-voxceleb")


# -- TitaNet ------------------------------------------------------------------------

@pytest.fixture(scope="module")
def titanet_pair():
    model = _built(jax_titanet.TitaNet(**TITANET_CFG), seed=22)
    state = jax_titanet.export_nemo_state_dict(model)
    port = titanet.TitaNet(**TITANET_CFG)
    return model, state, port.convert_nemo_state_dict(state).eval()


def test_titanet_state_dict_both_ways(titanet_pair):
    model, state, port = titanet_pair
    ours = titanet.export_nemo_state_dict(port)
    assert ours.keys() == state.keys()
    for key in state:
        np.testing.assert_array_equal(ours[key], state[key], err_msg=key)
    for cfg in TITANET_BLOCKS:
        assert {k.replace(".", "_"): v for k, v in
                titanet._mconv_layout(cfg).items()} == \
            jax_titanet._mconv_layout(cfg)


@pytest.mark.parametrize("masked", [False, True])
def test_titanet_matches_jax(titanet_pair, masked):
    model, _, port = titanet_pair
    wav = _wave(4, 16000, seed=23)
    w = _masks(4, 50, seed=24) if masked else None
    _close(_run(port, wav, w), np.asarray(model(wav, w)))


def test_titanet_frame_mask_entry_matches_jax(titanet_pair):
    model, _, port = titanet_pair
    signals = _wave(3, 12000, seed=25)[:, 0]
    mask = (np.arange(76)[None, :] < np.array([[76], [40], [11]])
            ).astype(np.float32)
    expected = np.asarray(model.forward_with_frame_mask(signals, mask))
    with torch.no_grad():
        ours = port.forward_with_frame_mask(torch.from_numpy(signals),
                                            torch.from_numpy(mask)).numpy()
    _close(ours, expected)
    assert port.min_num_samples == model.min_num_samples == 1600
    assert port.num_frames(12000) == model.num_frames(12000) == 76


def test_titanet_nemo_archive_both_ways(titanet_pair, tmp_path):
    """The port's archive loads in both packages, the JAX package's in the
    port, and an extracted directory as well."""
    import tarfile
    model, _, port = titanet_pair
    wav = _wave(2, 16000, seed=26)
    ours = titanet.export_nemo_checkpoint(port, tmp_path / "port")
    theirs = jax_titanet.export_nemo_checkpoint(model, tmp_path / "jax")
    expected = _run(port, wav)
    np.testing.assert_array_equal(
        _run(titanet.TitaNet.from_nemo(ours), wav), expected)
    _close(np.asarray(jax_titanet.TitaNet.from_nemo(ours)(wav)), expected)
    _close(_run(titanet.TitaNet.from_nemo(theirs), wav), expected)
    with tarfile.open(ours) as tar:
        tar.extractall(tmp_path / "extracted", filter="data")
    np.testing.assert_array_equal(
        _run(titanet.TitaNet.from_nemo(tmp_path / "extracted"), wav),
        expected)
    with pytest.raises(ValueError, match="no hub access"):
        titanet.TitaNet.from_nemo("nvidia/speakerverification_en_titanet")


def test_titanet_config_and_stride_check():
    config = {"preprocessor": {"sample_rate": 16000, "features": 12,
                               "window_size": 0.025, "window_stride": 0.01},
              "encoder": {"jasper": [
                  dict(b, kernel=[b["kernel"]], stride=[1])
                  for b in TITANET_BLOCKS]},
              "decoder": {"emb_sizes": [16], "attention_channels": 8}}
    assert titanet._model_kwargs_from_config(config) == \
        jax_titanet._model_kwargs_from_config(config)
    model = titanet.TitaNet(**titanet._model_kwargs_from_config(config))
    assert model.n_fft == 512 and model.blocks[1]["kernel"] == 7
    with pytest.raises(ValueError, match="stride"):
        titanet.TitaNet(blocks=[dict(TITANET_BLOCKS[0], stride=[2])])
    with pytest.raises(ValueError, match="stride"):
        jax_titanet.TitaNet(blocks=[dict(TITANET_BLOCKS[0], stride=[2])])


def test_titanet_large_layout_by_default():
    assert titanet.TITANET_LARGE_BLOCKS == jax_titanet.TITANET_LARGE_BLOCKS
    model = titanet.TitaNet()
    assert model.dimension == 192 and len(model.encoder) == 5
    assert model.encoder[-1].bn[0].num_features == 3072
