"""The port's models and converters against the JAX package.

Each test builds the JAX model from a seed, perturbs its norms so they
matter, carries the weights across with ``utils/convert.py``, feeds both
sides the same numpy inputs and compares. Tolerances: SincNet and PyanNet
2e-4 (as the JAX package's torch-replica test), fbank 1e-3 (log-mel
through another rfft), WeSpeaker 2e-3 (conv summation order). The bf16
trunk against the JAX default bf16 trunk: frames within 2e-2 of the
frames' largest magnitude (a few bf16 roundings, 2^-8 relative each, that
oneDNN and XLA place differently) and 2e-3 in the mean; and the port's
bf16 error against the float32 trunk at most 2x the JAX bf16 error.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pyannote_audio_tpu.core.model import (Problem, Resolution,
                                           Specifications)
from pyannote_audio_tpu.models.embedding.wespeaker import (
    BaseWeSpeakerResNet, WeSpeakerModule)
from pyannote_audio_tpu.models.segmentation.pyannet import PyanNet
from pyannote_audio_tpu.ops.fbank import wespeaker_fbank as jax_fbank
from pyannote_audio_tpu_torch.core.model import \
    Specifications as TorchSpecifications
from pyannote_audio_tpu_torch.models.embedding.wespeaker import \
    WeSpeakerResNet34 as TorchWeSpeaker
from pyannote_audio_tpu_torch.models.segmentation.pyannet import \
    PyanNet as TorchPyanNet
from pyannote_audio_tpu_torch.ops.fbank import wespeaker_fbank
from pyannote_audio_tpu_torch.utils.convert import (pyannet_state_dict,
                                                    wespeaker_state_dict)

@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Each port test module runs torch on one intra-op thread, restored
    after the module. The suite runs six pytest workers on one machine,
    and torch's default of a thread per core in each of them oversubscribes
    its cores: a port test file ran 5x slower so (tests/test_torch_port_
    hooks.py, six copies at once on 8 CPU cores: 146 s each against 28 s
    on one thread). Every port test module imports this fixture."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


SMALL_BLOCKS = (1, 1, 1, 1)
SMALL_CHANNELS = 8


def perturb(tree, rng):
    """Move norm affines and batch-norm statistics off their identity
    init (numpy leaves, path-aware)."""
    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        x = np.asarray(node, dtype=np.float32)
        name = path[-1]
        if name == "scale":
            return x * rng.uniform(0.7, 1.3, x.shape).astype(np.float32)
        if name == "bias" and any("norm" in p or "bn" in p for p in path):
            return x + rng.normal(0, 0.1, x.shape).astype(np.float32)
        if name == "mean":
            return x + rng.normal(0, 0.2, x.shape).astype(np.float32)
        if name == "var":
            return x * rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
        return x
    return walk(tree, ())


def jax_pyannet(duration=2.0, seed=0):
    model = PyanNet(lstm={"hidden_size": 16}, linear={"hidden_size": 16})
    model.specifications = Specifications(
        problem=Problem.MONO_LABEL_CLASSIFICATION,
        resolution=Resolution.FRAME, duration=duration,
        classes=["a", "b", "c"], powerset_max_classes=2)
    model.build(jax.random.PRNGKey(seed))
    model.params = perturb(jax.tree_util.tree_map(np.asarray, model.params),
                           np.random.default_rng(seed))
    return model


def torch_pyannet_from(model):
    spec = model.specifications
    port = TorchPyanNet(
        TorchSpecifications(duration=spec.duration, classes=spec.classes,
                            powerset_max_classes=spec.powerset_max_classes),
        lstm_hidden=16, linear_hidden=16)
    port.load_reference_state_dict(
        pyannet_state_dict(model.params, model.hparams))
    return port.eval()


class SmallWeSpeaker(BaseWeSpeakerResNet):
    """A narrow, shallow ResNet in float32 (the JAX module defaults to a
    bf16 trunk even on the CPU)."""

    NUM_BLOCKS = SMALL_BLOCKS
    COMPUTE_DTYPE = jnp.float32

    def build_module(self):
        return WeSpeakerModule(num_blocks=SMALL_BLOCKS,
                               m_channels=SMALL_CHANNELS,
                               compute_dtype=self.COMPUTE_DTYPE)


class SmallWeSpeakerBF16(SmallWeSpeaker):
    """The same ResNet with the JAX module's default bf16 trunk."""

    COMPUTE_DTYPE = jnp.bfloat16


def jax_wespeaker(seed=0, klass=SmallWeSpeaker):
    model = klass()
    model.build(jax.random.PRNGKey(seed))
    model.params = perturb(jax.tree_util.tree_map(np.asarray, model.params),
                           np.random.default_rng(seed))
    return model


def torch_wespeaker_from(model, compute_dtype=torch.float32):
    """The port's WeSpeaker with ``model``'s weights; float32 by default,
    as ``SmallWeSpeaker`` pins the JAX side."""
    port = TorchWeSpeaker(num_blocks=SMALL_BLOCKS, m_channels=SMALL_CHANNELS,
                          compute_dtype=compute_dtype)
    port.load_reference_state_dict(wespeaker_state_dict(model.params))
    return port.eval()


def _wave(batch, seconds, seed):
    rng = np.random.default_rng(seed)
    return (0.1 * rng.standard_normal((batch, 1, int(16000 * seconds)))
            ).astype(np.float32)


def test_sincnet_and_pyannet_match_jax():
    model = jax_pyannet()
    port = torch_pyannet_from(model)
    wav = _wave(2, 2.0, seed=1)
    params = jax.tree_util.tree_map(jnp.asarray, model.params)
    expected_sinc = np.asarray(model.module.apply(
        params, jnp.asarray(wav), method=lambda m, x: m.sincnet(x)))
    expected = np.asarray(model.module.apply(params, jnp.asarray(wav)))
    with torch.no_grad():
        x = torch.from_numpy(wav)
        ours_sinc = port.sincnet(x).numpy()
        ours = port(x).numpy()
    assert ours_sinc.shape == expected_sinc.shape
    np.testing.assert_allclose(ours_sinc, expected_sinc, atol=2e-4)
    assert ours.shape == expected.shape == (2, port.num_frames(32000), 7)
    np.testing.assert_allclose(ours, expected, atol=2e-4)
    # same frame arithmetic as the JAX model
    assert port.num_frames(32000) == model.num_frames(32000)
    for attr in ("duration", "step", "start"):
        assert getattr(port.receptive_field, attr) == \
            getattr(model.receptive_field, attr)


def test_fbank_matches_jax():
    wav = _wave(3, 1.3, seed=2)
    expected = np.asarray(jax_fbank(jnp.asarray(wav)))
    ours = wespeaker_fbank(torch.from_numpy(wav)).numpy()
    assert ours.shape == expected.shape == (3, 128, 80)
    np.testing.assert_allclose(ours, expected, atol=1e-3)


def test_wespeaker_frames_and_masked_embeddings_match_jax():
    model = jax_wespeaker()
    port = torch_wespeaker_from(model)
    wav = _wave(3, 2.0, seed=3)
    # (batch, speakers, segmentation frames) masks, one all-zero speaker
    masks = (np.random.default_rng(4).uniform(size=(3, 3, 117)) > 0.4
             ).astype(np.float32)
    masks[1, 2] = 0.0
    params = jax.tree_util.tree_map(jnp.asarray, model.params)
    frames = model.module.apply(params, jnp.asarray(wav),
                                method=WeSpeakerModule.frames)
    expected = np.asarray(model.module.apply(
        params, frames, jnp.asarray(masks), method=WeSpeakerModule.embed))
    with torch.no_grad():
        ours_frames = port.frames(torch.from_numpy(wav))
        ours = port.embed(ours_frames, torch.from_numpy(masks)).numpy()
    np.testing.assert_allclose(ours_frames.numpy(), np.asarray(frames),
                               atol=2e-3)
    assert ours.shape == expected.shape == (3, 3, 256)
    np.testing.assert_allclose(ours, expected, atol=2e-3)


def test_wespeaker_bf16_trunk_matches_jax_default_bf16():
    """The port's default bf16 trunk against the JAX module's default bf16
    trunk, both held to the float32 trunk."""
    port = torch_wespeaker_from(jax_wespeaker(seed=9), torch.bfloat16)
    assert TorchWeSpeaker().compute_dtype == torch.bfloat16   # the default
    wav = _wave(3, 2.0, seed=10)
    masks = np.random.default_rng(11).uniform(size=(3, 2, 117)
                                              ).astype(np.float32)
    outputs = {}
    for name, klass in (("f32", SmallWeSpeaker),
                        ("bf16", SmallWeSpeakerBF16)):
        model = jax_wespeaker(seed=9, klass=klass)
        params = jax.tree_util.tree_map(jnp.asarray, model.params)
        frames = model.module.apply(params, jnp.asarray(wav),
                                    method=WeSpeakerModule.frames)
        outputs[name] = (np.asarray(frames), np.asarray(model.module.apply(
            params, frames, jnp.asarray(masks),
            method=WeSpeakerModule.embed)))
    with torch.no_grad():
        frames = port.frames(torch.from_numpy(wav))
        ours = (frames.numpy(),
                port.embed(frames, torch.from_numpy(masks)).numpy())
    assert frames.dtype == torch.float32
    for k in (0, 1):
        f32, bf16, port_bf16 = outputs["f32"][k], outputs["bf16"][k], ours[k]
        scale = np.abs(f32).max()
        assert np.abs(port_bf16 - bf16).max() <= 2e-2 * scale
        assert np.abs(port_bf16 - bf16).mean() <= 2e-3 * scale
        # rounding order of XLA and oneDNN aside: as far from float32 as
        # the JAX bf16 trunk is
        for reduce in (np.max, np.mean):
            jax_err = reduce(np.abs(bf16 - f32))
            assert jax_err > 0                       # bf16 really ran
            assert reduce(np.abs(port_bf16 - f32)) <= 2 * jax_err


def test_pyannet_converter_equals_export():
    model = jax_pyannet(seed=5)
    ours = pyannet_state_dict(model.params, model.hparams)
    theirs = model.export_torch_state_dict()
    assert ours.keys() == theirs.keys()
    for key in theirs:
        np.testing.assert_array_equal(ours[key], theirs[key], err_msg=key)
    # the port's module has exactly this key layout
    assert set(torch_pyannet_from(model).state_dict()) == set(theirs)


def test_wespeaker_converter_equals_export():
    model = jax_wespeaker(seed=6)
    ours = wespeaker_state_dict(model.params)
    theirs = model.export_torch_state_dict()
    assert ours.keys() == theirs.keys()
    assert any(k.endswith("running_var") for k in theirs)
    for key in theirs:
        np.testing.assert_array_equal(ours[key], theirs[key], err_msg=key)
    port = torch_wespeaker_from(model)
    assert set(port.state_dict()) == set(theirs)
    # BatchNorm running statistics arrived
    np.testing.assert_array_equal(
        port.resnet.bn1.running_var.numpy(),
        np.asarray(model.params["batch_stats"]["trunk"]["bn1"]["var"]))


@pytest.mark.parametrize("layout", ["monolithic", "per_layer"])
def test_pyannet_loader_accepts_both_lstm_layouts(layout):
    """Both reference LSTM key layouts load into the same weights; the
    per-layer ``lstm.{i}.weight_ih_l0`` one is what the JAX package's
    ``convert_torch_state_dict`` reads for ``monolithic=False``."""
    model = jax_pyannet(seed=8)
    state = pyannet_state_dict(model.params, model.hparams)
    if layout == "per_layer":
        renamed = {}
        for key, value in state.items():
            parts = key.split(".")
            if parts[0] == "lstm":
                name = parts[1]
                layer = name.split("_l")[1][0]
                key = f"lstm.{layer}." + name.replace(f"_l{layer}", "_l0", 1)
            renamed[key] = value
        state = renamed
        assert "lstm.1.weight_ih_l0_reverse" in state
    # the JAX converter reads this layout back to the same params
    back = model.convert_torch_state_dict(state)["params"]["lstm"]
    for name, value in model.params["params"]["lstm"].items():
        np.testing.assert_array_equal(back[name], value)
    port = TorchPyanNet(lstm_hidden=16, linear_hidden=16)
    port.load_reference_state_dict(state)
    np.testing.assert_array_equal(
        port.lstm.weight_ih_l1_reverse.detach().numpy(),
        model.params["params"]["lstm"]["w_ih_l1_reverse"])
