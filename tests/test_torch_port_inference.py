"""The port's ``Inference`` options against the JAX package's.

Small PyanNets (LSTM 16 wide, 1-2 layers) are built in JAX from a seed,
their weights carried across with ``utils/convert.py``; the waveforms are
seeded numpy noise. Tolerances: outputs that go through the model within
2e-4, the PyanNet bound of tests/test_torch_port_models.py (float32 sinc
convolutions summed in another order); the static ``aggregate`` and
``trim`` on identical chunk scores within 1e-5 (``index_add_`` sums in
another order); sliding windows, shapes, steps and missing frames
exactly; forced slices against whole-file runs within 1e-5.
"""

import warnings

import numpy as np
import pytest
import torch

import jax

from pyannote_audio_tpu.core.inference import Inference as JaxInference
from pyannote_audio_tpu.core.model import (Problem, Resolution,
                                           Specifications)
from pyannote_audio_tpu.core.segment import (
    Segment as JaxSegment, SlidingWindow as JaxSlidingWindow,
    SlidingWindowFeature as JaxSlidingWindowFeature)
from pyannote_audio_tpu.models.segmentation.pyannet import PyanNet
from pyannote_audio_tpu_torch.core import model as torch_model
from pyannote_audio_tpu_torch.core.inference import Inference
from pyannote_audio_tpu_torch.core.io import write_wav
from pyannote_audio_tpu_torch.core.segment import (Segment, SlidingWindow,
                                                   SlidingWindowFeature)
from pyannote_audio_tpu_torch.models.segmentation.pyannet import \
    PyanNet as TorchPyanNet
from pyannote_audio_tpu_torch.utils.convert import (pyannet_state_dict,
                                                    write_reference_checkpoint)
from test_torch_port_models import perturb

SR = 16000
MODEL_TOL = 2e-4


def jax_segmenter(powerset=True, duration=2.0, seed=0, layers=1,
                  warm_up=(0.0, 0.0), permutation_invariant=False,
                  num_classes=3, head_gain=1.0):
    """A small JAX PyanNet: a powerset (mono-label) head over 3 speakers
    with at most 2 active, or a multi-label sigmoid head; ``head_gain``
    scales the classifier's kernel (random weights otherwise keep every
    sigmoid within 0.5 +- 0.02)."""
    model = PyanNet(lstm={"hidden_size": 16, "num_layers": layers},
                    linear={"hidden_size": 16})
    model.specifications = Specifications(
        problem=Problem.MONO_LABEL_CLASSIFICATION if powerset
        else Problem.MULTI_LABEL_CLASSIFICATION,
        resolution=Resolution.FRAME, duration=duration,
        classes=[f"c{k}" for k in range(num_classes)],
        powerset_max_classes=2 if powerset else None, warm_up=warm_up,
        permutation_invariant=permutation_invariant)
    model.build(jax.random.PRNGKey(seed))
    params = perturb(jax.tree_util.tree_map(np.asarray, model.params),
                     np.random.default_rng(seed))
    params["params"]["classifier"]["kernel"] = \
        params["params"]["classifier"]["kernel"] * np.float32(head_gain)
    model.params = params
    return model


def torch_segmenter_from(model):
    """The port's PyanNet with ``model``'s specifications and weights."""
    spec = model.specifications
    port = TorchPyanNet(
        torch_model.Specifications.from_checkpoint(spec.to_dict()),
        lstm_hidden=16, lstm_layers=model.hparams["lstm"]["num_layers"],
        linear_hidden=16)
    port.load_reference_state_dict(
        pyannet_state_dict(model.params, model.hparams))
    return port.eval()


def wave(seconds, seed):
    return (0.1 * np.random.default_rng(seed).standard_normal(
        (1, int(SR * seconds)))).astype(np.float32)


def same_window(ours, theirs):
    assert (ours.start, ours.duration, ours.step) == \
        pytest.approx((theirs.start, theirs.duration, theirs.step),
                      abs=1e-12)


@pytest.fixture(scope="module")
def multilabel():
    model = jax_segmenter(powerset=False, seed=3, layers=2,
                          num_classes=4)
    return model, torch_segmenter_from(model)


@pytest.fixture(scope="module")
def powerset():
    model = jax_segmenter(powerset=True, seed=4,
                          permutation_invariant=True)
    return model, torch_segmenter_from(model)


@pytest.mark.parametrize("seconds", [7.3, 1.1])
def test_aggregated_slide(multilabel, seconds):
    """Not permutation-invariant: frame-level scores on the host, hamming
    weighted, cut at the file's end (a file shorter than one chunk
    too)."""
    jax_model, port = multilabel
    wav = wave(seconds, seed=1)
    ours = Inference(port, step=0.5, batch_size=4, device="cpu")
    theirs = JaxInference(jax_model, step=0.5, batch_size=4)
    a, b = ours.slide(wav, SR), theirs.slide(wav, SR)
    assert isinstance(a.data, np.ndarray)
    assert a.data.shape == np.asarray(b.data).shape
    same_window(a.sliding_window, b.sliding_window)
    np.testing.assert_allclose(a.data, np.asarray(b.data), atol=MODEL_TOL)


def test_pre_aggregation_hook_and_chunk_level(powerset):
    """A permutation-invariant model stays chunk-level on the device; a
    hook (the VAD's max over classes) makes it order-free, so it is
    aggregated."""
    jax_model, port = powerset
    wav = wave(6.1, seed=2)
    chunks = Inference(port, step=0.5, device="cpu").slide(wav, SR)
    expected = JaxInference(jax_model, step=0.5).slide(wav, SR)
    assert isinstance(chunks.data, torch.Tensor)
    np.testing.assert_allclose(chunks.data.numpy(),
                               np.asarray(expected.data), atol=MODEL_TOL)
    ours = Inference(port, step=0.5, device="cpu",
                     pre_aggregation_hook=lambda s: s.amax(-1, keepdim=True))
    theirs = JaxInference(jax_model, step=0.5,
                          pre_aggregation_hook=lambda s: np.max(
                              s, axis=-1, keepdims=True))
    a, b = ours.slide(wav, SR), theirs.slide(wav, SR)
    assert a.data.shape == np.asarray(b.data).shape and a.data.shape[1] == 1
    same_window(a.sliding_window, b.sliding_window)
    np.testing.assert_allclose(a.data, np.asarray(b.data), atol=MODEL_TOL)


def test_skip_aggregation_and_conversion(powerset, multilabel):
    jax_model, port = powerset
    wav = wave(4.4, seed=3)
    ours = Inference(port, step=0.5, device="cpu", skip_aggregation=True,
                     skip_conversion=True).slide(wav, SR)
    theirs = JaxInference(jax_model, step=0.5, skip_aggregation=True,
                          skip_conversion=True).slide(wav, SR)
    assert ours.data.shape[-1] == 7          # powerset log-probabilities
    np.testing.assert_allclose(ours.data.numpy(), np.asarray(theirs.data),
                               atol=MODEL_TOL)
    jax_model, port = multilabel
    ours = Inference(port, step=0.5, device="cpu",
                     skip_aggregation=True).slide(wav, SR)
    theirs = JaxInference(jax_model, step=0.5,
                          skip_aggregation=True).slide(wav, SR)
    same_window(ours.sliding_window, theirs.sliding_window)
    np.testing.assert_allclose(ours.data.numpy(), np.asarray(theirs.data),
                               atol=MODEL_TOL)


def test_warm_up_step_and_weights():
    jax_model = jax_segmenter(powerset=False, seed=5, warm_up=(0.3, 0.2))
    port = torch_segmenter_from(jax_model)
    ours = Inference(port, device="cpu")
    theirs = JaxInference(jax_model)
    assert ours.step == theirs.step == 0.3
    assert ours.warm_up == tuple(theirs.warm_up)
    wav = wave(5.5, seed=4)
    a, b = ours.slide(wav, SR), theirs.slide(wav, SR)
    np.testing.assert_allclose(a.data, np.asarray(b.data), atol=MODEL_TOL)


def test_whole_window_and_crop(multilabel, tmp_path):
    jax_model, port = multilabel
    path = tmp_path / "w.wav"
    write_wav(path, wave(5.0, seed=5), SR)
    with pytest.warns(UserWarning, match="whole"):
        ours = Inference(port, window="whole", device="cpu")
    with pytest.warns(UserWarning, match="whole"):
        theirs = JaxInference(jax_model, window="whole")
    a, b = ours(str(path)), theirs(str(path))
    assert a.shape == np.asarray(b).shape
    np.testing.assert_allclose(a, np.asarray(b), atol=MODEL_TOL)
    # whole: one crop, and a list of crops stacked (zero-padded past the
    # file's end)
    segments = [(0.5, 2.5), (3.9, 5.9)]
    a = ours.crop(str(path), Segment(1.0, 3.0))
    b = theirs.crop(str(path), JaxSegment(1.0, 3.0))
    np.testing.assert_allclose(a, np.asarray(b), atol=MODEL_TOL)
    a = ours.crop(str(path), [Segment(*s) for s in segments], duration=2.0)
    b = theirs.crop(str(path), [JaxSegment(*s) for s in segments],
                    duration=2.0)
    assert a.shape[0] == 2
    np.testing.assert_allclose(a, np.asarray(b), atol=MODEL_TOL)
    # sliding: over the segments' hull, the window shifted to its start
    ours = Inference(port, step=0.5, device="cpu")
    theirs = JaxInference(jax_model, step=0.5)
    a = ours.crop(str(path), [Segment(*s) for s in segments])
    b = theirs.crop(str(path), [JaxSegment(*s) for s in segments])
    same_window(a.sliding_window, b.sliding_window)
    np.testing.assert_allclose(a.data, np.asarray(b.data), atol=MODEL_TOL)


@pytest.mark.parametrize("hamming", [False, True])
@pytest.mark.parametrize("warm_up,missing,skip_average", [
    ((0.0, 0.0), np.nan, False), ((0.2, 0.1), 0.0, False),
    ((0.0, 0.0), 0.0, True)])
def test_static_aggregate_and_trim(hamming, warm_up, missing, skip_average):
    rng = np.random.default_rng(6)
    data = rng.random((13, 59, 3)).astype(np.float32)
    data[3, 10:20, 1] = np.nan                  # missing scores
    data[4:7, :, 2] = np.nan                    # a class no chunk covers
    chunks = dict(start=0.25, duration=1.0, step=0.3)
    frames = dict(start=0.0, duration=0.03, step=0.017)
    expected = JaxInference.aggregate(
        JaxSlidingWindowFeature(data, JaxSlidingWindow(**chunks)),
        JaxSlidingWindow(**frames), warm_up=warm_up, hamming=hamming,
        missing=missing, skip_average=skip_average)
    for as_tensor in (False, True):
        x = torch.from_numpy(data) if as_tensor else data
        ours = Inference.aggregate(
            SlidingWindowFeature(x, SlidingWindow(**chunks)),
            SlidingWindow(**frames), warm_up=warm_up, hamming=hamming,
            missing=missing, skip_average=skip_average)
        out = ours.data.numpy() if as_tensor else ours.data
        assert isinstance(ours.data, torch.Tensor) == as_tensor
        same_window(ours.sliding_window, expected.sliding_window)
        np.testing.assert_array_equal(np.isnan(out),
                                      np.isnan(expected.data))
        np.testing.assert_allclose(out, expected.data, atol=1e-5)
    ours = Inference.trim(SlidingWindowFeature(data, SlidingWindow(**chunks)),
                          warm_up=(0.1, 0.2))
    theirs = JaxInference.trim(
        JaxSlidingWindowFeature(data, JaxSlidingWindow(**chunks)),
        warm_up=(0.1, 0.2))
    same_window(ours.sliding_window, theirs.sliding_window)
    np.testing.assert_array_equal(ours.data, theirs.data)


def test_forced_slices_equal_whole(multilabel, monkeypatch):
    """Aggregated output in forced slices (each slice's upload released
    after its batches) against whole-file buffers."""
    _, port = multilabel
    wav = wave(31.7, seed=7)
    inference = Inference(port, step=0.5, batch_size=8, device="cpu")
    monkeypatch.setenv("PYANNOTE_TPU_SEGMENT_MINUTES", "0")
    whole = inference.slide(wav, SR)
    monkeypatch.setenv("PYANNOTE_TPU_SEGMENT_MINUTES", "0.15")
    monkeypatch.setenv("PYANNOTE_TPU_SEGMENT_HALO_SECONDS", "1.0")
    cache = {}
    sliced = inference.slide(wav, SR, cache=cache)
    assert "_fingerprint" in cache["_longfile_uploads"]
    assert not [k for k in cache["_longfile_uploads"]
                if isinstance(k, tuple)]
    same_window(sliced.sliding_window, whole.sliding_window)
    np.testing.assert_allclose(sliced.data, whole.data, atol=1e-5)


def test_model_from_path_and_arguments(multilabel, tmp_path):
    jax_model, port = multilabel
    path = write_reference_checkpoint(
        pyannet_state_dict(jax_model.params, jax_model.hparams), "PyanNet",
        dict(jax_model.hparams, sample_rate=SR, num_channels=1),
        jax_model.specifications.to_dict(), tmp_path / "seg")
    loaded = Inference(str(path), step=0.5, device="cpu")
    assert loaded.model.specifications.problem.name == \
        "MULTI_LABEL_CLASSIFICATION"
    assert loaded.model.lstm.num_layers == 2
    wav = wave(3.0, seed=8)
    np.testing.assert_array_equal(
        loaded.slide(wav, SR).data,
        Inference(port, step=0.5, device="cpu").slide(wav, SR).data)
    with pytest.raises(ValueError, match="window"):
        Inference(port, window="other", device="cpu")
    with pytest.raises(ValueError, match="step"):
        Inference(port, step=3.0, device="cpu")
    with pytest.warns(UserWarning, match="training duration"):
        Inference(port, duration=1.5, device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        Inference(port, device="cpu")
