"""The port's training ops against the JAX package's, on the CPU.

The same seeded numpy inputs go through both. Tolerances:

- losses, ``interpolate_weight``: 1e-6 absolute (float32 means and sums
  in another order over at most a few thousand terms); the best
  permutation of the PIT loss equal;
- ``to_powerset`` (overflowing frames included), the permutation tables
  and the cardinalities: equal;
- DER components: equal (sums of 0/1 counts are exact in float32), the
  rates within 1e-6; the AUROC within 1e-12 (the same numpy code);
- the LSTM through ``LSTMRecurrence`` against ``jax.vjp`` of the JAX
  package's float32 ``multilayer_lstm`` (2 bidirectional layers, H = 8):
  1e-5 absolute on outputs and gradients (float32 recurrences of 13
  steps summed in another order); ``torch.autograd.gradcheck`` in float64
  at its default tolerances.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pyannote_audio_tpu.metrics import streaming as jax_streaming
from pyannote_audio_tpu.metrics.auroc import BinnedAUROC as JaxAUROC
from pyannote_audio_tpu.ops import losses as jax_losses
from pyannote_audio_tpu.ops.lstm import multilayer_lstm as jax_multilayer
from pyannote_audio_tpu.ops.powerset import Powerset as JaxPowerset
from pyannote_audio_tpu_torch.metrics import streaming
from pyannote_audio_tpu_torch.metrics.auroc import BinnedAUROC
from pyannote_audio_tpu_torch.models.blocks.rnn import LSTM
from pyannote_audio_tpu_torch.ops import losses, lstm_kernel
from pyannote_audio_tpu_torch.ops.lstm import \
    lstm_bidirectional_recurrence_plain
from pyannote_audio_tpu_torch.ops.powerset import Powerset

ATOL = 1e-6
LSTM_ATOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Torch on one thread for this module: the recurrences are many small
    ops, which slow down many times over when the test workers' thread
    pools share the cores; restored afterwards."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _probs(rng, shape):
    return rng.uniform(0.02, 0.98, shape).astype(np.float32)


def _log_probs(rng, shape):
    logits = rng.standard_normal(shape)
    return (logits - np.log(np.exp(logits).sum(-1, keepdims=True))
            ).astype(np.float32)


def _weight(rng, batch, frames):
    return rng.uniform(0.0, 1.0, (batch, frames, 1)).astype(np.float32)


@pytest.mark.parametrize("src,dst", [(7, 7), (5, 13), (13, 5), (1, 4)])
def test_interpolate_weight_matches_jax(src, dst):
    w = _weight(np.random.default_rng(src * dst), 3, src)
    ours = losses.interpolate_weight(torch.from_numpy(w), dst).numpy()
    theirs = np.asarray(jax_losses.interpolate_weight(jnp.asarray(w), dst))
    np.testing.assert_allclose(ours, theirs, atol=ATOL)
    assert losses.interpolate(torch.zeros(3, dst), None) is None


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("name", ["binary_cross_entropy", "mse_loss"])
def test_frame_losses_match_jax(name, weighted):
    rng = np.random.default_rng(3)
    pred = _probs(rng, (4, 20, 3))
    target = (rng.uniform(size=(4, 20, 3)) > 0.5).astype(np.float32)
    w = _weight(rng, 4, 11) if weighted else None
    ours = getattr(losses, name)(
        torch.from_numpy(pred), torch.from_numpy(target),
        weight=None if w is None else torch.from_numpy(w))
    theirs = getattr(jax_losses, name)(
        jnp.asarray(pred), jnp.asarray(target),
        weight=None if w is None else jnp.asarray(w))
    assert abs(float(ours) - float(theirs)) < ATOL


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("class_weighted", [False, True])
def test_nll_loss_matches_jax(weighted, class_weighted):
    rng = np.random.default_rng(4)
    logp = _log_probs(rng, (3, 17, 7))
    target = rng.integers(0, 7, (3, 17))
    cw = rng.uniform(0.5, 2.0, 7).astype(np.float32) \
        if class_weighted else None
    w = _weight(rng, 3, 9) if weighted else None
    ours = losses.nll_loss(
        torch.from_numpy(logp), torch.from_numpy(target),
        class_weight=None if cw is None else torch.from_numpy(cw),
        weight=None if w is None else torch.from_numpy(w))
    theirs = jax_losses.nll_loss(
        jnp.asarray(logp), jnp.asarray(target),
        class_weight=None if cw is None else jnp.asarray(cw),
        weight=None if w is None else jnp.asarray(w))
    assert abs(float(ours) - float(theirs)) < ATOL


@pytest.mark.parametrize("K,max_set", [(3, 2), (4, 2), (2, 1)])
@pytest.mark.parametrize("weighted,class_weighted",
                         [(False, False), (True, False), (True, True)])
def test_powerset_pit_loss_matches_jax(K, max_set, weighted,
                                       class_weighted):
    rng = np.random.default_rng(K * 10 + max_set)
    ours_ps, jax_ps = Powerset(K, max_set), JaxPowerset(K, max_set)
    logp = _log_probs(rng, (5, 23, ours_ps.num_powerset_classes))
    # over-crowded frames included: they map to their best-overlap subset
    target = (rng.uniform(size=(5, 23, K)) > 0.55).astype(np.float32)
    w = _weight(rng, 5, 12) if weighted else None
    cw = np.maximum(np.asarray(jax_ps.cardinality), 1) \
        if class_weighted else None
    ours, best = losses.powerset_pit_loss(
        torch.from_numpy(logp), torch.from_numpy(target), ours_ps,
        weight=None if w is None else torch.from_numpy(w),
        class_weight=None if cw is None else torch.from_numpy(cw))
    theirs, their_best = jax_losses.powerset_pit_loss(
        jnp.asarray(logp), jnp.asarray(target), jax_ps,
        weight=None if w is None else jnp.asarray(w),
        class_weight=None if cw is None else jnp.asarray(cw))
    assert abs(float(ours) - float(theirs)) < ATOL
    np.testing.assert_array_equal(best.numpy(), np.asarray(their_best))


def test_powerset_codec_matches_jax():
    ours, theirs = Powerset(3, 2), JaxPowerset(3, 2)
    ml = np.asarray([[1, 1, 1], [0, 1, 1], [0, 0, 0], [1, 0, 0],
                     [0, 1, 0]], np.float32)
    np.testing.assert_array_equal(
        ours.to_powerset(torch.from_numpy(ml)).numpy(),
        np.asarray(theirs.to_powerset(jnp.asarray(ml))))
    # (1, 1, 1) overflows max_set_size 2: the best-overlap subset {0, 1}
    assert ours.powerset_classes[int(ours.to_powerset(
        torch.ones(1, 3)).argmax())] == {0, 1}
    np.testing.assert_array_equal(ours.cardinality.numpy(),
                                  np.asarray(theirs.cardinality))
    assert ours.powerset_classes == theirs.powerset_classes
    for perm in [(1, 0, 2), (1, 2, 0)]:
        np.testing.assert_array_equal(
            ours.permutation_mapping(perm).numpy(),
            np.asarray(theirs.permutation_mapping(perm)))
    np.testing.assert_array_equal(ours.permutation_mapping((1, 0, 2)),
                                  [0, 2, 1, 3, 4, 6, 5])
    np.testing.assert_array_equal(ours.all_permutation_mappings().numpy(),
                                  np.asarray(
                                      theirs.all_permutation_mappings()))


def _der_inputs(seed, K_pred=3, K_ref=3, frames=40):
    rng = np.random.default_rng(seed)
    preds = rng.uniform(size=(4, frames, K_pred)).astype(np.float32)
    target = (rng.uniform(size=(4, frames, K_ref)) > 0.6).astype(
        np.float32)
    return preds, target


@pytest.mark.parametrize("K_pred,K_ref", [(3, 3), (2, 4), (4, 2), (7, 7)])
def test_der_components_match_jax(K_pred, K_ref):
    preds, target = _der_inputs(K_pred * 7 + K_ref, K_pred, K_ref)
    thresholds = np.linspace(0.0, 1.0, 51).astype(np.float32)
    ours = streaming.der_components(torch.from_numpy(preds),
                                    torch.from_numpy(target), thresholds)
    theirs = jax_streaming.der_components(preds, target, thresholds)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(theirs))
    fa, miss, conf, total = streaming.der_update(preds, target, 0.5)
    assert abs(float(streaming.der_compute(fa, miss, conf, total))
               - jax_streaming.diarization_error_rate(preds, target)) \
        < ATOL
    assert streaming.optimal_diarization_error_rate(preds, target) == \
        pytest.approx(jax_streaming.optimal_diarization_error_rate(
            preds, target), abs=ATOL)


METRICS = ["DiarizationErrorRate", "FalseAlarmRate", "MissedDetectionRate",
           "SpeakerConfusionRate", "DetectionErrorRate",
           "DiarizationPrecision", "DiarizationRecall",
           "OptimalDiarizationErrorRate",
           "OptimalDiarizationErrorRateThreshold", "OptimalFalseAlarmRate",
           "OptimalMissedDetectionRate", "OptimalSpeakerConfusionRate"]


@pytest.mark.parametrize("name", METRICS)
def test_streaming_metric_family_matches_jax(name):
    ours, theirs = getattr(streaming, name)(), getattr(jax_streaming,
                                                       name)()
    for seed in (1, 2):
        preds, target = _der_inputs(seed)
        assert ours(torch.from_numpy(preds), torch.from_numpy(target)) \
            == pytest.approx(theirs(preds, target), abs=ATOL)
    assert ours.compute() == pytest.approx(theirs.compute(), abs=ATOL)


def test_segmentation_error_rate_matches_jax():
    preds, target = _der_inputs(5, frames=100)
    ours = streaming.SegmentationErrorRate(window_size=30, step_size=20)
    theirs = jax_streaming.SegmentationErrorRate(window_size=30,
                                                 step_size=20)
    assert ours(preds, target) == pytest.approx(theirs(preds, target),
                                                abs=ATOL)
    assert ours.compute() == pytest.approx(theirs.compute(), abs=ATOL)


def test_binned_auroc_matches_jax():
    rng = np.random.default_rng(6)
    ours, theirs = BinnedAUROC(), JaxAUROC()
    for _ in range(2):
        scores = rng.uniform(size=(3, 50, 2))
        targets = (rng.uniform(size=(3, 50, 2)) + 0.3 * scores) > 0.8
        assert ours(scores, targets) == pytest.approx(
            theirs(scores, targets), abs=1e-12)


# -- the LSTM under autograd ------------------------------------------------

def _jax_layers(module):
    layers = []
    for i in range(module.num_layers):
        layer = {}
        for ours, theirs in (("w_ih", "weight_ih"), ("w_hh", "weight_hh"),
                             ("b_ih", "bias_ih"), ("b_hh", "bias_hh")):
            for sfx, jsfx in (("", ""), ("_reverse", "_r")):
                layer[ours + jsfx] = jnp.asarray(getattr(
                    module, f"{theirs}_l{i}{sfx}").detach().numpy())
        layers.append(layer)
    return layers


def test_lstm_gradient_matches_jax_scan_vjp():
    """A 2-layer BiLSTM's forward and vector-Jacobian product through
    LSTMRecurrence against jax.vjp of the JAX package's float32 scan."""
    rng = np.random.default_rng(12)
    x = rng.standard_normal((3, 13, 5)).astype(np.float32)
    g = rng.standard_normal((3, 13, 16)).astype(np.float32)
    module = LSTM(5, hidden_size=8, num_layers=2,
                  generator=torch.Generator().manual_seed(1))
    names = [n for n, _ in module.named_parameters()]
    xt = torch.from_numpy(x).requires_grad_()
    calls = []
    original = lstm_kernel.LSTMRecurrence.backward

    def counted(ctx, grad):
        calls.append(1)
        return original(ctx, grad)

    lstm_kernel.LSTMRecurrence.backward = staticmethod(counted)
    try:
        out = module(xt)
        out.backward(torch.from_numpy(g))
    finally:
        lstm_kernel.LSTMRecurrence.backward = staticmethod(original)
    assert len(calls) == 2                  # one per layer, the Function's

    layers = _jax_layers(module)
    expected, vjp = jax.vjp(lambda x_, l_: jax_multilayer(x_, l_),
                            jnp.asarray(x), layers)
    gx, glayers = vjp(jnp.asarray(g))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(expected),
                               atol=LSTM_ATOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx),
                               atol=LSTM_ATOL)
    for name in names:
        ours_name, layer = name.split("_l")
        i, rev = int(layer[0]), layer.endswith("_reverse")
        key = {"weight_ih": "w_ih", "weight_hh": "w_hh", "bias_ih": "b_ih",
               "bias_hh": "b_hh"}[ours_name] + ("_r" if rev else "")
        np.testing.assert_allclose(
            getattr(module, name).grad.numpy(),
            np.asarray(glayers[i][key]), atol=LSTM_ATOL, err_msg=name)


def test_lstm_recurrence_gradcheck_float64():
    rng = np.random.default_rng(13)
    for D in (1, 2):
        xw = torch.from_numpy(rng.standard_normal((4, 2, D * 4 * 3))) \
            .requires_grad_()
        w_hh = torch.from_numpy(rng.uniform(-0.6, 0.6, (D, 12, 3))) \
            .requires_grad_()
        assert torch.autograd.gradcheck(
            lambda a, b: lstm_kernel.LSTMRecurrence.apply(a, b, "highest"),
            (xw, w_hh))


def test_lstm_serving_path_skips_the_function():
    """Under no_grad / inference_mode LSTMRecurrence records no graph
    (serving skips the Function's backward); with grad the output comes
    from LSTMRecurrence, with the same forward values."""
    module = LSTM(5, hidden_size=8, num_layers=2,
                  generator=torch.Generator().manual_seed(2))
    x = torch.randn(2, 9, 5, generator=torch.Generator().manual_seed(3))
    with torch.inference_mode():
        served = module(x)
    with torch.no_grad():
        assert module(x).grad_fn is None
    trained = module(x)
    assert type(trained.grad_fn.next_functions[0][0]).__name__ == \
        "LSTMRecurrenceBackward"
    assert torch.equal(trained.detach(), served)
    xw = torch.randn(9, 2, 64)
    w_hh = torch.randn(2, 32, 8)
    assert torch.equal(
        lstm_kernel.LSTMRecurrence.apply(xw, w_hh, "highest"),
        lstm_bidirectional_recurrence_plain(xw, w_hh, "highest"))


def test_packed_weights_follow_an_optimizer_step():
    """The kernel's packed W_hh is cached on the weights' versions: an
    optimizer's in-place step makes the next forward pack afresh."""
    module = LSTM(5, hidden_size=8, num_layers=1,
                  generator=torch.Generator().manual_seed(4))
    names = ["l0", "l0_reverse"]

    def packed():
        w_hh = torch.stack([module.weight_hh_l0, module.weight_hh_l0_reverse])
        return module._prepared_weights(0, names, w_hh, "default").packed

    first = packed()
    assert packed() is first                   # unchanged weights: cached
    optimizer = torch.optim.Adam(module.parameters(), lr=0.1)
    module(torch.randn(2, 4, 5)).sum().backward()
    optimizer.step()
    second = packed()
    assert second is not first and not torch.equal(second, first)
    w_hh = torch.stack([module.weight_hh_l0, module.weight_hh_l0_reverse])
    assert torch.equal(second, lstm_kernel.prepare_recurrent_weights(
        w_hh.detach(), "default").packed)


def test_mix_speaker_diarization_matches_jax():
    from pyannote_audio_tpu.augmentation.mix import \
        MixSpeakerDiarization as JaxMix
    from pyannote_audio_tpu_torch.augmentation import MixSpeakerDiarization
    rng = np.random.default_rng(8)
    X = rng.standard_normal((6, 1, 400)).astype(np.float32)
    y = np.zeros((6, 20, 4), np.float32)
    for i in range(6):
        y[i, :, :1 + i % 3] = rng.uniform(size=(20, 1 + i % 3)) > 0.4
    ours = MixSpeakerDiarization(p=0.8, max_num_speakers=4, seed=3)(X, y)
    theirs = JaxMix(p=0.8, max_num_speakers=4, seed=3)(X, y)
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a, b)
