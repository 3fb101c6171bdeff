"""The JAX package's last public names in the port, each held against the
JAX package on the CPU with seeded numpy inputs.

Tolerances: exact for integers, counts, permutations, segments and
labels; 1e-12 for the float64 metrics (the same sums in the same order,
so they agree to the last bit in practice); 1e-5 (relative and absolute)
for statistics pooling (float32 through torch) and the permutation costs
(float32 means summed in another order). The FLOP counts are also
held exactly against ``torch.utils.flop_counter.FlopCounterMode`` over
the port's own SincNet, PyanNet LSTM and ResNet34 modules at a small
width, as tests/test_flops.py holds the JAX counts to XLA's cost
analysis.
"""

import itertools
import warnings

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

import jax.numpy as jnp

from pyannote_audio_tpu.core import annotation as jax_annotation
from pyannote_audio_tpu.core import model as jax_model
from pyannote_audio_tpu.core import segment as jax_segment
from pyannote_audio_tpu.core import task as jax_task
from pyannote_audio_tpu.models.blocks import pooling as jax_pooling
from pyannote_audio_tpu.ops import permutation as jax_permutation
from pyannote_audio_tpu.utils import flops as jax_flops
from pyannote_audio_tpu.utils import metric as jax_metric
from pyannote_audio_tpu.utils import params as jax_params
from pyannote_audio_tpu_torch.core import segment
from pyannote_audio_tpu_torch.core.annotation import one_hot_decode
from pyannote_audio_tpu_torch.core.model import UnknownSpecificationsError
from pyannote_audio_tpu_torch.core.task import get_dtype
from pyannote_audio_tpu_torch.models.blocks.pooling import StatsPool
from pyannote_audio_tpu_torch.utils import flops, metric, reproducibility
from pyannote_audio_tpu_torch.utils import permutation
from pyannote_audio_tpu_torch.utils.params import merge_dict
from test_torch_port_models import one_torch_thread  # noqa: F401

METRIC_ATOL = 1e-12
POOL_TOL = 1e-5


def _frames(rng, frames, speakers, density=0.4):
    return (rng.uniform(size=(frames, speakers)) < density).astype(
        np.float32)


# -- frame-level DER and F-measure ---------------------------------------

@pytest.mark.parametrize("ref_k,hyp_k,ref_n,hyp_n",
                         [(3, 3, 200, 200), (2, 4, 150, 170),
                          (4, 2, 180, 160), (1, 3, 90, 90), (3, 1, 60, 75)])
def test_discrete_der_matches_jax(ref_k, hyp_k, ref_n, hyp_n):
    """Differing speaker counts (padding) and lengths (the cut to the
    shorter), with and without the best permutation."""
    rng = np.random.default_rng(ref_k * 10 + hyp_k)
    reference = _frames(rng, ref_n, ref_k)
    hypothesis = _frames(rng, hyp_n, hyp_k)
    for best in (True, False):
        ours = metric.discrete_diarization_error_rate(
            reference, hypothesis, best_permutation=best)
        theirs = jax_metric.discrete_diarization_error_rate(
            reference, hypothesis, best_permutation=best)
        assert ours.keys() == theirs.keys()
        for key in ours:
            assert ours[key] == pytest.approx(theirs[key], abs=METRIC_ATOL)


def test_discrete_der_accumulates_over_files_as_jax():
    """Several files whose reference and hypothesis differ in speaker
    count and in length: each call's rate and the aggregate."""
    rng = np.random.default_rng(7)
    ours, theirs = (metric.DiscreteDiarizationErrorRate(),
                    jax_metric.DiscreteDiarizationErrorRate())
    for ref_k, hyp_k, ref_n, hyp_n in [(3, 2, 300, 290), (2, 3, 120, 140),
                                       (4, 4, 250, 250), (1, 2, 80, 60)]:
        reference = _frames(rng, ref_n, ref_k)
        hypothesis = _frames(rng, hyp_n, hyp_k)
        assert ours(reference, hypothesis) == pytest.approx(
            theirs(reference, hypothesis), abs=METRIC_ATOL)
    assert ours.compute() == pytest.approx(theirs.compute(),
                                           abs=METRIC_ATOL)
    assert abs(ours) == pytest.approx(abs(theirs), abs=METRIC_ATOL)
    ours.reset()
    assert ours.compute() == 0.0


@pytest.mark.parametrize("frames,window", [(500, 10.0), (499, 10.0),
                                           (40, 10.0), (333, 3.0)])
def test_sliding_der_matches_jax(frames, window):
    """Half-overlapping windows and the end-aligned tail window."""
    rng = np.random.default_rng(frames)
    step = 0.1
    reference, hypothesis = _frames(rng, frames, 3), _frames(rng, frames, 2)
    ours = metric.SlidingDiarizationErrorRate(window=window)(
        segment.SlidingWindowFeature(reference, segment.SlidingWindow(
            duration=step, step=step)),
        segment.SlidingWindowFeature(hypothesis, segment.SlidingWindow(
            duration=step, step=step)))
    sliding = jax_metric.SlidingDiarizationErrorRate(window=window)
    theirs = sliding(
        jax_segment.SlidingWindowFeature(reference, jax_segment.SlidingWindow(
            duration=step, step=step)),
        jax_segment.SlidingWindowFeature(hypothesis,
                                         jax_segment.SlidingWindow(
                                             duration=step, step=step)))
    assert ours == pytest.approx(theirs, abs=METRIC_ATOL)


def test_sliding_der_keeps_each_window_as_jax():
    rng = np.random.default_rng(3)
    reference, hypothesis = _frames(rng, 260, 2), _frames(rng, 260, 3)
    ours = metric.SlidingDiarizationErrorRate(window=5.0)
    theirs = jax_metric.SlidingDiarizationErrorRate(window=5.0)
    window = dict(duration=0.1, step=0.1)
    ours(segment.SlidingWindowFeature(
        reference, segment.SlidingWindow(**window)),
        segment.SlidingWindowFeature(hypothesis,
                                     segment.SlidingWindow(**window)))
    theirs(jax_segment.SlidingWindowFeature(
        reference, jax_segment.SlidingWindow(**window)),
        jax_segment.SlidingWindowFeature(
            hypothesis, jax_segment.SlidingWindow(**window)))
    # 5 s windows every 2.5 s over 26 s: 9 on the grid and the end-aligned
    # tail
    assert ours.windowed_.shape == theirs.windowed_.shape == (10,)
    np.testing.assert_allclose(ours.windowed_, theirs.windowed_,
                               atol=METRIC_ATOL)


def test_discrete_macro_fmeasure_matches_jax():
    """Counts over several calls, a class absent from both sides (scored
    1), and the class-count refusal."""
    rng = np.random.default_rng(11)
    classes = ["a", "b", "c", "d"]
    ours = metric.DiscreteMacroAverageFMeasure(classes)
    theirs = jax_metric.DiscreteMacroAverageFMeasure(classes)
    for n_ref, n_hyp in [(100, 100), (80, 95), (60, 40)]:
        reference, hypothesis = _frames(rng, n_ref, 4), _frames(rng, n_hyp, 4)
        reference[:, 3] = hypothesis[:, 3] = 0.0   # class "d" never occurs
        assert ours(reference, hypothesis) == pytest.approx(
            theirs(reference, hypothesis), abs=METRIC_ATOL)
    assert ours.compute() == pytest.approx(theirs.compute(),
                                           abs=METRIC_ATOL)
    for m in (ours, theirs):
        with pytest.raises(ValueError, match="class-count"):
            m(np.zeros((10, 4)), np.zeros((10, 3)))
    ours.reset()
    assert ours.compute() == 1.0


# -- permutations ------------------------------------------------------------

def _segmentations(rng, chunks, frames, speakers, package):
    data = rng.uniform(size=(chunks, frames, speakers)).astype(np.float32)
    window = package.SlidingWindow(duration=5.0, step=1.0, start=0.0)
    return data, package.SlidingWindowFeature(data, window)


@pytest.mark.parametrize("cost", ["mae", "mse", "callable"])
@pytest.mark.parametrize("speakers", [2, 3])
def test_build_permutation_graph_matches_jax(cost, speakers):
    rng = np.random.default_rng(speakers)
    data, ours_in = _segmentations(rng, 9, 50, speakers, segment)
    theirs_in = jax_segment.SlidingWindowFeature(
        data, jax_segment.SlidingWindow(duration=5.0, step=1.0, start=0.0))

    def onset_cost(Y, y, onset=0.5):
        return np.mean(np.abs((np.asarray(Y) > onset).astype(float)
                              - (np.asarray(y) > onset)), axis=0)

    fn = onset_cost if cost == "callable" else cost
    ours = permutation.build_permutation_graph(ours_in, onset=0.6, cost=fn)
    theirs = jax_permutation.build_permutation_graph(theirs_in, onset=0.6,
                                                     cost=fn)
    # chunks overlap their next 4 (duration / step - 1)
    assert len(ours) == sum(min(4, 8 - i) for i in range(9))
    assert ours == theirs


def test_build_permutation_graph_takes_a_sliding_window_feature():
    with pytest.raises(TypeError):
        permutation.build_permutation_graph(np.zeros((3, 10, 2)))


def test_permutate_aliases_match_jax():
    rng = np.random.default_rng(5)
    y1 = rng.uniform(size=(4, 30, 3)).astype(np.float32)
    y2 = rng.uniform(size=(4, 30, 3)).astype(np.float32)
    for cost in ("mse", "mae"):
        ours = permutation.permutate_numpy(y1, y2, cost_func=cost,
                                           return_cost=True)
        theirs = jax_permutation.permutate_numpy(y1, y2, cost_func=cost,
                                                 return_cost=True)
        np.testing.assert_array_equal(ours[0], theirs[0])
        assert ours[1] == theirs[1]
        # float32 frame means, summed in another order
        np.testing.assert_allclose(ours[2], np.asarray(theirs[2]),
                                   rtol=POOL_TOL, atol=POOL_TOL)
        t1, t2 = torch.from_numpy(y1), torch.from_numpy(y2)
        permutated, perms = permutation.permutate_torch(t1, t2,
                                                        cost_func=cost)
        theirs = jax_permutation.permutate_torch(t1, t2, cost_func=cost)
        assert torch.equal(permutated, theirs[0]) and perms == theirs[1]
        permutated, perms, C = permutation.permutate_torch(
            t1, t2, cost_func=cost, return_cost=True)
        assert isinstance(C, torch.Tensor) and C.shape == (4, 3, 3)


# -- one_hot_decode ----------------------------------------------------------

def _tracks(annotation):
    return sorted((round(s.start, 9), round(s.end, 9), str(t), str(label))
                  for s, t, label in annotation.itertracks(yield_label=True))


@pytest.mark.parametrize("labels", [None, ["alice", "bob", "carol"]])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_one_hot_decode_matches_jax(labels, seed):
    """Random runs, with runs that touch the first and the last frame."""
    rng = np.random.default_rng(seed)
    data = _frames(rng, 120, 3, density=0.5)
    data[0, 0] = data[-1, 1] = 1.0
    data[:5, 2] = 1.0
    window = dict(start=0.25, duration=0.05, step=0.02)
    ours = one_hot_decode(data, segment.SlidingWindow(**window),
                          labels=labels, uri="u")
    theirs = jax_annotation.one_hot_decode(
        data, jax_segment.SlidingWindow(**window), labels=labels, uri="u")
    assert ours.uri == theirs.uri == "u"
    assert _tracks(ours) and _tracks(ours) == _tracks(theirs)
    assert sorted(map(str, ours.labels())) == \
        sorted(map(str, theirs.labels()))


# -- StatsPool ---------------------------------------------------------------

@pytest.mark.parametrize("weights", ["none", "frames", "speakers"])
def test_stats_pool_module_matches_jax(weights):
    rng = np.random.default_rng(2)
    sequences = rng.standard_normal((3, 40, 117)).astype(np.float32)
    w = {"none": None,
         "frames": rng.uniform(size=(3, 58)).astype(np.float32),
         "speakers": rng.uniform(size=(3, 2, 117)).astype(np.float32)
         }[weights]
    pool = StatsPool()
    assert isinstance(pool, torch.nn.Module)
    ours = pool(torch.from_numpy(sequences),
                None if w is None else torch.from_numpy(w)).numpy()
    theirs = np.asarray(jax_pooling.StatsPool()(
        jnp.asarray(sequences), None if w is None else jnp.asarray(w)))
    assert ours.shape == theirs.shape
    np.testing.assert_allclose(ours, theirs, rtol=POOL_TOL, atol=POOL_TOL)


# -- FLOP counts -------------------------------------------------------------

FLOP_CASES = [
    ("conv1d_flops", (581, 5, 80, 60)),
    ("conv2d_flops", (40, 17, 3, 3, 32, 64)),
    ("lstm_flops", (589, [60, 256], 128)),
    ("lstm_flops", (293, [60, 256, 256, 256], 128, False)),
    ("conv1d_out", (160000, 251, 10)),
    ("sincnet_whole_conv_flops", (480000,)),
    ("sincnet_whole_conv_flops", (160000, 5)),
    ("fbank_conv_flops", (998,)),
    ("fbank_conv_flops", (3001, 400, 512, 64)),
    ("resnet_trunk_flops_per_frame", ()),
    ("resnet_trunk_flops_per_frame", (32, (3, 4, 6, 3), 80, True)),
    ("resnet_trunk_flops_per_frame", (64, (2, 2, 2, 2), 40)),
    ("total_flops", ({"sinc_whole_conv": 3, "segmentation": 5, "fbank": 7,
                      "trunk": 11, "pool_and_embed": 13, "chunks": 17},)),
]


@pytest.mark.parametrize("name,args", FLOP_CASES)
def test_flop_counts_match_jax(name, args):
    assert getattr(flops, name)(*args) == getattr(jax_flops, name)(*args)


@pytest.mark.parametrize("kwargs", [
    {}, {"window_samples": 80000, "lstm_hidden": 512},
    {"lstm_layers": 4, "linear_layers": 1, "dimension": 4}])
def test_pyannet_counts_match_jax(kwargs):
    assert flops.pyannet_post_sinc_flops(**kwargs) == \
        jax_flops.pyannet_post_sinc_flops(**kwargs)


@pytest.mark.parametrize("seconds", [5.0, 10.0, 181.0, 600.0, 3599.5])
@pytest.mark.parametrize("half_tail", ["1", "0"])
def test_diarization_device_flops_match_jax(seconds, half_tail,
                                            monkeypatch):
    """Every stage at the flagship settings, the half-batch tail gate on
    and off, and a few other settings."""
    monkeypatch.setenv("PYANNOTE_TPU_TAIL_HALF_BATCH", half_tail)
    for kwargs in ({}, {"batch": 32, "local_speakers": 2},
                   {"window": 5.0, "step": 0.5, "trunk_pbatch": 4}):
        ours = flops.diarization_device_flops(seconds, **kwargs)
        theirs = jax_flops.diarization_device_flops(seconds, **kwargs)
        assert ours == theirs
        assert flops.total_flops(ours) == jax_flops.total_flops(theirs)


def test_no_peak_rate_is_stated():
    assert not [name for name in dir(flops) if "PEAK" in name.upper()]


def _counted(fn, *args) -> int:
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        fn(*args)
    return counter.get_total_flops()


def test_sincnet_and_pyannet_counts_match_flop_counter():
    """The port's PyanNet at a small width on 2 s of audio: SincNet (the
    sinc conv and two 60-filter convs, ``conv1d_flops``), the BiLSTM
    (``lstm_flops``: the hoisted projection and the recurrent products)
    and the whole model, as counted by FlopCounterMode."""
    from pyannote_audio_tpu_torch.models.segmentation.pyannet import PyanNet
    samples, H, L = 32000, 16, 8
    model = PyanNet(lstm_hidden=H, linear_hidden=L,
                    generator=torch.Generator().manual_seed(0))
    x = torch.randn(2, 1, samples)
    counts = flops.pyannet_post_sinc_flops(samples, lstm_hidden=H,
                                           linear_hidden=L)
    sinc = flops.sincnet_whole_conv_flops(samples)
    assert _counted(model.sincnet, x) == 2 * (sinc + counts["convs"])
    features = torch.randn(2, counts["frames"], 60)
    assert _counted(model.lstm, features) == 2 * flops.lstm_flops(
        counts["frames"], [60, 2 * H], H)
    assert _counted(model, x) == 2 * (sinc + counts["convs"]
                                      + counts["lstm"] + counts["head"])


def test_resnet34_counts_match_flop_counter():
    """The port's WeSpeaker ResNet34 trunk at m_channels 8 and one block
    a stage (``resnet_trunk_flops_per_frame``; its stem, ``conv2d_flops``)
    on 64 fbank frames, float32."""
    from pyannote_audio_tpu_torch.models.embedding.wespeaker import \
        WeSpeakerResNet34
    model = WeSpeakerResNet34(num_blocks=(1, 1, 1, 1), m_channels=8,
                              compute_dtype=torch.float32,
                              generator=torch.Generator().manual_seed(0))
    T = 64
    x = torch.randn(1, 1, 80, T)
    assert _counted(model.resnet.conv1, x) == flops.conv2d_flops(
        80, T, 3, 3, 1, 8)
    assert _counted(model.resnet.trunk, x) == T * \
        flops.resnet_trunk_flops_per_frame(m_channels=8,
                                           num_blocks=(1, 1, 1, 1))
    bottleneck = jax_flops.resnet_trunk_flops_per_frame(
        m_channels=8, num_blocks=(1, 1, 1, 1), bottleneck=True)
    assert flops.resnet_trunk_flops_per_frame(
        m_channels=8, num_blocks=(1, 1, 1, 1), bottleneck=True) == bottleneck


# -- reproducibility guards -----------------------------------------------------

@pytest.fixture
def tf32_flags():
    """torch's TF32 flags and the one-warning latch, restored after."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision(),
             reproducibility._WARNED[0])
    yield
    torch.backends.cuda.matmul.allow_tf32 = saved[0]
    torch.backends.cudnn.allow_tf32 = saved[1]
    torch.set_float32_matmul_precision(saved[2])
    reproducibility._WARNED[0] = saved[3]


def test_guards_never_act_on_the_cpu(tf32_flags):
    reproducibility.lower_precision_for_speed()
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        for device in ("cpu", torch.device("cpu"), None):
            reproducibility.raise_reproducibility(device)
            reproducibility.warn_reproducibility(device)


def test_guards_act_on_a_cuda_device_while_tf32_is_allowed(tf32_flags):
    reproducibility.lower_precision_for_speed()
    assert torch.backends.cuda.matmul.allow_tf32
    assert torch.backends.cudnn.allow_tf32
    with pytest.raises(reproducibility.ReproducibilityError):
        reproducibility.raise_reproducibility("cuda")
    with pytest.warns(reproducibility.ReproducibilityWarning):
        reproducibility.warn_reproducibility(torch.device("cuda", 0))
    # cuDNN's TF32 alone (torch's default) is enough
    torch.set_float32_matmul_precision("highest")
    with pytest.raises(reproducibility.ReproducibilityError):
        reproducibility.raise_reproducibility("cuda")
    torch.backends.cudnn.allow_tf32 = False
    reproducibility.raise_reproducibility("cuda")


def test_fix_reproducibility_follows_the_gate_and_warns_once(
        tf32_flags, monkeypatch):
    """As the JAX package's: a no-op unless PYANNOTE_TPU_STRICT_REPRO=1 or
    a precision is given; one warning, the first time a flag changes."""
    reproducibility.lower_precision_for_speed()
    reproducibility._WARNED[0] = False
    monkeypatch.delenv("PYANNOTE_TPU_STRICT_REPRO", raising=False)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        reproducibility.fix_reproducibility()
    assert torch.backends.cudnn.allow_tf32
    monkeypatch.setenv("PYANNOTE_TPU_STRICT_REPRO", "1")
    with pytest.warns(reproducibility.ReproducibilityWarning):
        reproducibility.fix_reproducibility()
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32
    assert torch.get_float32_matmul_precision() == "highest"
    reproducibility.raise_reproducibility("cuda")
    reproducibility.lower_precision_for_speed()
    with warnings.catch_warnings():
        warnings.simplefilter("error")   # warned once already
        reproducibility.fix_reproducibility("highest")
    assert not torch.backends.cudnn.allow_tf32


def test_jax_guards_follow_the_same_gate(monkeypatch):
    """The JAX package's ``fix_reproducibility`` under the same gate: a
    no-op without it, one warning with it (its global precision and latch
    restored after)."""
    import jax
    from pyannote_audio_tpu.utils import reproducibility as jax_repro
    saved = (jax.config.jax_default_matmul_precision, jax_repro._WARNED[0])
    try:
        jax_repro._WARNED[0] = False
        monkeypatch.delenv("PYANNOTE_TPU_STRICT_REPRO", raising=False)
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            jax_repro.fix_reproducibility()
        monkeypatch.setenv("PYANNOTE_TPU_STRICT_REPRO", "1")
        jax.config.update("jax_default_matmul_precision", None)
        with pytest.warns(jax_repro.ReproducibilityWarning):
            jax_repro.fix_reproducibility()
        jax.config.update("jax_default_matmul_precision", None)
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            jax_repro.fix_reproducibility()
        # the CPU never raises, in either package
        jax_repro.raise_reproducibility("cpu")
        reproducibility.raise_reproducibility("cpu")
    finally:
        jax.config.update("jax_default_matmul_precision", saved[0])
        jax_repro._WARNED[0] = saved[1]


# -- merge_dict, get_dtype, UnknownSpecificationsError ---------------------

@pytest.mark.parametrize("custom", [None, {}, {"b": 3, "c": 4}])
def test_merge_dict_matches_jax(custom):
    defaults = {"a": 1, "b": 2}
    ours = merge_dict(defaults, custom)
    assert ours == jax_params.merge_dict(defaults, custom)
    assert ours is not defaults and defaults == {"a": 1, "b": 2}


def test_get_dtype_matches_jax():
    for value in itertools.chain(range(-140, 140), [
            32_767, 32_768, -32_768, 2**31 - 1, 2**31, -2**31, 2**40]):
        assert get_dtype(value) == jax_task.get_dtype(value), value


def test_task_specifications_before_setup_raise_as_jax(tmp_path):
    """Reading a task's specifications before ``setup`` raises the JAX
    package's exception class in both packages."""
    from pyannote_audio_tpu.tasks import VoiceActivityDetection as JaxVAD
    from pyannote_audio_tpu_torch.tasks import VoiceActivityDetection
    from pyannote_audio_tpu_torch.utils.database import Protocol
    from pyannote_audio_tpu.utils.database import Protocol as JaxProtocol
    for Task, protocol, Error in (
            (VoiceActivityDetection, Protocol("p", {"train": []}),
             UnknownSpecificationsError),
            (JaxVAD, JaxProtocol("p", {"train": []}),
             jax_model.UnknownSpecificationsError)):
        task = Task(protocol, duration=2.0)
        with pytest.raises(Error, match="setup"):
            task.specifications
    assert UnknownSpecificationsError.__name__ == \
        jax_model.UnknownSpecificationsError.__name__
    assert issubclass(UnknownSpecificationsError, Exception)
