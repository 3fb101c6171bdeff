"""Binarization: the port's host ``utils/signal.py`` and device
``ops/binarize.py`` against the JAX package's.

Inputs are seeded random scores with NaN runs and plateaus at the
thresholds. Held, all exactly: ``binarize_ndarray`` / ``binarize_swf``
states, ``Binarize`` annotations (same segments, tracks and labels, with
and without hysteresis, minimum durations, pads and NaN), ``Peak``
timelines, and the device ``hysteresis`` against the JAX scan for each
``initial_on``. Each host function is held against its own JAX
counterpart: ``Binarize`` starts from ``y[0] > onset`` and scans from
frame 1, ``binarize_ndarray`` decides frame 0 by the band's midpoint.
The Annotation and Timeline methods that the pipelines and metrics use
are held to the JAX package's on random overlapping tracks (equal
results; the RTTM text equal character for character).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from pyannote_audio_tpu.core import annotation as jax_annotation
from pyannote_audio_tpu.core.segment import (
    Segment as JaxSegment, SlidingWindow as JaxSlidingWindow,
    SlidingWindowFeature as JaxSlidingWindowFeature)
from pyannote_audio_tpu.ops.binarize import hysteresis as jax_hysteresis
from pyannote_audio_tpu.utils import signal as jax_signal
from pyannote_audio_tpu_torch.core import annotation
from pyannote_audio_tpu_torch.core.segment import (Segment, SlidingWindow,
                                                   SlidingWindowFeature)
from pyannote_audio_tpu_torch.ops.binarize import hysteresis
from pyannote_audio_tpu_torch.utils import signal
from test_torch_port_models import one_torch_thread  # noqa: F401


def _scores(shape, seed, nan=True):
    rng = np.random.default_rng(seed)
    x = rng.random(shape).astype(np.float32)
    # plateaus exactly at the thresholds used below, and NaN runs
    x[rng.random(shape) < 0.05] = 0.5
    x[rng.random(shape) < 0.05] = 0.3
    if nan:
        flat = x.reshape(-1)
        for start in rng.integers(0, flat.size - 8, size=4):
            flat[start:start + int(rng.integers(1, 8))] = np.nan
    return x


def _tracks(annotation):
    return [(s.start, s.end, str(t), lbl)
            for s, t, lbl in annotation.itertracks(yield_label=True)]


WINDOW = dict(start=0.13, duration=0.0619, step=0.0169)


@pytest.mark.parametrize("onset,offset", [(0.5, None), (0.6, 0.3),
                                          (0.5, 0.5)])
@pytest.mark.parametrize("initial", [None, True, False, "array"])
def test_binarize_ndarray_and_swf(onset, offset, initial):
    x = _scores((6, 300), seed=1)
    if initial == "array":
        initial = np.array([True, False, True, True, False, False])
    np.testing.assert_array_equal(
        signal.binarize_ndarray(x, onset, offset, initial),
        jax_signal.binarize_ndarray(x, onset, offset, initial))
    if isinstance(initial, np.ndarray):
        return
    for data in (_scores((300, 3), seed=2), _scores((5, 300, 3), seed=3)):
        ours = signal.binarize(SlidingWindowFeature(
            data, SlidingWindow(**WINDOW)), onset, offset, initial)
        theirs = jax_signal.binarize(JaxSlidingWindowFeature(
            data, JaxSlidingWindow(**WINDOW)), onset, offset, initial)
        assert ours.data.dtype == np.float32
        np.testing.assert_array_equal(ours.data, theirs.data)


@pytest.mark.parametrize("onset,offset", [(0.5, 0.5), (0.6, 0.3),
                                          (0.7, 0.65)])
@pytest.mark.parametrize("min_on,min_off,pad_on,pad_off", [
    (0.0, 0.0, 0.0, 0.0), (0.1, 0.0, 0.0, 0.0), (0.0, 0.2, 0.0, 0.0),
    (0.05, 0.1, 0.02, 0.03)])
def test_binarize_class(onset, offset, min_on, min_off, pad_on, pad_off):
    data = _scores((600, 3), seed=4)
    kwargs = dict(onset=onset, offset=offset, min_duration_on=min_on,
                  min_duration_off=min_off, pad_onset=pad_on,
                  pad_offset=pad_off)
    for labels in (None, ["x", "y", "z"]):
        ours = signal.Binarize(**kwargs)(SlidingWindowFeature(
            data, SlidingWindow(**WINDOW), labels=labels))
        theirs = jax_signal.Binarize(**kwargs)(JaxSlidingWindowFeature(
            data, JaxSlidingWindow(**WINDOW), labels=labels))
        assert _tracks(ours) == _tracks(theirs) and len(ours) > 0


@pytest.mark.parametrize("alpha,min_duration", [(0.5, 0.05), (0.2, 0.3)])
def test_peak(alpha, min_duration):
    data = _scores((400, 1), seed=5, nan=False)
    ours = signal.Peak(alpha, min_duration)(SlidingWindowFeature(
        data, SlidingWindow(**WINDOW)))
    theirs = jax_signal.Peak(alpha, min_duration)(JaxSlidingWindowFeature(
        data, JaxSlidingWindow(**WINDOW)))
    assert [(s.start, s.end) for s in ours] == \
        [(s.start, s.end) for s in theirs]
    with pytest.raises(ValueError):
        signal.Peak()(SlidingWindowFeature(_scores((10, 2), seed=6),
                                           SlidingWindow()))


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("initial_on", [None, True, False])
@pytest.mark.parametrize("onset,offset", [(0.5, 0.5), (0.6, 0.3)])
def test_device_hysteresis_as_jax(seed, initial_on, onset, offset):
    x = _scores((257, 4, 3), seed=10 + seed)
    if seed == 0:
        x[0] = 0.45       # an undecided first frame in the band
    expected = np.asarray(jax_hysteresis(jnp.asarray(x), onset, offset,
                                         initial_on=initial_on))
    ours = hysteresis(torch.from_numpy(x), onset, offset,
                      initial_on=initial_on)
    assert ours.dtype == torch.bool and ours.shape == x.shape
    np.testing.assert_array_equal(ours.numpy(), expected)
    if seed == 0:
        return    # the host computes the band's midpoint in float64
    # the device scan is binarize_ndarray with frames on axis 0
    flat = x.reshape(x.shape[0], -1).T
    host = signal.binarize_ndarray(flat, onset, offset, initial_on)
    np.testing.assert_array_equal(ours.numpy().reshape(x.shape[0], -1).T,
                                  host)


def test_device_hysteresis_thresholds_as_tensors():
    x = torch.from_numpy(_scores((100, 2), seed=20))
    a = hysteresis(x, 0.6, 0.3, initial_on=False)
    b = hysteresis(x, torch.tensor(0.6), torch.tensor(0.3), initial_on=False)
    assert torch.equal(a, b)


def _pair(seed):
    """The same random overlapping tracks as a port and a JAX Annotation."""
    rng = np.random.default_rng(seed)
    ours = annotation.Annotation(uri="f")
    theirs = jax_annotation.Annotation(uri="f")
    for k in range(12):
        start = float(np.round(rng.uniform(0, 20), 3))
        end = float(np.round(start + rng.uniform(0.1, 4), 3))
        label = f"s{int(rng.integers(3))}"
        track = "A" if k % 4 else "B"
        ours[Segment(start, end), track] = label
        theirs[JaxSegment(start, end), track] = label
    return ours, theirs


def _segs(timeline):
    return [(s.start, s.end) for s in timeline]


@pytest.mark.parametrize("seed", range(3))
def test_annotation_methods_as_jax(seed):
    ours, theirs = _pair(seed)
    assert ours.to_rttm() == theirs.to_rttm()
    for seg, _, _ in theirs.itertracks(yield_label=True):
        mine = Segment(seg.start, seg.end)
        assert ours.get_tracks(mine) == theirs.get_tracks(seg)
        assert ours.get_labels(mine) == theirs.get_labels(seg)
    for label in theirs.labels():
        assert ours.label_duration(label) == pytest.approx(
            theirs.label_duration(label), abs=1e-12)
    assert _tracks(ours.subset(["s0", "s2"])) == \
        _tracks(theirs.subset(["s0", "s2"]))
    assert _tracks(ours.extrude(Segment(3.0, 9.0))) == \
        _tracks(theirs.extrude(JaxSegment(3.0, 9.0)))
    merged, jax_merged = ours.copy(), theirs.copy()
    other, jax_other = _pair(seed + 10)
    assert _tracks(merged.update(other)) == _tracks(jax_merged.update(
        jax_other))
    assert _tracks(ours) == _tracks(theirs)          # copies left alone
    timeline, jax_timeline = ours.get_timeline(), theirs.get_timeline()
    assert timeline.duration() == pytest.approx(jax_timeline.duration(),
                                                abs=1e-12)
    assert _segs(timeline.union(other.get_timeline())) == _segs(
        jax_timeline.union(jax_other.get_timeline()))
    assert _segs(timeline.overlapping(5.0)) == _segs(
        jax_timeline.overlapping(5.0))
    assert timeline.covers(timeline.support()) == \
        jax_timeline.covers(jax_timeline.support())
    assert timeline.support().covers(other.get_timeline()) == \
        jax_timeline.support().covers(jax_other.get_timeline())
    assert _tracks(timeline.support().to_annotation()) == _tracks(
        jax_timeline.support().to_annotation())
    del ours[next(iter(ours.itertracks()))]
    del theirs[next(iter(theirs.itertracks()))]
    assert _tracks(ours) == _tracks(theirs)
