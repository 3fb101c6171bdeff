"""Score binarization: hysteresis thresholding and frame -> segment
extraction, on the host.

Counterpart of pyannote_audio_tpu/utils/signal.py: ``binarize`` (numpy
arrays through ``binarize_ndarray``, SlidingWindowFeature through
``binarize_swf``), ``Binarize`` (hysteresis, ``min_duration_on`` /
``_off``, ``pad_onset`` / ``_offset``) and ``Peak``. ``binarize_ndarray``
and ``Binarize`` keep the JAX package's two semantics: the first decides
an undecided frame 0 by the band's midpoint and scans from frame 0, the
second starts from ``y[0] > onset`` and scans transitions from frame 1.
The device hysteresis of ``binarize_ndarray`` is ``ops/binarize.py``.
``nearest_binary_mask`` is the embedding wrappers' speech mask.
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

from ..core.annotation import Annotation, Timeline
from ..core.segment import Segment, SlidingWindowFeature


def binarize(
    scores,
    onset: float = 0.5,
    offset: Optional[float] = None,
    initial_state: Union[bool, None] = None,
):
    """(Batch) hysteresis thresholding, dispatched on input type: numpy
    arrays go through ``binarize_ndarray``, SlidingWindowFeature through
    ``binarize_swf``."""
    if isinstance(scores, SlidingWindowFeature):
        return binarize_swf(scores, onset=onset, offset=offset,
                            initial_state=initial_state)
    if isinstance(scores, np.ndarray):
        return binarize_ndarray(scores, onset=onset, offset=offset,
                                initial_state=initial_state)
    raise NotImplementedError(
        "scores must be a numpy.ndarray or a SlidingWindowFeature, "
        f"got {type(scores).__name__}")


def binarize_ndarray(
    scores: np.ndarray,
    onset: float = 0.5,
    offset: Optional[float] = None,
    initial_state: Union[bool, np.ndarray, None] = None,
) -> np.ndarray:
    """Batch hysteresis over (batch_size, num_frames) scores, scanning the
    last axis.

    A frame turns on when score > onset, off when score < offset, and
    keeps the previous state in between. ``initial_state`` may be a bool
    or a (batch_size,) bool array; when None, the hysteresis-band midpoint
    decides from ``scores[:, 0]``.
    """
    offset = onset if offset is None else offset
    scores = np.nan_to_num(scores)       # NaN -> 0.0
    batch_size, num_frames = scores.shape
    on = scores > onset
    off = scores < offset
    # state per frame: +1 on, -1 off, 0 keep-previous; forward-fill nonzeros
    state = np.where(on, 1, np.where(off, -1, 0)).astype(np.int8)
    out = np.empty((batch_size, num_frames), dtype=bool)
    if initial_state is None:
        # undecided start: the band's midpoint decides
        prev = scores[:, 0] >= 0.5 * (onset + offset)
    elif isinstance(initial_state, (bool, np.bool_)):
        prev = np.full(batch_size, bool(initial_state))
    else:
        initial_state = np.asarray(initial_state)
        assert initial_state.shape == (batch_size,)
        prev = initial_state.astype(bool).copy()
    for t in range(num_frames):
        prev = np.where(state[:, t] == 0, prev, state[:, t] > 0)
        out[:, t] = prev
    return out


def binarize_swf(
    scores: SlidingWindowFeature,
    onset: float = 0.5,
    offset: Optional[float] = None,
    initial_state: Optional[bool] = None,
) -> SlidingWindowFeature:
    """Hysteresis along the frame axis of 2-d (frames, classes) or 3-d
    (chunks, frames, classes) features: each chunk scans its own
    frames."""
    data = scores.data
    if data.ndim == 3:
        c, f, k = data.shape
        flat = np.transpose(data, (0, 2, 1)).reshape(c * k, f)
        binarized = binarize_ndarray(
            flat, onset=onset, offset=offset, initial_state=initial_state)
        binarized = np.transpose(binarized.reshape(c, k, f), (0, 2, 1))
    elif data.ndim == 2:
        binarized = binarize_ndarray(
            data.T, onset=onset, offset=offset,
            initial_state=initial_state).T
    else:
        raise ValueError(
            "Shape of scores must be (num_chunks, num_frames, num_classes)"
            " or (num_frames, num_classes).")
    return SlidingWindowFeature(
        binarized.astype(np.float32),
        scores.sliding_window, labels=scores.labels)


class Binarize:
    """Hysteresis + min-duration post-processing -> Annotation."""

    def __init__(
        self,
        onset: float = 0.5,
        offset: Optional[float] = None,
        min_duration_on: float = 0.0,
        min_duration_off: float = 0.0,
        pad_onset: float = 0.0,
        pad_offset: float = 0.0,
    ):
        self.onset = onset
        self.offset = onset if offset is None else offset
        self.min_duration_on = min_duration_on
        self.min_duration_off = min_duration_off
        self.pad_onset = pad_onset
        self.pad_offset = pad_offset

    def __call__(self, scores: SlidingWindowFeature) -> Annotation:
        num_frames, num_classes = scores.data.shape
        window = scores.sliding_window
        labels = scores.labels or list(range(num_classes))

        active = Annotation(uri=getattr(scores, "uri", None))
        if self.onset == self.offset:
            # vectorized run extraction (hysteresis degenerates to a
            # simple threshold); centers = window[i].middle
            on = scores.data > self.onset
            t0 = window.start + 0.5 * window.duration
            for k, label in enumerate(labels):
                padded = np.concatenate([[False], on[:, k], [False]])
                starts = np.nonzero(~padded[:-1] & padded[1:])[0]
                # a segment ends at the first inactive frame's center
                # (clipped to the last frame — matches the scan below)
                ends = np.minimum(
                    np.nonzero(padded[:-1] & ~padded[1:])[0],
                    num_frames - 1)
                for i0, i1 in zip(starts, ends):
                    seg = Segment(
                        t0 + i0 * window.step - self.pad_onset,
                        t0 + i1 * window.step + self.pad_offset)
                    if seg:
                        active[seg, k] = label
        else:
            timestamps = [window[i].middle for i in range(num_frames)]
            for k, label in enumerate(labels):
                y = scores.data[:, k]
                # frame 0 sets the initial state only; transitions are
                # scanned from frame 1
                is_active = y[0] > self.onset
                start = timestamps[0]
                for ts, score in zip(timestamps[1:], y[1:]):
                    if is_active:
                        if score < self.offset:
                            seg = Segment(start - self.pad_onset,
                                          ts + self.pad_offset)
                            if seg:
                                active[seg, k] = label
                            start = ts
                            is_active = False
                    else:
                        if score > self.onset:
                            start = ts
                            is_active = True
                if is_active:
                    seg = Segment(start - self.pad_onset,
                                  timestamps[-1] + self.pad_offset)
                    if seg:
                        active[seg, k] = label

        # merge over short gaps
        if self.pad_offset > 0.0 or self.pad_onset > 0.0 or \
                self.min_duration_off > 0.0:
            active = active.support(collar=self.min_duration_off)

        # drop too-short segments
        if self.min_duration_on > 0.0:
            for seg, track in list(active.itertracks()):
                if seg.duration < self.min_duration_on:
                    del active[seg, track]
        return active


class Peak:
    """Local-maximum detection over 1-d scores -> homogeneous Timeline:
    boundaries at score peaks above ``alpha``."""

    def __init__(self, alpha: float = 0.5, min_duration: float = 1.0):
        self.alpha = alpha
        self.min_duration = min_duration

    def __call__(self, scores: SlidingWindowFeature) -> Timeline:
        if scores.data.ndim > 2 or (scores.data.ndim == 2
                                    and scores.data.shape[1] != 1):
            raise ValueError("Peak expects one-dimensional scores.")
        y = scores.data.reshape(-1)
        window = scores.sliding_window
        num_frames = len(y)
        order = max(1, int(np.rint(self.min_duration / window.step)))
        # scipy.signal.argrelmax(order=order, mode='clip') semantics:
        # strictly greater than every
        # neighbour within `order` on both sides, indices clipped at the
        # boundaries (so frame 0 / frame n-1 are never maxima, and score
        # plateaus yield no peaks at all)
        maxima = []
        for i in range(num_frames):
            if all(y[i] > y[max(i - k, 0)]
                   and y[i] > y[min(i + k, num_frames - 1)]
                   for k in range(1, order + 1)):
                maxima.append(i)
        boundaries = [window[i].middle for i in maxima
                      if y[i] > self.alpha]
        # final boundary at frames[num_frames].end, one window step past
        # the last frame's window
        edges = [window[0].start] + boundaries + [window[num_frames].end]
        segmentation = Timeline(
            [Segment(a, b) for a, b in zip(edges[:-1], edges[1:])
             if Segment(a, b)])
        return segmentation


def nearest_binary_mask(weights, size: int):
    """Nearest-neighbour upsampling of ``(..., frames)`` weights to
    ``size`` points, binarized at 0.5: the embedding wrappers' mask
    (F.interpolate(mode="nearest") > 0.5). A boolean array of shape
    ``(..., size)``, a tensor on the weights' device for a tensor."""
    if isinstance(weights, torch.Tensor):
        idx = torch.clamp(torch.arange(size, device=weights.device)
                          * weights.shape[-1] // size,
                          max=weights.shape[-1] - 1)
        return weights.float()[..., idx] > 0.5
    weights = np.asarray(weights, dtype=np.float32)
    idx = np.minimum((np.arange(size) * weights.shape[-1]) // size,
                     weights.shape[-1] - 1)
    return weights[..., idx] > 0.5
