"""Temporal primitives: Segment, SlidingWindow, SlidingWindowFeature.

Counterpart of pyannote_audio_tpu/core/segment.py, cut to what the
diarization path, the oracle segmentation and the DER metric use.
Host-side and numpy-only, except that a
SlidingWindowFeature may hold a torch tensor (chunk-level scores that stay
on the model's device until a consumer moves them).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Iterator, List, Optional, Union

import numpy as np

# Two segments closer than this are considered identical / touching.
SEGMENT_PRECISION = 1e-6


@dataclass(frozen=True, order=True)
class Segment:
    """A time interval [start, end), in seconds."""

    start: float = 0.0
    end: float = 0.0

    @property
    def duration(self) -> float:
        return self.end - self.start if self.end > self.start else 0.0

    @property
    def middle(self) -> float:
        return 0.5 * (self.start + self.end)

    def __bool__(self) -> bool:
        """A segment is false-y when empty (duration below precision)."""
        return bool((self.end - self.start) > SEGMENT_PRECISION)

    def __contains__(self, other: "Segment") -> bool:
        return (self.start <= other.start) and (self.end >= other.end)

    def __and__(self, other: "Segment") -> "Segment":
        """Intersection (may be empty / false-y)."""
        return Segment(max(self.start, other.start), min(self.end, other.end))

    def __or__(self, other: "Segment") -> "Segment":
        """Union hull (the smallest segment holding both)."""
        if not self:
            return other
        if not other:
            return self
        return Segment(min(self.start, other.start), max(self.end, other.end))

    def overlaps(self, t: float) -> bool:
        return self.start <= t <= self.end

    def __str__(self) -> str:
        return f"[{self.start:.3f} --> {self.end:.3f}]"

    def __repr__(self) -> str:
        return f"<Segment({self.start:g}, {self.end:g})>"


class SlidingWindow:
    """Fixed-duration window sliding with a fixed step.

    Frame ``i`` covers ``[start + i * step, start + i * step + duration)``.
    """

    def __init__(self, duration: float = 0.030, step: float = 0.010,
                 start: float = 0.0):
        if duration <= 0:
            raise ValueError("duration must be positive")
        if step <= 0:
            raise ValueError("step must be positive")
        self._duration = float(duration)
        self._step = float(step)
        self._start = float(start)

    duration = property(lambda self: self._duration)
    step = property(lambda self: self._step)
    start = property(lambda self: self._start)

    def __eq__(self, other) -> bool:
        return (isinstance(other, SlidingWindow)
                and self._duration == other._duration
                and self._step == other._step
                and self._start == other._start)

    def closest_frame(self, t: float) -> int:
        """Index of the frame whose *center* is closest to time ``t``."""
        return int(np.rint(
            (t - self._start - 0.5 * self._duration) / self._step))

    def samples(self, from_duration: float, mode: str = "strict") -> int:
        """Number of frames in a span of ``from_duration`` seconds."""
        if mode == "strict":
            return int(math.floor((from_duration - self._duration)
                                  / self._step)) + 1
        if mode == "loose":
            return int(math.floor((from_duration + self._duration)
                                  / self._step))
        if mode == "center":
            return int(np.rint(from_duration / self._step))
        raise ValueError(f"unknown mode {mode!r}")

    def __getitem__(self, i: int) -> Segment:
        start = self._start + i * self._step
        return Segment(start, start + self._duration)

    def __call__(self, support: Union[Segment, float],
                 align_last: bool = False) -> Iterator[Segment]:
        """Windows covering ``support`` (a Segment or a duration); with
        ``align_last``, one more ending at the support's end (starting at
        its start when the support is shorter than a window)."""
        if isinstance(support, (int, float)):
            support = Segment(0.0, float(support))
        last = None
        i = 0
        while True:
            s = support.start + i * self._step
            if s + self._duration > support.end + SEGMENT_PRECISION:
                break
            last = Segment(s, s + self._duration)
            yield last
            i += 1
        if align_last:
            final_start = max(support.start, support.end - self._duration)
            final = Segment(final_start, final_start + self._duration)
            if final and (last is None or final.start - last.start
                          > SEGMENT_PRECISION):
                yield final

    def __repr__(self) -> str:
        return (f"<SlidingWindow duration={self._duration:g} "
                f"step={self._step:g} start={self._start:g}>")


class SlidingWindowFeature:
    """A (num_frames, ...) array whose first axis is a SlidingWindow.

    ``data`` is a numpy array, or a torch tensor for chunk-level scores
    that stay on the device they were computed on.
    """

    def __init__(self, data, sliding_window: SlidingWindow,
                 labels: Optional[List] = None):
        self.data = data
        self.sliding_window = sliding_window
        self.labels = labels

    def __len__(self) -> int:
        return len(self.data)

    @property
    def extent(self) -> Segment:
        return Segment(self.sliding_window[0].start,
                       self.sliding_window[len(self.data) - 1].end)

    def crop_loose(self, focus: Segment) -> "SlidingWindowFeature":
        """The frames with a strictly positive overlap with ``focus``
        (the JAX package's ``crop(focus, mode="loose", return_data=False)``
        without ``fixed``), clipped to the data."""
        window = self.sliding_window
        i0 = int(np.ceil((focus.start - window.duration - window.start)
                         / window.step + SEGMENT_PRECISION))
        j = int(np.floor((focus.end - window.start) / window.step
                         - SEGMENT_PRECISION))
        n = len(self.data)
        lo = min(max(i0, 0), n)
        hi = min(max(i0 + max(j - i0 + 1, 0), lo), n)
        return SlidingWindowFeature(
            self.data[lo:hi], SlidingWindow(duration=window.duration,
                                            step=window.step,
                                            start=window[lo].start),
            labels=self.labels)

    def crop_fixed(self, focus: Segment, fixed: float) -> np.ndarray:
        """The data of the frames overlapping ``focus``, exactly as many
        as ``fixed`` seconds give (the JAX package's ``crop(focus,
        fixed=...)``): past the data the edge frames repeat, and a crop
        wholly outside it is zeros."""
        window = self.sliding_window
        i0 = int(np.ceil((focus.start - window.duration - window.start)
                         / window.step + SEGMENT_PRECISION))
        length = max(int(np.floor((fixed + window.duration) / window.step)),
                     0)
        n = len(self.data)
        lo = min(max(i0, 0), n)
        hi = min(max(i0 + length, lo), n)
        pad_before = min(length, max(0, -i0))
        pad_after = length - pad_before - (hi - lo)
        chunk = self.data[lo:hi]
        if pad_before > 0 or pad_after > 0:
            if len(chunk):
                chunk = np.pad(chunk, [(pad_before, pad_after)]
                               + [(0, 0)] * (self.data.ndim - 1),
                               mode="edge")
            else:
                chunk = np.zeros((length,) + self.data.shape[1:],
                                 dtype=self.data.dtype)
        return chunk

    def __repr__(self) -> str:
        return (f"<SlidingWindowFeature shape={tuple(self.data.shape)} "
                f"window={self.sliding_window!r}>")
