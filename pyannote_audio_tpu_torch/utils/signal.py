"""Frame-level activations -> Annotation.

Counterpart of ``Binarize`` in pyannote_audio_tpu/utils/signal.py for
onset == offset (a plain threshold) and no minimum segment duration, the
settings the diarization pipeline uses; hysteresis, segment padding and
``min_duration_on`` are not ported yet. Column k is labelled k.
"""

from __future__ import annotations

import numpy as np

from ..core.annotation import Annotation
from ..core.segment import Segment, SlidingWindowFeature


class Binarize:
    """Threshold, then merge same-label gaps below ``min_duration_off``."""

    def __init__(self, onset: float = 0.5, min_duration_off: float = 0.0):
        self.onset = onset
        self.min_duration_off = min_duration_off

    def __call__(self, scores: SlidingWindowFeature) -> Annotation:
        num_frames, num_classes = scores.data.shape
        window = scores.sliding_window
        active = Annotation()
        on = scores.data > self.onset
        # a segment spans from its first active frame's center to the
        # first inactive frame's center (clipped to the last frame)
        t0 = window.start + 0.5 * window.duration
        for k in range(num_classes):
            padded = np.concatenate([[False], on[:, k], [False]])
            starts = np.nonzero(~padded[:-1] & padded[1:])[0]
            ends = np.minimum(np.nonzero(padded[:-1] & ~padded[1:])[0],
                              num_frames - 1)
            for i0, i1 in zip(starts, ends):
                active[Segment(t0 + i0 * window.step,
                               t0 + i1 * window.step), k] = k
        if self.min_duration_off > 0.0:
            active = active.support(collar=self.min_duration_off)
        return active
