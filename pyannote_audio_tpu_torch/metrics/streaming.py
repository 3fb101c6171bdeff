"""Equal error rate over verification trials.

Counterpart of ``det_curve`` and ``EqualErrorRate`` of
pyannote_audio_tpu/metrics/streaming.py (host numpy, as there). The
streaming training metrics of that module come with the training slice.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def det_curve(scores: np.ndarray, labels: np.ndarray
              ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(fpr, fnr, thresholds) with tied scores grouped: each distinct score
    is one operating point, since every trial with that score flips
    together."""
    scores = np.asarray(scores, dtype=float).reshape(-1)
    labels = np.asarray(labels, dtype=int).reshape(-1)
    order = np.argsort(-scores, kind="stable")
    scores, labels = scores[order], labels[order]
    pos = max(int(labels.sum()), 1)
    neg = max(len(labels) - int(labels.sum()), 1)
    # operating points = last index of each group of equal scores
    distinct = np.ones(len(scores), dtype=bool)
    if len(scores) > 1:
        distinct[:-1] = np.diff(scores) != 0
    tp = np.cumsum(labels)[distinct]
    fp = np.cumsum(1 - labels)[distinct]
    fnr = 1.0 - tp / pos          # miss rate (non-increasing)
    fpr = fp / neg                # false-positive rate (non-decreasing)
    return fpr, fnr, scores[distinct]


class EqualErrorRate:
    """EER over accumulated (score, binary label) pairs; ``__call__``
    accumulates and returns the EER of its own batch."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.scores = []
        self.labels = []

    def update(self, scores, labels):
        self.scores.append(np.asarray(scores, dtype=float).reshape(-1))
        self.labels.append(np.asarray(labels, dtype=int).reshape(-1))

    @staticmethod
    def _eer(scores: np.ndarray, labels: np.ndarray) -> float:
        fpr, fnr, _ = det_curve(scores, labels)
        # the EER sits where fnr (decreasing) crosses fpr (increasing):
        # linear interpolation between the two bracketing points
        diff = fnr - fpr
        (above,) = np.nonzero(diff <= 0)
        if len(above) == 0:               # never crosses: degenerate sets
            i = int(np.argmin(np.abs(diff)))
            return float(0.5 * (fnr[i] + fpr[i]))
        i = int(above[0])
        if i == 0 or diff[i] == 0:
            return float(0.5 * (fnr[i] + fpr[i]))
        w = diff[i - 1] / (diff[i - 1] - diff[i])
        fnr_x = fnr[i - 1] + w * (fnr[i] - fnr[i - 1])
        fpr_x = fpr[i - 1] + w * (fpr[i] - fpr[i - 1])
        return float(0.5 * (fnr_x + fpr_x))

    def compute(self) -> float:
        if not self.scores:
            return float("nan")      # no trials accumulated
        return self._eer(np.concatenate(self.scores),
                         np.concatenate(self.labels))

    def __call__(self, scores, labels) -> float:
        self.update(scores, labels)
        return self._eer(np.asarray(scores, dtype=float).reshape(-1),
                         np.asarray(labels, dtype=int).reshape(-1))
