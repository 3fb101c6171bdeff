"""Frame-level diarization metrics on numpy arrays, and the per-class
detection F-measure over Annotations.

Counterpart of pyannote_audio_tpu/utils/metric.py:
``discrete_diarization_error_rate`` and its accumulating
``DiscreteDiarizationErrorRate`` (what the segmentation ``evaluate``
reports), ``SlidingDiarizationErrorRate`` over half-overlapping windows,
``MacroAverageFMeasure`` (what ``MultiLabelSegmentation.get_metric``
returns with ``fscore=True``) and ``DiscreteMacroAverageFMeasure`` on
binary frame arrays. Host-side numpy, float64 sums.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from ..core.segment import SlidingWindowFeature
from ..metrics.der import DetectionPrecisionRecallFMeasure
from ..ops.permutation import permutate

_COMPONENTS = ("false alarm", "missed detection", "confusion", "total")


def discrete_diarization_error_rate(reference: np.ndarray,
                                    hypothesis: np.ndarray,
                                    best_permutation: bool = True
                                    ) -> Dict[str, float]:
    """DER components of (frames, speakers) binary ``reference`` and
    ``hypothesis``: both cut to the shorter, the fewer speakers padded
    with silent ones, the hypothesis's speakers permuted onto the
    reference's at the least cost (``best_permutation``)."""
    reference = np.asarray(reference, dtype=float)
    hypothesis = np.asarray(hypothesis, dtype=float)
    n = min(len(reference), len(hypothesis))
    reference, hypothesis = reference[:n], hypothesis[:n]
    k = max(reference.shape[1], hypothesis.shape[1])
    reference = np.pad(reference, ((0, 0), (0, k - reference.shape[1])))
    hypothesis = np.pad(hypothesis, ((0, 0), (0, k - hypothesis.shape[1])))
    if best_permutation:
        hypothesis, _ = permutate(reference, hypothesis)

    n_ref = reference.sum(axis=1)
    n_hyp = hypothesis.sum(axis=1)
    n_correct = (reference * hypothesis).sum(axis=1)
    missed = np.maximum(n_ref - n_hyp, 0.0).sum()
    false_alarm = np.maximum(n_hyp - n_ref, 0.0).sum()
    confusion = (np.minimum(n_ref, n_hyp) - n_correct).sum()
    total = n_ref.sum()
    return {"false alarm": float(false_alarm),
            "missed detection": float(missed),
            "confusion": float(confusion), "total": float(total),
            "diarization error rate":
                float((false_alarm + missed + confusion) / max(total, 1e-8))}


def _rate(components: Dict[str, float]) -> float:
    return (components["false alarm"] + components["missed detection"]
            + components["confusion"]) / max(components["total"], 1e-8)


class DiscreteDiarizationErrorRate:
    """``discrete_diarization_error_rate`` accumulated over calls: each call
    returns its own rate, ``compute()`` (or ``abs()``) the aggregate."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self._components = dict.fromkeys(_COMPONENTS, 0.0)

    def __call__(self, reference: np.ndarray,
                 hypothesis: np.ndarray) -> float:
        parts = discrete_diarization_error_rate(reference, hypothesis)
        for key in self._components:
            self._components[key] += parts[key]
        return parts["diarization error rate"]

    def compute(self) -> float:
        return _rate(self._components)

    def __abs__(self) -> float:
        return self.compute()


class SlidingDiarizationErrorRate:
    """One DER over windows of ``window`` seconds every ``window / 2``
    (their components summed), with a last window aligned to the end
    where the grid stops short of it; each window's own rate is kept in
    ``windowed_``."""

    def __init__(self, window: float = 10.0):
        self.window = window
        self.windowed_: np.ndarray = np.asarray([])

    def __call__(self, reference: SlidingWindowFeature,
                 hypothesis: SlidingWindowFeature) -> float:
        step = reference.sliding_window.step
        frames = max(1, int(round(self.window / step)))
        hop = max(1, frames // 2)
        n = min(len(reference.data), len(hypothesis.data))
        starts = list(range(0, max(n - frames, 0) + 1, hop)) or [0]
        if starts[-1] + frames < n:
            starts.append(max(n - frames, 0))
        components = dict.fromkeys(_COMPONENTS, 0.0)
        rates = []
        for start in starts:
            stop = min(start + frames, n)
            parts = discrete_diarization_error_rate(
                reference.data[start:stop], hypothesis.data[start:stop])
            for key in components:
                components[key] += parts[key]
            rates.append(parts["diarization error rate"])
        self.windowed_ = np.asarray(rates)
        return float(_rate(components))


class MacroAverageFMeasure:
    """One accumulating detection F-measure per class, averaged."""

    def __init__(self, classes):
        self._per_class = {c: DetectionPrecisionRecallFMeasure()
                           for c in classes}

    def __call__(self, reference, hypothesis, uem=None,
                 detailed: bool = False):
        values = {label: metric(reference.subset([label]),
                                hypothesis.subset([label]), uem=uem)
                  for label, metric in self._per_class.items()}
        mean = sum(values.values()) / max(len(values), 1)
        return {"macro fscore": mean, **values} if detailed else mean

    def __abs__(self) -> float:
        values = [abs(m) for m in self._per_class.values()]
        return sum(values) / max(len(values), 1)


class DiscreteMacroAverageFMeasure:
    """Per-class F-measure on binary (frames, classes) arrays, counts
    accumulated over calls, macro-averaged. A class absent from both sides
    scores precision = recall = 1, as pyannote.metrics does."""

    def __init__(self, classes):
        self.classes = list(classes)
        self.reset()

    def reset(self) -> None:
        self._tp = np.zeros(len(self.classes))
        self._fp = np.zeros(len(self.classes))
        self._fn = np.zeros(len(self.classes))

    def __call__(self, reference: np.ndarray,
                 hypothesis: np.ndarray) -> float:
        reference = np.asarray(reference) > 0.5
        hypothesis = np.asarray(hypothesis) > 0.5
        if reference.ndim != hypothesis.ndim or \
                reference.shape[1:] != hypothesis.shape[1:]:
            raise ValueError(
                f"class-count mismatch: reference {reference.shape} vs "
                f"hypothesis {hypothesis.shape} (broadcasting would credit "
                "every class with the same detections)")
        n = min(len(reference), len(hypothesis))
        reference, hypothesis = reference[:n], hypothesis[:n]
        self._tp += (reference & hypothesis).sum(axis=0)
        self._fp += (~reference & hypothesis).sum(axis=0)
        self._fn += (reference & ~hypothesis).sum(axis=0)
        return self.compute()

    def compute(self) -> float:
        empty = (self._tp + self._fp + self._fn) == 0
        precision = np.where(
            empty, 1.0, self._tp / np.maximum(self._tp + self._fp, 1e-8))
        recall = np.where(
            empty, 1.0, self._tp / np.maximum(self._tp + self._fn, 1e-8))
        f = 2 * precision * recall / np.maximum(precision + recall, 1e-8)
        return float(np.mean(f))
