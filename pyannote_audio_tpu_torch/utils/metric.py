"""Per-class detection F-measure over Annotations, macro-averaged.

Counterpart of ``MacroAverageFMeasure`` in pyannote_audio_tpu/utils/
metric.py: what ``MultiLabelSegmentation.get_metric`` returns with
``fscore=True``.
"""

from __future__ import annotations

from ..metrics.der import DetectionPrecisionRecallFMeasure


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
