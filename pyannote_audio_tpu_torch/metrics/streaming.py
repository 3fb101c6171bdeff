"""Streaming diarization metrics, and the equal error rate.

Counterpart of pyannote_audio_tpu/metrics/streaming.py. The DER family
follows torchmetrics' contract (``update`` accumulates, ``compute``
returns the running aggregate, ``__call__`` accumulates and returns the
batch's own value). One pass computes the components for every threshold
at once: the speakers are aligned once on the soft predictions (each of
the K! permutations scored, for K <= 6; the host Hungarian beyond), then
the threshold axis broadcasts through the binarization. Components stay
device tensors and accumulate on the device; ``compute`` reads them. One
process: there is no cross-device reduction (``Trainer(mesh=)`` is not
taken). ``det_curve`` and ``EqualErrorRate`` are host numpy, as there.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
import torch

from ..ops.permutation import permutate_device

#: the Optimal* family's thresholds
DEFAULT_THRESHOLDS = np.linspace(0.0, 1.0, 51)


def _permutate(target: torch.Tensor, preds: torch.Tensor) -> torch.Tensor:
    """``preds``' speakers aligned to ``target``'s, item by item: the
    permutation of least mean squared error (the first on ties, in
    ``itertools.permutations`` order)."""
    if preds.shape[-1] > 6:
        from ..ops.permutation import permutate
        aligned, _ = permutate(target.cpu().numpy(), preds.cpu().numpy())
        return torch.as_tensor(aligned, device=preds.device)
    return permutate_device(target, preds)[0]


def _pad_speakers(preds: torch.Tensor, target: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    k = max(preds.shape[-1], target.shape[-1])
    pad = torch.nn.functional.pad
    return (pad(preds, (0, k - preds.shape[-1])),
            pad(target, (0, k - target.shape[-1])))


def der_components(preds, target, thresholds) -> torch.Tensor:
    """(3T + 1,) packed [false alarm (T,), missed (T,), confusion (T,),
    total] of (batch, frames, speakers) scores in [0, 1] against binary
    targets at a (T,) threshold vector; on the predictions' device."""
    preds = torch.as_tensor(preds, dtype=torch.float32)
    target = torch.as_tensor(target, dtype=torch.float32,
                             device=preds.device)
    thresholds = torch.as_tensor(np.asarray(thresholds),
                                 dtype=torch.float32, device=preds.device)
    preds, target = _pad_speakers(preds, target)
    permuted = _permutate(target, preds)
    hyp = (permuted[..., None] > thresholds).float()          # (B, F, K, T)
    n_ref = target.sum(-1)                                    # (B, F)
    n_hyp = hyp.sum(2)                                        # (B, F, T)
    n_correct = (target[..., None] * hyp).sum(2)
    detection_error = n_hyp - n_ref[..., None]
    false_alarm = detection_error.clamp(min=0.0).sum((0, 1))
    missed = (-detection_error).clamp(min=0.0).sum((0, 1))
    confusion = (torch.minimum(n_ref[..., None], n_hyp)
                 - n_correct).sum((0, 1))
    return torch.cat([false_alarm, missed, confusion, n_ref.sum()[None]])


def unpack_der_components(packed, num_thresholds: int):
    """Split a packed vector into (fa, miss, conf, total)."""
    t = num_thresholds
    return packed[:t], packed[t:2 * t], packed[2 * t:3 * t], packed[3 * t]


def der_update(preds, target,
               threshold: Union[float, np.ndarray] = 0.5):
    """One batch of DER components (false_alarm, missed, confusion,
    total): scalars for a scalar ``threshold``, (T,) vectors (total
    scalar) for a (T,) one."""
    scalar = np.ndim(threshold) == 0
    thresholds = np.atleast_1d(np.asarray(threshold, np.float32))
    fa, miss, conf, total = unpack_der_components(
        der_components(preds, target, thresholds), len(thresholds))
    if scalar:
        return fa[0], miss[0], conf[0], total
    return fa, miss, conf, total


def der_compute(false_alarm, missed, confusion, total):
    return (false_alarm + missed + confusion) / torch.clamp(
        torch.as_tensor(total), min=1e-8)


def diarization_error_rate(preds, target, threshold: float = 0.5) -> float:
    """One-shot frame-level DER."""
    return float(der_compute(*der_update(preds, target, threshold)))


def optimal_diarization_error_rate(preds, target,
                                   thresholds: Optional[np.ndarray] = None
                                   ) -> Tuple[float, float]:
    """(least DER, its threshold) over a threshold sweep, 51 values by
    default, in one pass."""
    thresholds = DEFAULT_THRESHOLDS if thresholds is None \
        else np.asarray(thresholds)
    ders = der_compute(*der_update(preds, target,
                                   threshold=thresholds)).cpu().numpy()
    best = int(np.argmin(ders))
    return float(ders[best]), float(thresholds[best])


class _StreamingMetric:
    """Accumulating DER-family metric at one threshold."""

    def __init__(self, threshold: float = 0.5):
        self.threshold = threshold
        self.reset()

    def reset(self):
        self.false_alarm = 0.0
        self.missed_detection = 0.0
        self.speaker_confusion = 0.0
        self.speech_total = 0.0

    def update(self, preds, target):
        """Accumulate one batch; returns its components (device
        tensors)."""
        packed = der_components(preds, target, [self.threshold])
        components = unpack_der_components(packed, 1)
        self.update_from_components(*components)
        return components

    def update_from_components(self, false_alarm, missed_detection,
                               speaker_confusion, speech_total) -> None:
        """Accumulate components computed elsewhere (a validation step's);
        tensors stay on their device."""
        self.false_alarm = self.false_alarm + _squeeze(false_alarm)
        self.missed_detection = self.missed_detection \
            + _squeeze(missed_detection)
        self.speaker_confusion = self.speaker_confusion \
            + _squeeze(speaker_confusion)
        self.speech_total = self.speech_total + _squeeze(speech_total)

    @staticmethod
    def _from_components(false_alarm, missed_detection, speaker_confusion,
                         speech_total) -> float:
        raise NotImplementedError

    def compute(self) -> float:
        return self._from_components(*_floats(
            self.false_alarm, self.missed_detection,
            self.speaker_confusion, self.speech_total))

    def __call__(self, preds, target) -> float:
        """Accumulate; returns the batch's own value."""
        return self._from_components(*_floats(*self.update(preds, target)))


def _squeeze(x):
    return x.reshape(()) if isinstance(x, torch.Tensor) and x.numel() == 1 \
        else x


def _floats(*values):
    return tuple(float(v) for v in values)


class DiarizationErrorRate(_StreamingMetric):
    @staticmethod
    def _from_components(fa, miss, conf, total) -> float:
        return (fa + miss + conf) / max(total, 1e-8)


class SegmentationErrorRate(DiarizationErrorRate):
    """Local DER over sliding windows of ``window_size`` frames,
    ``step_size`` apart (half a window by default): each window is its
    own batch item, so confusion is judged per window; incomplete tail
    windows are dropped (``unfold``). preds / target are (batch, frames,
    speakers). Windows go through in batches of ``windows_per_chunk``."""

    windows_per_chunk = 256

    def __init__(self, window_size: int, step_size: Optional[int] = None,
                 threshold: float = 0.5):
        super().__init__(threshold=threshold)
        self.window_size = window_size
        self.step_size = step_size or window_size // 2

    def update(self, preds, target):
        preds = torch.as_tensor(preds, dtype=torch.float32)
        target = torch.as_tensor(target, dtype=torch.float32,
                                 device=preds.device)
        if preds.shape[1] <= self.window_size:
            return super().update(preds, target)
        starts = list(range(0, preds.shape[1] - self.window_size + 1,
                            self.step_size))
        win, chunk = self.window_size, self.windows_per_chunk
        totals = None
        for i in range(0, len(starts), chunk):
            sub = starts[i:i + chunk]
            parts = super().update(
                torch.cat([preds[:, s:s + win] for s in sub]),
                torch.cat([target[:, s:s + win] for s in sub]))
            parts = torch.stack([p.reshape(()) for p in parts])
            totals = parts if totals is None else totals + parts
        return tuple(totals)


class FalseAlarmRate(_StreamingMetric):
    @staticmethod
    def _from_components(fa, miss, conf, total) -> float:
        return fa / max(total, 1e-8)


class MissedDetectionRate(_StreamingMetric):
    @staticmethod
    def _from_components(fa, miss, conf, total) -> float:
        return miss / max(total, 1e-8)


class SpeakerConfusionRate(_StreamingMetric):
    @staticmethod
    def _from_components(fa, miss, conf, total) -> float:
        return conf / max(total, 1e-8)


class DetectionErrorRate(_StreamingMetric):
    @staticmethod
    def _from_components(fa, miss, conf, total) -> float:
        return (fa + miss) / max(total, 1e-8)


class DiarizationPrecision(_StreamingMetric):
    @staticmethod
    def _from_components(fa, miss, conf, total) -> float:
        detected = total - miss + fa
        correct = total - miss - conf
        return correct / max(detected, 1e-8)


class DiarizationRecall(_StreamingMetric):
    @staticmethod
    def _from_components(fa, miss, conf, total) -> float:
        correct = total - miss - conf
        return correct / max(total, 1e-8)


class OptimalDiarizationErrorRate(_StreamingMetric):
    """DER at the best global threshold of a sweep (51 by default): the
    whole sweep is one components pass per batch, with (T,) states."""

    def __init__(self, thresholds: Optional[np.ndarray] = None):
        self.thresholds = DEFAULT_THRESHOLDS if thresholds is None \
            else np.asarray(thresholds)
        self.reset()

    def update(self, preds, target):
        components = unpack_der_components(
            der_components(preds, target, self.thresholds),
            len(self.thresholds))
        self.update_from_components(*components)
        return components

    def _host(self, fa, miss, conf, total):
        return (*(np.broadcast_to(np.asarray(
            x.cpu() if isinstance(x, torch.Tensor) else x, np.float64),
            self.thresholds.shape) for x in (fa, miss, conf)),
            float(total))

    @staticmethod
    def _ders(fa, miss, conf, total) -> np.ndarray:
        """Per-threshold DER."""
        return (fa + miss + conf) / max(total, 1e-8)

    @classmethod
    def _optimal_index(cls, fa, miss, conf, total) -> int:
        return int(np.argmin(cls._ders(fa, miss, conf, total)))

    def _value(self, fa, miss, conf, total) -> float:
        return float(np.min(self._ders(fa, miss, conf, total)))

    def compute(self) -> float:
        return self._value(*self._host(
            self.false_alarm, self.missed_detection,
            self.speaker_confusion, self.speech_total))

    def __call__(self, preds, target) -> float:
        return self._value(*self._host(*self.update(preds, target)))

    @property
    def optimal_threshold(self) -> float:
        return float(self.thresholds[self._optimal_index(*self._host(
            self.false_alarm, self.missed_detection,
            self.speaker_confusion, self.speech_total))])


class OptimalDiarizationErrorRateThreshold(OptimalDiarizationErrorRate):
    """The DER-optimal threshold itself."""

    def _value(self, fa, miss, conf, total) -> float:
        return float(self.thresholds[
            self._optimal_index(fa, miss, conf, total)])


class _OptimalComponent(OptimalDiarizationErrorRate):
    """One DER component, as a rate, at the DER-optimal threshold."""

    _component = 0        # 0 false alarm, 1 missed detection, 2 confusion

    def _value(self, fa, miss, conf, total) -> float:
        i = self._optimal_index(fa, miss, conf, total)
        return float((fa, miss, conf)[self._component][i]) \
            / max(total, 1e-8)


class OptimalFalseAlarmRate(_OptimalComponent):
    _component = 0


class OptimalMissedDetectionRate(_OptimalComponent):
    _component = 1


class OptimalSpeakerConfusionRate(_OptimalComponent):
    _component = 2


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
