"""Streaming AUROC for frame-level validation.

Counterpart of pyannote_audio_tpu/metrics/auroc.py: per class, two score
histograms (positives, negatives) whose sums merge across batches; the
macro-average AUROC is the trapezoidal ROC integral over the bins. The
segmentation tasks' ``default_metric`` and ``Trainer.validate``'s
``auroc/val`` for VAD and multi-label tasks. Under data parallelism
``sync(group)`` sums the histograms over the ranks.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist


class BinnedAUROC:
    """AUROC from score histograms (scores in [0, 1])."""

    def __init__(self, num_bins: int = 512):
        self.num_bins = num_bins
        self.reset()

    def reset(self):
        self._pos: Optional[np.ndarray] = None
        self._neg: Optional[np.ndarray] = None

    def update(self, scores, targets):
        """scores (..., classes) in [0,1]; targets binary, same shape."""
        scores = np.asarray(scores, dtype=float)
        targets = np.asarray(targets) > 0.5
        num_classes = scores.shape[-1]
        if self._pos is None:
            self._pos = np.zeros((num_classes, self.num_bins))
            self._neg = np.zeros((num_classes, self.num_bins))
        elif num_classes != self._pos.shape[0]:
            raise ValueError(
                f"class-count mismatch: first update had "
                f"{self._pos.shape[0]} classes, this one {num_classes}"
                " — reset() between differently-shaped evaluations")
        bins = np.clip((scores * self.num_bins).astype(int), 0,
                       self.num_bins - 1)
        for k in range(num_classes):
            b = bins[..., k].reshape(-1)
            t = targets[..., k].reshape(-1)
            self._pos[k] += np.bincount(b[t], minlength=self.num_bins)
            self._neg[k] += np.bincount(b[~t], minlength=self.num_bins)

    def sync(self, group: Optional[Any] = None) -> None:
        """Sum the histograms over the ranks of ``group`` (the default
        group when None), so that every rank computes the global AUROC.
        Every rank must call it, once after its last update (a rank with
        none contributes zeros); without an initialised group it does
        nothing."""
        if not (dist.is_available() and dist.is_initialized()):
            return
        from ..parallel.mesh import collective_device
        device = collective_device(group)
        # agree on the class count first: a rank may have seen no batch
        classes = torch.tensor(
            0 if self._pos is None else self._pos.shape[0], device=device)
        dist.all_reduce(classes, op=dist.ReduceOp.MAX, group=group)
        num_classes = int(classes)
        if num_classes == 0:
            return
        if self._pos is None:
            self._pos = np.zeros((num_classes, self.num_bins))
            self._neg = np.zeros((num_classes, self.num_bins))
        both = torch.from_numpy(np.stack([self._pos, self._neg])).to(device)
        dist.all_reduce(both, group=group)
        self._pos, self._neg = both.cpu().numpy()

    def compute(self) -> float:
        """Macro-average AUROC via the trapezoidal ROC integral."""
        if self._pos is None:
            return float("nan")
        aurocs = []
        for pos, neg in zip(self._pos, self._neg):
            p_total, n_total = pos.sum(), neg.sum()
            if p_total == 0 or n_total == 0:
                continue
            # descending-threshold cumulative rates
            tpr = np.concatenate([[0.0], np.cumsum(pos[::-1]) / p_total])
            fpr = np.concatenate([[0.0], np.cumsum(neg[::-1]) / n_total])
            trapezoid = getattr(np, "trapezoid", None) or np.trapz
            aurocs.append(trapezoid(tpr, fpr))
        return float(np.mean(aurocs)) if aurocs else float("nan")

    def __call__(self, scores, targets) -> float:
        self.update(scores, targets)
        return self.compute()
