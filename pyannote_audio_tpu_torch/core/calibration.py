"""Isotonic-regression calibration of raw scores into probabilities.

Counterpart of pyannote_audio_tpu/core/calibration.py, whose
``Calibration`` subclasses scikit-learn's ``IsotonicRegression`` and saves
through ``safetensors``. The card machine has neither, so this class fits
the same function with numpy alone, step for step as scikit-learn 1.9
does:

- ``increasing="auto"`` takes the sign of Spearman's rho (scikit-learn's
  ``check_increasing``, with its warning when the 95 % interval of rho
  spans 0);
- points are sorted by (X, y) and duplicate X merged into their weighted
  mean y (``_make_unique``: X within float64 resolution of a group's
  first X joins it);
- pool adjacent violators on the merged points, then ``y_min`` /
  ``y_max`` clip the fit;
- of each flat run only its two ends are kept as thresholds
  (``_build_y``'s trimming);
- ``transform`` clips X to the fitted range (scikit-learn's
  ``out_of_bounds="clip"``, the JAX package's default and the only mode
  here) and interpolates linearly.

Breakpoints are stored in the same safetensors layout as the JAX
package's (``utils/safetensors.py``), so each package reads the other's
files.
"""

from __future__ import annotations

import math
import warnings
from pathlib import Path
from typing import Optional, Union

import numpy as np

from ..utils.safetensors import load_file, save_file

CALIBRATION_FILE = "calibration.safetensors"


def _average_ranks(x: np.ndarray) -> np.ndarray:
    """1-based ranks of ``x``, ties taking their mean rank."""
    order = np.argsort(x, kind="mergesort")
    sorted_x = x[order]
    starts = np.flatnonzero(np.r_[True, sorted_x[1:] != sorted_x[:-1]])
    ends = np.r_[starts[1:], len(x)]
    ranks = np.empty(len(x))
    ranks[order] = np.repeat((starts + ends + 1) / 2.0, ends - starts)
    return ranks


def check_increasing(x: np.ndarray, y: np.ndarray) -> bool:
    """Is ``y`` increasing with ``x``, by the sign of Spearman's rho?"""
    rx, ry = _average_ranks(x), _average_ranks(y)
    rx, ry = rx - rx.mean(), ry - ry.mean()
    rho = float(np.dot(rx, ry) / math.sqrt(np.dot(rx, rx) * np.dot(ry, ry)))
    if rho not in (-1.0, 1.0) and len(x) > 3:
        F = 0.5 * math.log((1.0 + rho) / (1.0 - rho))
        F_se = 1 / math.sqrt(len(x) - 3)
        if np.sign(math.tanh(F - 1.96 * F_se)) != \
                np.sign(math.tanh(F + 1.96 * F_se)):
            warnings.warn("Confidence interval of the Spearman correlation "
                          "coefficient spans zero. Determination of "
                          "``increasing`` may be suspect.")
    return rho >= 0


def _make_unique(X: np.ndarray, y: np.ndarray, w: np.ndarray):
    """Merge runs of equal X (sorted) into one point each: the run's first
    X, its total weight and its weighted mean y."""
    eps = np.finfo(np.float64).resolution
    xs, ys, ws = [], [], []
    current_x, sum_wy, sum_w = X[0], 0.0, 0.0
    for x, yy, ww in zip(X, y, w):
        if x - current_x >= eps:
            xs.append(current_x)
            ws.append(sum_w)
            ys.append(sum_wy / sum_w)
            current_x, sum_w, sum_wy = x, ww, yy * ww
        else:
            sum_w += ww
            sum_wy += yy * ww
    xs.append(current_x)
    ws.append(sum_w)
    ys.append(sum_wy / sum_w)
    return np.array(xs), np.array(ys), np.array(ws)


def pool_adjacent_violators(y: np.ndarray, w: np.ndarray,
                            increasing: bool = True) -> np.ndarray:
    """The weighted least-squares non-decreasing (or non-increasing) fit
    of ``y``."""
    if not increasing:
        return pool_adjacent_violators(y[::-1], w[::-1])[::-1]
    means, weights, sizes = [], [], []
    for value, weight in zip(y.astype(np.float64), w.astype(np.float64)):
        means.append(value)
        weights.append(weight)
        sizes.append(1)
        while len(means) > 1 and means[-2] >= means[-1]:
            value, weight, size = means.pop(), weights.pop(), sizes.pop()
            total = weights[-1] + weight
            means[-1] = (weights[-1] * means[-1] + weight * value) / total
            weights[-1] = total
            sizes[-1] += size
    return np.repeat(means, sizes)


class Calibration:
    """Maps raw scores (for example cosine distances) to probabilities in
    [0, 1]: an isotonic fit, clipped to the fitted range."""

    def __init__(self, y_min: Optional[float] = 0.0,
                 y_max: Optional[float] = 1.0,
                 increasing: Union[bool, str] = "auto"):
        self.y_min = y_min
        self.y_max = y_max
        self.increasing = increasing

    @property
    def fitted(self) -> bool:
        return hasattr(self, "X_thresholds_")

    def fit(self, X, y, sample_weight=None) -> "Calibration":
        X = np.asarray(X, dtype=np.float64).reshape(-1)
        y = np.asarray(y, dtype=np.float64).reshape(-1)
        if len(X) != len(y) or len(X) == 0:
            raise ValueError("X and y must be non-empty and of one length")
        if not (np.isfinite(X).all() and np.isfinite(y).all()):
            raise ValueError("X and y must be finite")
        self.increasing_ = check_increasing(X, y) \
            if self.increasing == "auto" else bool(self.increasing)
        w = np.ones_like(X) if sample_weight is None else \
            np.asarray(sample_weight, dtype=np.float64).reshape(-1)
        keep = w > 0
        X, y, w = X[keep], y[keep], w[keep]
        order = np.lexsort((y, X))
        X, y, w = X[order], y[order], w[order]
        X, y, w = _make_unique(X, y, w)
        y = pool_adjacent_violators(y, w, self.increasing_)
        if self.y_min is not None or self.y_max is not None:
            y = np.clip(y, -np.inf if self.y_min is None else self.y_min,
                        np.inf if self.y_max is None else self.y_max)
        self.X_min_, self.X_max_ = float(X.min()), float(X.max())
        keep = np.ones(len(y), dtype=bool)
        keep[1:-1] = (y[1:-1] != y[:-2]) | (y[1:-1] != y[2:])
        self.X_thresholds_, self.y_thresholds_ = X[keep], y[keep]
        return self

    def transform(self, T) -> np.ndarray:
        """Calibrated values of a 1-d array of finite scores."""
        if not self.fitted:
            raise RuntimeError("Calibration is not fitted")
        T = np.clip(np.asarray(T, dtype=np.float64).reshape(-1),
                    self.X_min_, self.X_max_)
        if len(self.y_thresholds_) == 1:
            return np.repeat(self.y_thresholds_, T.shape)
        return np.interp(T, self.X_thresholds_, self.y_thresholds_)

    def safe_transform(self, scores) -> np.ndarray:
        """``transform`` of any shape, NaN kept where it is."""
        scores = np.asarray(scores, dtype=float)
        flat = scores.reshape(-1)
        valid = ~np.isnan(flat)
        out = np.full_like(flat, np.nan)
        if valid.any():
            out[valid] = self.transform(flat[valid])
        return out.reshape(scores.shape)

    # -- serialization ----------------------------------------------------

    def save(self, path: Union[str, Path]) -> None:
        if not self.fitted:
            raise RuntimeError("cannot save an unfitted Calibration")
        save_file({
            "X_thresholds": np.asarray(self.X_thresholds_, dtype=np.float64),
            "y_thresholds": np.asarray(self.y_thresholds_, dtype=np.float64),
            "increasing": np.asarray([1.0 if self.increasing_ else 0.0]),
            "X_min_max": np.asarray([self.X_min_, self.X_max_]),
        }, path)

    @classmethod
    def from_file(cls, path: Union[str, Path]) -> "Calibration":
        """Refit on the stored breakpoints (an isotonic fit of an
        isotonic sequence is that sequence), as the JAX package does."""
        data = load_file(path)
        calibration = cls()
        calibration.increasing = bool(data["increasing"][0])
        return calibration.fit(data["X_thresholds"], data["y_thresholds"])

    @classmethod
    def from_pretrained(cls, checkpoint: Union[str, Path],
                        subfolder: Optional[str] = None,
                        revision: Optional[str] = None,
                        token: Optional[str] = None,
                        cache_dir=None) -> "Calibration":
        """Load ``calibration.safetensors`` from a local file or directory
        (``/subfolder``), or from a hub id (``utils/hf_hub.py``)."""
        from ..utils.hf_hub import hub_asset
        found = hub_asset(checkpoint, CALIBRATION_FILE, subfolder=subfolder,
                          revision=revision, token=token,
                          cache_dir=cache_dir)
        if found is not None:
            return cls.from_file(found)
        path = Path(checkpoint)
        if subfolder:
            path = path / subfolder
        if path.is_dir():
            path = path / CALIBRATION_FILE
        if not path.is_file():
            raise ValueError(
                f"{checkpoint} (subfolder {subfolder!r}) holds no "
                f"{CALIBRATION_FILE}, locally or as a hub id")
        return cls.from_file(path)
