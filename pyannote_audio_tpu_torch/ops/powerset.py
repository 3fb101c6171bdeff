"""Powerset <-> multilabel codec.

Counterpart of pyannote_audio_tpu/ops/powerset.py: the codec is a constant
(num_powerset_classes, num_classes) 0/1 matrix. Decoding serves the
pipelines; ``to_powerset`` and the permutation tables serve the
permutation-invariant training loss (``ops.losses.powerset_pit_loss``).
"""

from __future__ import annotations

import itertools
from typing import Tuple

import numpy as np
import torch


def build_powerset_mapping(num_classes: int, max_set_size: int) -> np.ndarray:
    """(num_powerset_classes, num_classes) binary membership matrix.

    Rows ordered by set cardinality, then lexicographic combination order:
    row 0 = empty set, then singletons {0}, {1}, ..., then pairs {0,1}, ...
    """
    rows = []
    for size in range(max_set_size + 1):
        for combo in itertools.combinations(range(num_classes), size):
            row = np.zeros(num_classes, dtype=np.float32)
            row[list(combo)] = 1.0
            rows.append(row)
    return np.stack(rows, axis=0)


class Powerset:
    """Powerset codec holding its mapping matrix."""

    def __init__(self, num_classes: int, max_set_size: int):
        self.num_classes = num_classes
        self.max_set_size = max_set_size
        self.mapping = torch.from_numpy(
            build_powerset_mapping(num_classes, max_set_size))
        # one copy per device, so that decoding queues no host copy
        self._mapping_on = {}

    @property
    def num_powerset_classes(self) -> int:
        return int(self.mapping.shape[0])

    @property
    def cardinality(self) -> torch.Tensor:
        """Size of each powerset class, (num_powerset_classes,)."""
        return self.mapping.sum(dim=-1)

    @property
    def powerset_classes(self) -> list:
        """Each powerset class as the set of its multilabel classes."""
        return [set(np.flatnonzero(row).tolist())
                for row in self.mapping.numpy()]

    def _on(self, device: torch.device) -> torch.Tensor:
        """The mapping on ``device``, copied there once."""
        mapping = self._mapping_on.get(device)
        if mapping is None:
            mapping = self.mapping
            if device.type == "cuda":
                mapping = mapping.pin_memory().to(device, non_blocking=True)
            self._mapping_on[device] = mapping
        return mapping

    def to_multilabel(self, powerset: torch.Tensor,
                      soft: bool = False) -> torch.Tensor:
        """(..., K_powerset) log-probs -> (..., K) multilabel scores.

        hard: argmax (first maximum on ties) then lookup, exact 0/1.
        soft: exp(log-probs) @ mapping, the marginal probability per class.
        """
        mapping = self._on(powerset.device)
        if soft:
            return torch.exp(powerset) @ mapping
        return mapping[torch.argmax(powerset, dim=-1)]

    def to_powerset(self, multilabel: torch.Tensor) -> torch.Tensor:
        """(..., K) hard multilabel -> (..., K_powerset) one-hot:
        ``one_hot(argmax(multilabel @ mapping^T))``. With the classes
        ordered by cardinality this picks the matching class of any valid
        vector, and maps one with more than ``max_set_size`` active
        classes to its best-overlap subset ((1, 1, 1) -> {0, 1} for
        max_set_size 2), the first maximum on ties."""
        mapping = self._on(multilabel.device).to(multilabel.dtype)
        idx = torch.argmax(multilabel @ mapping.T, dim=-1)
        return torch.nn.functional.one_hot(
            idx, self.num_powerset_classes).to(multilabel.dtype)

    def permutation_mapping(self, perm: Tuple[int, ...]) -> torch.Tensor:
        """A multilabel class permutation lifted to powerset classes:
        ``perm_ps[j] = i`` where permuting the columns of class ``i`` by
        ``perm`` gives class ``j`` (for (1, 0, 2): [0, 2, 1, 3, 4, 6, 5]),
        so gathering ``scores[..., perm_ps]`` permutes powerset scores."""
        return torch.from_numpy(self._permutation_mapping_np(perm))

    def _permutation_mapping_np(self, perm: Tuple[int, ...]) -> np.ndarray:
        mapping = self.mapping.numpy()
        powers = 2 ** np.arange(self.num_classes, dtype=np.int64)
        before = (mapping @ powers).astype(np.int64)
        after = (mapping[:, list(perm)] @ powers).astype(np.int64)
        lookup = {c: i for i, c in enumerate(after)}
        return np.asarray([lookup[c] for c in before], dtype=np.int64)

    def all_permutation_mappings(self) -> torch.Tensor:
        """(K!, num_powerset_classes) tables of every multilabel class
        permutation, in ``itertools.permutations`` order; built once."""
        cached = getattr(self, "_all_perm_tables", None)
        if cached is None:
            cached = torch.from_numpy(np.stack([
                self._permutation_mapping_np(p)
                for p in itertools.permutations(range(self.num_classes))]))
            self._all_perm_tables = cached
        return cached
