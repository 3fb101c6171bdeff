"""Powerset -> multilabel decoding.

Counterpart of pyannote_audio_tpu/ops/powerset.py (``build_powerset_mapping``
and ``Powerset.to_multilabel``): the codec is a constant
(num_powerset_classes, num_classes) 0/1 matrix.
"""

from __future__ import annotations

import itertools

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

    def to_multilabel(self, powerset: torch.Tensor,
                      soft: bool = False) -> torch.Tensor:
        """(..., K_powerset) log-probs -> (..., K) multilabel scores.

        hard: argmax (first maximum on ties) then lookup, exact 0/1.
        soft: exp(log-probs) @ mapping, the marginal probability per class.
        """
        mapping = self._mapping_on.get(powerset.device)
        if mapping is None:
            mapping = self.mapping
            if powerset.device.type == "cuda":
                mapping = mapping.pin_memory().to(powerset.device,
                                                  non_blocking=True)
            self._mapping_on[powerset.device] = mapping
        if soft:
            return torch.exp(powerset) @ mapping
        return mapping[torch.argmax(powerset, dim=-1)]
