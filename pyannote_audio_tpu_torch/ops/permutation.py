"""Optimal speaker-permutation alignment, on the host and on the device.

Counterpart of pyannote_audio_tpu/ops/permutation.py. The host
``permutate`` (with ``permutation_table`` and the mse / mae costs): for up
to 6 speakers on both sides every permutation is scored and the cheapest
kept (first on ties, in ``itertools.permutations`` order); otherwise, or
for a callable cost or unequal speaker counts, scipy's Hungarian solver
assigns them. Costs are float32 means, as in the JAX package. Oracle
clustering uses it. ``permutate_device`` is ``permutate_jax``: the same
search over the K! permutations on device tensors, with no host sync,
differentiable through its gather (the PIT losses use it).
"""

from __future__ import annotations

import itertools
from functools import lru_cache
from typing import List, Optional, Tuple

import numpy as np
import torch
from scipy.optimize import linear_sum_assignment


@lru_cache(maxsize=None)
def permutation_table(k: int) -> np.ndarray:
    """(k!, k) array of all permutations of range(k)."""
    return np.asarray(list(itertools.permutations(range(k))), dtype=np.int32)


def pairwise_cost(y1: np.ndarray, y2: np.ndarray, cost: str = "mse"
                  ) -> np.ndarray:
    """(B, F, K1) x (B, F, K2) -> (B, K1, K2) mean frame-wise cost."""
    d = y1[:, :, :, None] - y2[:, :, None, :]
    if cost == "mse":
        return np.mean(np.square(d), axis=1, dtype=np.float32)
    if cost == "mae":
        return np.mean(np.abs(d), axis=1, dtype=np.float32)
    raise ValueError(f"unknown cost {cost!r}")


def mse_cost_func(Y, y, **kwargs) -> np.ndarray:
    """Class-wise mean-squared error, (frames, classes) -> (classes,)."""
    return np.mean(np.square(np.asarray(Y) - np.asarray(y)), axis=0)


def mae_cost_func(Y, y, **kwargs) -> np.ndarray:
    """Class-wise mean absolute error, (frames, classes) -> (classes,)."""
    return np.mean(np.abs(np.asarray(Y) - np.asarray(y)), axis=0)


def _resolve_cost(cost_func) -> Tuple[Optional[str], Optional[object]]:
    """A cost_func as a builtin name or a callable."""
    if cost_func is None or cost_func == "mse" or cost_func is mse_cost_func:
        return "mse", None
    if cost_func == "mae" or cost_func is mae_cost_func:
        return "mae", None
    if callable(cost_func):
        return None, cost_func
    raise ValueError(f"unknown cost_func {cost_func!r}")


def _callable_cost_matrix(y1: np.ndarray, y2: np.ndarray,
                          cost_func) -> np.ndarray:
    """(B, K1, K2) cost through a callable with (frames, classes) ->
    (classes,) semantics, called as ``cost_func(y2, y1_column)``."""
    B, _, K1 = y1.shape
    K2 = y2.shape[-1]
    C = np.zeros((B, K1, K2), dtype=np.float32)
    for b in range(B):
        for i in range(K1):
            column = np.repeat(y1[b, :, i:i + 1], K2, axis=1)
            C[b, i] = np.asarray(cost_func(y2[b], column))
    return C


def permutate(y1: np.ndarray, y2: np.ndarray, cost_func=None,
              return_cost: bool = False):
    """Align ``y2``'s speakers to ``y1``'s, batch item by batch item.

    (B, F, K1) or (F, K1) target, (B, F, K2) or (F, K2) input ->
    (permutated y2 (.., F, K1), one tuple per item mapping each y1 speaker
    to its y2 speaker or None[, the (B, K1, K2) cost]). With more y2 than
    y1 speakers the cost matrix is padded to square with ``max + 1`` rows;
    with fewer, unmatched y1 speakers map to None and zero columns.
    """
    y1 = np.asarray(y1, dtype=np.float32)
    y2 = np.asarray(y2, dtype=np.float32)
    squeeze = y1.ndim == 2
    if squeeze:
        y1 = y1[None]
    if y2.ndim == 2:
        y2 = np.broadcast_to(y2[None], (y1.shape[0],) + y2.shape)

    B, _, K1 = y1.shape
    K2 = y2.shape[-1]
    cost_name, cost_callable = _resolve_cost(cost_func)
    if cost_callable is not None:
        C = _callable_cost_matrix(y1, y2, cost_callable)
    else:
        C = pairwise_cost(y1, y2, cost=cost_name)

    perms: List[Tuple[Optional[int], ...]]
    if K1 == K2 and K1 <= 6 and cost_callable is None:
        table = permutation_table(K1)                        # (K!, K)
        totals = C[:, np.arange(K1)[None, :], table].sum(axis=-1)
        best = table[np.argmin(totals, axis=-1)]              # (B, K)
        permutated = np.take_along_axis(y2, best[:, None, :], axis=-1)
        perms = [tuple(int(p) for p in row) for row in best]
    else:
        permutated = np.zeros((B, y1.shape[1], K1), dtype=y2.dtype)
        perms = []
        for b in range(B):
            cost = C[b]
            if K2 > K1:
                pad = np.full((K2 - K1, K2), cost.max() + 1.0,
                              dtype=cost.dtype)
                cost = np.concatenate([cost, pad], axis=0)
            rows, cols = linear_sum_assignment(cost)
            permutation: List[Optional[int]] = [None] * K1
            for r, c in zip(rows, cols):
                if r < K1:
                    permutation[r] = int(c)
                    permutated[b, :, r] = y2[b][:, c]
            perms.append(tuple(permutation))

    if squeeze:
        permutated = permutated[0]
    if return_cost:
        return permutated, perms, C
    return permutated, perms


def permutate_device(y1: torch.Tensor, y2: torch.Tensor, cost: str = "mse"
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Align ``y2``'s speakers to ``y1``'s per batch item, on their
    device: (B, F, K) each -> (permutated y2, perm (B, K)) with
    ``permutated[b, :, k] = y2[b, :, perm[b, k]]``. The cost is
    ``pairwise_cost``'s (float32 frame means); the argmin takes the first
    of tied permutations, and the gradient flows through the gather
    only."""
    with torch.no_grad():
        d = y1.float()[:, :, :, None] - y2.float()[:, :, None, :]
        if cost == "mse":
            C = d.square().mean(1)
        elif cost == "mae":
            C = d.abs().mean(1)
        else:
            raise ValueError(f"unknown cost {cost!r}")
    return _permutate_from_cost(y2, C)


def _permutate_from_cost(y2: torch.Tensor, C: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The least of the K! permutations' total costs, given the (B, K, K)
    cost ``C``, applied to ``y2``."""
    K = y2.shape[-1]
    perms = torch.as_tensor(permutation_table(K), dtype=torch.long,
                            device=y2.device)                   # (K!, K)
    totals = C[:, torch.arange(K, device=y2.device)[None, :],
               perms].sum(-1)                                    # (B, K!)
    perm = perms[torch.argmin(totals, dim=-1)]                   # (B, K)
    permutated = y2.gather(-1, perm[:, None, :].expand(-1, y2.shape[1], -1))
    return permutated, perm
