"""Training losses.

Counterpart of pyannote_audio_tpu/ops/losses.py: the frame-weighted
binary cross-entropy, MSE and NLL of the reference's ``utils/loss.py`` and
the permutation-invariant powerset loss of the diarization task, which
takes the minimum over the K! multilabel permutations pre-lifted to
powerset index tables (``Powerset.all_permutation_mappings``): exact,
branch-free, with no host sync.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from .powerset import Powerset


def interpolate_weight(weight: torch.Tensor, num_frames: int
                       ) -> torch.Tensor:
    """Linearly interpolate (batch, frames', 1) weights to ``num_frames``:
    ``F.interpolate(mode="linear", align_corners=False)`` along frames."""
    if weight.shape[1] == num_frames:
        return weight
    return F.interpolate(weight.transpose(1, 2), size=num_frames,
                         mode="linear", align_corners=False).transpose(1, 2)


def interpolate(target: torch.Tensor,
                weight: Optional[torch.Tensor] = None
                ) -> Optional[torch.Tensor]:
    """The reference's signature: ``weight`` resampled to ``target``'s
    frame axis; None passes through."""
    if weight is None:
        return None
    return interpolate_weight(weight, target.shape[1])


def binary_cross_entropy(prediction: torch.Tensor, target: torch.Tensor,
                         weight: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """Frame-weighted BCE on probabilities (batch, frames, classes).

    The weighted sum is divided by ``numel`` (``mean(w * bce)``, torch's
    ``F.binary_cross_entropy(weight=w)``), not by ``sum(w)`` as the MSE
    and NLL below are: the asymmetry is the reference's.
    """
    if target.dim() == 2:
        target = target[..., None]
    eps = 1e-7
    p = torch.clamp(prediction, eps, 1.0 - eps)
    loss = -(target * torch.log(p) + (1.0 - target) * torch.log1p(-p))
    if weight is None:
        return loss.mean()
    return (loss * interpolate_weight(weight, prediction.shape[1])).mean()


def mse_loss(prediction: torch.Tensor, target: torch.Tensor,
             weight: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Frame-weighted MSE: ``sum(loss * w) / (sum(w) * num_classes)``."""
    if target.dim() == 2:
        target = target[..., None]
    loss = (prediction - target).square()
    if weight is None:
        return loss.mean()
    w = interpolate_weight(weight, prediction.shape[1])
    return (loss * w).sum() / (w.sum() * loss.shape[-1] + 1e-8)


def nll_loss(prediction: torch.Tensor, target: torch.Tensor,
             class_weight: Optional[torch.Tensor] = None,
             weight: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Negative log-likelihood of (batch, frames, classes) log-probs at
    (batch, frames) class indices. ``class_weight`` (classes,) scales each
    frame's loss by its target class's weight; ``weight`` (batch, frames,
    1) weighs frames: unweighted, the mean of the class-weighted losses;
    frame-weighted, ``sum(loss * w) / sum(w)`` (the class weight never
    enters the denominator)."""
    target = target.long()
    loss = -prediction.gather(-1, target[..., None])[..., 0]
    if class_weight is not None:
        loss = loss * class_weight.to(loss)[target]
    if weight is None:
        return loss.mean()
    w = interpolate_weight(weight, prediction.shape[1])[..., 0]
    return (loss * w).sum() / (w.sum() + 1e-8)


def powerset_pit_loss(
    log_probs: torch.Tensor,          # (batch, frames, K_powerset)
    multilabel_target: torch.Tensor,  # (batch, frames, K) binary
    powerset: Powerset,
    weight: Optional[torch.Tensor] = None,
    class_weight: Optional[torch.Tensor] = None,  # (K_powerset,)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Permutation-invariant powerset NLL; returns (loss, best permutation
    index per sample (batch,)).

    The NLL of every permutation of the target speakers is summed per
    sample and the smallest kept (the first on ties), as ``nll_loss``
    applied to the best permutation's targets: frame-weighted, the global
    ``sum(cw * nll * fw) / sum(fw)``; unweighted, the global mean of
    ``cw * nll``. The per-sample denominator does not depend on the
    permutation, so the per-sample argmin is exact.
    """
    tables = powerset.all_permutation_mappings().to(log_probs.device)
    target_idx = torch.argmax(powerset.to_powerset(multilabel_target),
                              dim=-1)                          # (B, F)
    permuted = tables[:, target_idx]                           # (P, B, F)
    nll = -log_probs[None].expand(len(tables), -1, -1, -1).gather(
        -1, permuted[..., None])[..., 0]                       # (P, B, F)
    if class_weight is not None:
        nll = nll * class_weight.to(nll)[permuted]
    if weight is not None:
        fw = interpolate_weight(weight, log_probs.shape[1])[..., 0]
        per_perm = (nll * fw[None]).sum(dim=-1)                 # (P, B)
        denom = fw.sum() + 1e-8
    else:
        per_perm = nll.sum(dim=-1)
        denom = float(nll.shape[1] * nll.shape[2])
    best = torch.argmin(per_perm, dim=0)
    return per_perm.min(dim=0).values.sum() / denom, best
