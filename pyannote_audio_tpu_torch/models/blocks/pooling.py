"""Weighted temporal statistics pooling.

Counterpart of pyannote_audio_tpu/models/blocks/pooling.py: weighted mean
+ unbiased weighted standard deviation, with nearest-neighbour
interpolation of the weights to the frame axis and an optional speaker
axis, so a (batch, speakers, frames) weight tensor pools every speaker of
every chunk at once. ``StatsPool`` is the module the reference's models
hold.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn


def interpolate_weights(weights: torch.Tensor,
                        num_frames: int) -> torch.Tensor:
    """Nearest-neighbour interpolation of (..., w_frames) to num_frames
    (torch F.interpolate(mode="nearest") indexing)."""
    w_frames = weights.shape[-1]
    if w_frames == num_frames:
        return weights
    idx = (torch.arange(num_frames, device=weights.device) * w_frames) \
        // num_frames
    return weights[..., idx]


def stats_pool(sequences: torch.Tensor,
               weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(batch, features, frames) -> (batch, [speakers,] 2*features).

    ``weights`` is (batch, frames') or (batch, speakers, frames').
    """
    b, f, t = sequences.shape
    if weights is None:
        mean = sequences.mean(dim=-1)
        var = (sequences - mean[..., None]).square().sum(dim=-1) \
            / max(t - 1, 1)
        return torch.cat([mean, var.sqrt()], dim=-1)

    has_speakers = weights.dim() == 3
    if not has_speakers:
        weights = weights[:, None, :]
    weights = interpolate_weights(weights, t)               # (b, s, t)
    v1 = weights.sum(dim=-1) + 1e-8                         # (b, s)
    v2 = weights.square().sum(dim=-1)
    wsum = torch.einsum("bst,bft->bsf", weights, sequences)
    mean = wsum / v1[..., None]
    # sum_w (x-m)^2 == sum_w x^2 - v1*m^2: no (b, s, f, t) intermediate
    wsq = torch.einsum("bst,bft->bsf", weights, sequences.square())
    var = (wsq - v1[..., None] * mean.square()) \
        / (v1 - v2 / v1 + 1e-8)[..., None]
    out = torch.cat([mean, torch.clamp(var, min=0.0).sqrt()], dim=-1)
    return out if has_speakers else out[:, 0]


class StatsPool(nn.Module):
    """``stats_pool`` as a module: (batch, features, frames) and optional
    (batch, [speakers,] frames') weights -> (batch, [speakers,]
    2 * features)."""

    def forward(self, sequences: torch.Tensor,
                weights: Optional[torch.Tensor] = None) -> torch.Tensor:
        return stats_pool(sequences, weights=weights)
