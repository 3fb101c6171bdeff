"""Sliding-window overlap-add aggregation.

Counterpart of ``overlap_add`` in pyannote_audio_tpu/ops/aggregate.py: a
scatter-add of per-chunk frame scores onto the output frame grid, at
per-chunk frame offsets (they vary by +-1 frame with closest-frame
rounding, so they are data). The port runs on exact (unpadded) chunk
counts, so there is no chunk mask.
"""

from __future__ import annotations

from typing import Tuple

import torch


def overlap_add(scores: torch.Tensor, frame_offsets: torch.Tensor,
                window_weights: torch.Tensor, num_output_frames: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Weighted overlap-add of (num_chunks, frames_per_chunk, C) scores.

    Returns (weighted_sum, weight_sum), each (num_output_frames, C). NaN
    scores count as missing (weight zero); frames landing outside the
    output grid are dropped.
    """
    num_chunks, frames, C = scores.shape
    valid = ~torch.isnan(scores)
    w = torch.where(valid, window_weights[None, :, None],
                    torch.zeros((), dtype=scores.dtype, device=scores.device))
    x = torch.where(valid, scores, torch.zeros_like(scores)) * w
    idx = (frame_offsets.to(torch.int64)[:, None]
           + torch.arange(frames, device=scores.device)[None]).reshape(-1)
    # frames outside the grid add zeros at a clamped index (a boolean
    # mask would make the host wait for the device to count them)
    keep = ((idx >= 0) & (idx < num_output_frames))[:, None]
    idx = idx.clamp(0, max(num_output_frames - 1, 0))
    x = torch.where(keep, x.reshape(-1, C), torch.zeros((), dtype=x.dtype,
                                                       device=x.device))
    w = torch.where(keep, w.reshape(-1, C), torch.zeros((), dtype=w.dtype,
                                                       device=w.device))
    out_sum = scores.new_zeros((num_output_frames, C)).index_add_(0, idx, x)
    out_w = scores.new_zeros((num_output_frames, C)).index_add_(0, idx, w)
    return out_sum, out_w
