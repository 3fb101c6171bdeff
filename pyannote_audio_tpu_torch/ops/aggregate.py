"""Sliding-window overlap-add aggregation.

Counterpart of pyannote_audio_tpu/ops/aggregate.py: ``overlap_add``, a
scatter-add of per-chunk frame scores onto the output frame grid at
per-chunk frame offsets (they vary by +-1 frame with closest-frame
rounding, so they are data); the hamming and warm-up window weights; and
``aggregate_scores``, the weighted average with ``missing`` for uncovered
frames and the 1e-12-floored divisor. The port runs on exact (unpadded)
chunk and frame counts, so there is no chunk mask: the JAX package's
shape buckets and the padding chunks they mask exist only for XLA's
recompiles. float32 ``index_add_`` sums in another order on a CUDA device
than on the CPU.
"""

from __future__ import annotations

import math
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


def hamming_weights(num_frames: int, device=None,
                    dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Symmetric hamming window (torch.hamming_window periodic=False)."""
    if num_frames == 1:
        return torch.ones((1,), dtype=dtype, device=device)
    n = torch.arange(num_frames, dtype=dtype, device=device)
    return 0.54 - 0.46 * torch.cos(2.0 * math.pi * n / (num_frames - 1))


def warmup_weights(num_frames: int, warm_up: Tuple[float, float],
                   device=None, dtype: torch.dtype = torch.float32
                   ) -> torch.Tensor:
    """1e-12 on the warm-up frames at each end (``warm_up`` as ratios of
    the chunk), 1 elsewhere."""
    w = torch.ones((num_frames,), dtype=dtype, device=device)
    left = round(warm_up[0] * num_frames)
    right = round(warm_up[1] * num_frames)
    if left > 0:
        w[:left] = 1e-12
    if right > 0:
        w[-right:] = 1e-12
    return w


def aggregate_scores(scores: torch.Tensor, frame_offsets: torch.Tensor,
                     num_output_frames: int,
                     hamming: bool = False,
                     warm_up: Tuple[float, float] = (0.0, 0.0),
                     missing: float = float("nan"),
                     skip_average: bool = False) -> torch.Tensor:
    """Weights -> ``overlap_add`` -> average (or the plain weighted sum
    with ``skip_average``); frames that no chunk covers get ``missing``.

    The divisor is floored at 1e-12: frames covered only by warm-up
    regions are attenuated toward 0 rather than averaged, as in the JAX
    package.
    """
    frames = scores.shape[1]
    device = scores.device
    w = hamming_weights(frames, device, scores.dtype) if hamming \
        else torch.ones((frames,), dtype=scores.dtype, device=device)
    w = w * warmup_weights(frames, warm_up, device, scores.dtype)
    out_sum, out_w = overlap_add(scores, frame_offsets, w,
                                 num_output_frames)
    average = out_sum if skip_average \
        else out_sum / torch.clamp(out_w, min=1e-12)
    return torch.where(out_w > 0, average,
                       torch.full((), missing, dtype=average.dtype,
                                  device=device))
