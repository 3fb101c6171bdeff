"""Diarization post-processing on the device that holds the scores.

Counterpart of pyannote_audio_tpu/ops/diarize_fused.py: the speaker count
and per-(chunk, speaker) activity statistics in one pass, the embedding
pooling masks, and the count-constrained reconstruction (normal and
exclusive variants together). NaN semantics are kept exactly: the
statistics propagate NaN, overlap-add treats NaN as missing. The chunk
axis is exact here (the JAX version pads it to a bucket for XLA's static
shapes), and reconstruction returns plain boolean matrices (the JAX
version bit-packs them for its host link).
"""

from __future__ import annotations

from typing import Tuple

import torch

from .aggregate import overlap_add


def fused_count_stats(scores: torch.Tensor, frame_offsets: torch.Tensor,
                      num_output_frames: int
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(C, F, S) binarized scores -> (count, speaker_frames, clean_frames).

    count:          (num_output_frames, 1) uint8, the rint-rounded average
                    number of active speakers per output frame (NaN -> 0).
    speaker_frames: (C, S) active frames per local speaker.
    clean_frames:   (C, S) frames where the speaker is active alone.
    """
    speaker_frames = scores.sum(dim=1)
    alone = scores.sum(dim=2, keepdim=True) == 1.0       # NaN -> False
    clean_frames = (scores * alone).sum(dim=1)
    summed = scores.sum(dim=-1, keepdim=True)             # NaN-propagating
    ones = scores.new_ones(scores.shape[1])
    out_sum, out_w = overlap_add(summed, frame_offsets, ones,
                                 num_output_frames)
    average = out_sum / torch.clamp(out_w, min=1e-12)
    count = torch.round(torch.where(out_w > 0, average,
                                    torch.zeros_like(average)))
    count = torch.nan_to_num(count).clamp(0, 255).to(torch.uint8)
    return count, speaker_frames, clean_frames


def make_embedding_masks(scores: torch.Tensor, exclude_overlap: bool,
                         min_num_frames: int) -> torch.Tensor:
    """(C, F, S) binarized scores -> (C, S, F) pooling masks.

    The overlap-free mask is computed on the raw scores first (a NaN frame
    is never clean) and used only where it keeps more than
    ``min_num_frames`` frames; NaN -> 0 afterwards.
    """
    if exclude_overlap:
        alone = scores.sum(dim=2, keepdim=True) < 2       # NaN -> False
        clean = torch.nan_to_num(scores * alone, nan=0.0)
        enough = clean.sum(dim=1, keepdim=True) > min_num_frames
        masks = torch.where(enough, clean,
                            torch.nan_to_num(scores, nan=0.0))
    else:
        masks = torch.nan_to_num(scores, nan=0.0)
    return masks.transpose(1, 2)


def fused_reconstruct(scores: torch.Tensor, hard_clusters: torch.Tensor,
                      frame_offsets: torch.Tensor, count: torch.Tensor,
                      num_clusters: int, num_output_frames: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cluster-max + overlap-add + keep-top-count binarization.

    scores (C, F, S); hard_clusters (C, S) int, negative = discarded;
    count (num_output_frames,) int. Returns (binary, exclusive_binary),
    each a (num_output_frames, num_clusters) bool matrix: a cluster is
    active iff its rank (0 = loudest, ties by cluster index) is below the
    count, or below min(count, 1) for the exclusive variant.
    """
    # filled on the device: a host scalar's copy would make the host wait
    # for all the work queued ahead of the reconstruction
    neg_inf = scores.new_full((), float("-inf"))
    data = torch.nan_to_num(scores, nan=float("-inf"))
    member = hard_clusters[:, None, :, None] == torch.arange(
        num_clusters, device=scores.device)                  # (C, 1, S, K)
    best = torch.where(member, data[..., None], neg_inf).amax(dim=2)
    # NaN member scores poison the cluster max
    any_nan = (member & torch.isnan(scores)[..., None]).any(dim=2)
    clustered = torch.where(torch.isfinite(best) & ~any_nan, best,
                            torch.full_like(best, float("nan")))
    ones = scores.new_ones(scores.shape[1])
    out_sum, out_w = overlap_add(clustered, frame_offsets, ones,
                                 num_output_frames)
    act = torch.where(out_w > 0, out_sum, torch.zeros_like(out_sum))
    order = torch.argsort(-act, dim=-1, stable=True)
    ranks = torch.empty_like(order).scatter_(
        -1, order, torch.arange(num_clusters, device=act.device)
        .expand_as(order).contiguous())
    count = count.to(ranks.dtype)[:, None]
    return ranks < count, ranks < torch.clamp(count, max=1)
