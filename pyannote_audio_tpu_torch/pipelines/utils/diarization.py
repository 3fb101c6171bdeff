"""Shared diarization helpers.

Counterpart of pyannote_audio_tpu/pipelines/utils/diarization.py:
``set_num_speakers`` and ``SpeakerDiarizationMixin``'s
``optimal_mapping``, ``to_annotation`` and the host ``speaker_count``,
``to_diarization`` and ``reconstruct`` (numpy, as the JAX package computes them; the
diarization pipeline runs their fused device versions,
``ops/diarize_fused.py``, and the separation pipeline these).
"""

from __future__ import annotations

from typing import Mapping, Optional, Tuple, Union

import numpy as np

from ...core.annotation import Annotation
from ...core.inference import Inference
from ...core.segment import SlidingWindow, SlidingWindowFeature
from ...metrics.der import DiarizationErrorRate
from ...utils.signal import Binarize


def set_num_speakers(num_speakers: Optional[int] = None,
                     min_speakers: Optional[int] = None,
                     max_speakers: Optional[int] = None):
    """Resolve speaker-count constraints."""
    min_speakers = num_speakers or min_speakers or 1
    max_speakers = num_speakers or max_speakers or np.inf
    if min_speakers > max_speakers:
        raise ValueError(
            f"min_speakers ({min_speakers:g}) must be <= max_speakers "
            f"({max_speakers:g})")
    if min_speakers == max_speakers:
        num_speakers = min_speakers
    return num_speakers, min_speakers, max_speakers


class SpeakerDiarizationMixin:
    """Methods common to speaker diarization pipelines."""

    @staticmethod
    def optimal_mapping(reference: Union[Mapping, Annotation],
                        hypothesis: Annotation,
                        return_mapping: bool = False):
        """Rename the hypothesis's labels after the reference's that they
        overlap most (Hungarian); a file dict's ``annotated`` region, if
        any, restricts the overlap."""
        annotated = None
        if isinstance(reference, Mapping):
            annotated = reference.get("annotated")
            reference = reference["annotation"]
        mapping = DiarizationErrorRate().optimal_mapping(
            reference, hypothesis, uem=annotated)
        mapped = hypothesis.rename_labels(mapping=mapping)
        if return_mapping:
            return mapped, mapping
        return mapped

    @staticmethod
    def to_annotation(discrete_diarization: SlidingWindowFeature,
                      min_duration_off: float = 0.0) -> Annotation:
        return Binarize(onset=0.5, min_duration_off=min_duration_off)(
            discrete_diarization)

    @staticmethod
    def speaker_count(binarized_segmentations: SlidingWindowFeature,
                      frames: SlidingWindow,
                      warm_up: Tuple[float, float] = (0.1, 0.1)
                      ) -> SlidingWindowFeature:
        """Frame-level speaker count of host chunk-level binarized scores:
        trim the warm-up, sum the speakers, aggregate, round (uint8)."""
        trimmed = Inference.trim(binarized_segmentations, warm_up=warm_up)
        summed = SlidingWindowFeature(
            np.sum(trimmed.data, axis=-1, keepdims=True),
            trimmed.sliding_window)
        count = Inference.aggregate(summed, frames, hamming=False,
                                    missing=0.0, skip_average=False)
        count.data = np.rint(count.data).astype(np.uint8)
        return count

    @staticmethod
    def to_diarization(segmentations: SlidingWindowFeature,
                       count: SlidingWindowFeature) -> SlidingWindowFeature:
        """Count-constrained discrete diarization of host chunk-level
        clustered scores: in each frame, the ``count`` highest-scoring
        speakers are active, ties going to the lower index (a stable sort,
        as on the device in ``ops/diarize_fused.py``)."""
        activations = Inference.aggregate(
            segmentations, count.sliding_window, hamming=False, missing=0.0,
            skip_average=True)
        _, num_speakers = activations.data.shape
        max_count = int(np.max(count.data)) if len(count.data) else 0
        if num_speakers < max_count:
            activations.data = np.pad(
                activations.data, ((0, 0), (0, max_count - num_speakers)))
        extent = activations.extent & count.extent
        activations = activations.crop_loose(extent)
        count = count.crop_loose(extent)
        n = min(len(activations.data), len(count.data))
        act = activations.data[:n]
        cnt = count.data[:n].reshape(-1)
        order = np.argsort(-act, axis=-1, kind="stable")
        ranks = np.empty_like(order)
        np.put_along_axis(ranks, order, np.broadcast_to(
            np.arange(act.shape[1]), act.shape).copy(), axis=-1)
        binary = (ranks < cnt[:, None]).astype(np.float32)
        return SlidingWindowFeature(binary, activations.sliding_window)

    def reconstruct(self, segmentations: SlidingWindowFeature,
                    hard_clusters: np.ndarray, count: SlidingWindowFeature
                    ) -> SlidingWindowFeature:
        """Host reconstruction (the JAX package's ``reconstruct``): per
        cluster, the max of its local speakers' scores in each chunk (NaN
        where a member's score is NaN, or no speaker is a member), then
        ``to_diarization``. SpeakerDiarization reconstructs on the device
        (``_reconstruct``); the separation pipeline calls this."""
        num_chunks, num_frames, _ = segmentations.data.shape
        num_clusters = int(np.max(hard_clusters)) + 1
        raw = segmentations.data
        nan_scores = np.isnan(raw)
        data = np.nan_to_num(raw, nan=-np.inf)
        clustered = np.full((num_chunks, num_frames, num_clusters), np.nan,
                            dtype=np.float32)
        for k in range(num_clusters):
            member = hard_clusters == k                       # (C, S)
            best = np.where(member[:, None, :], data, -np.inf).max(axis=2)
            any_nan = (member[:, None, :] & nan_scores).any(axis=2)
            clustered[:, :, k] = np.where(np.isfinite(best) & ~any_nan,
                                          best, np.nan)
        return self.to_diarization(
            SlidingWindowFeature(clustered, segmentations.sliding_window),
            count)
