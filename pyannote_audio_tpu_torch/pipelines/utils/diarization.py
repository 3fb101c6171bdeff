"""Shared diarization helpers.

Counterpart of the parts of pyannote_audio_tpu/pipelines/utils/
diarization.py that the diarization path uses: ``set_num_speakers`` and
``SpeakerDiarizationMixin.to_annotation``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ...core.annotation import Annotation
from ...core.segment import SlidingWindowFeature
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
    def to_annotation(discrete_diarization: SlidingWindowFeature,
                      min_duration_off: float = 0.0) -> Annotation:
        return Binarize(onset=0.5, min_duration_off=min_duration_off)(
            discrete_diarization)
