"""Shared diarization helpers.

Counterpart of the parts of pyannote_audio_tpu/pipelines/utils/
diarization.py that the diarization path uses: ``set_num_speakers``,
``SpeakerDiarizationMixin.optimal_mapping`` and ``to_annotation``.
"""

from __future__ import annotations

from typing import Mapping, Optional, Union

import numpy as np

from ...core.annotation import Annotation
from ...core.segment import SlidingWindowFeature
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
