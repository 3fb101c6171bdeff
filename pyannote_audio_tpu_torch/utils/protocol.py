"""Protocol validation and filtering.

Counterpart of pyannote_audio_tpu/utils/protocol.py (``check_protocol``,
``FilterByNumberOfSpeakers``).
"""

from __future__ import annotations

import warnings
from typing import Dict, Tuple

from ..core.annotation import Annotation
from .database import Protocol


def check_protocol(protocol: Protocol) -> Tuple[Protocol, bool]:
    """Check that ``protocol`` gives what training needs; returns
    (protocol, whether it has a development subset)."""
    train = list(protocol.train())
    if not train:
        raise ValueError(
            f"protocol {protocol.name!r} has no training files")
    missing_audio = [f["uri"] for f in train if "audio" not in f
                     and "waveform" not in f]
    if missing_audio:
        raise ValueError(
            f"protocol {protocol.name!r} files missing audio: "
            f"{missing_audio[:5]}")
    missing_annotation = [f["uri"] for f in train
                          if "annotation" not in f]
    if missing_annotation:
        raise ValueError(
            f"protocol {protocol.name!r} files missing annotation: "
            f"{missing_annotation[:5]}")
    no_annotated = [f["uri"] for f in train if not f.get("annotated")]
    if no_annotated:
        warnings.warn(
            f"{len(no_annotated)} files have no 'annotated' regions; "
            "the full file extent will be used.")
    has_validation = len(list(protocol.development())) > 0
    return protocol, has_validation


class FilterByNumberOfSpeakers:
    """A file's annotation cut to its ``num_speakers`` most talkative
    speakers."""

    def __init__(self, num_speakers: int):
        self.num_speakers = num_speakers

    def __call__(self, file: Dict) -> Annotation:
        annotation: Annotation = file["annotation"]
        if len(annotation.labels()) == self.num_speakers:
            return annotation
        keep = [label for label, _ in
                annotation.chart()[:self.num_speakers]]
        return annotation.subset(keep)
