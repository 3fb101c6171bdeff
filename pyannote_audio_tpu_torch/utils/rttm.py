"""RTTM file parsing.

Counterpart of ``load_rttm`` in pyannote_audio_tpu/utils/rttm.py: NIST
RTTM speaker records, from which the oracle pipelines and the metrics
read reference annotations (``Annotation.write_rttm`` writes them).
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Union

from ..core.annotation import Annotation
from ..core.segment import Segment

PathLike = Union[str, Path]


def load_rttm(path: PathLike) -> Dict[str, Annotation]:
    """Parse an RTTM file into one Annotation per URI."""
    annotations: Dict[str, Annotation] = {}
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith(";"):
                continue
            fields = line.split()
            if fields[0] != "SPEAKER":
                continue
            uri = fields[1]
            start = float(fields[3])
            duration = float(fields[4])
            label = fields[7]
            ann = annotations.setdefault(uri, Annotation(uri=uri))
            seg = Segment(start, start + duration)
            ann[seg, ann.new_track(seg)] = label
    return annotations

