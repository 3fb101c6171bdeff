"""RTTM, UEM and LST files.

Counterpart of pyannote_audio_tpu/utils/rttm.py: NIST RTTM speaker
records, from which the oracle pipelines, the metrics and the protocols
read reference annotations, UEM evaluation maps and plain-text URI lists
(``utils.database``). The writers produce the JAX package's bytes.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, TextIO, Union

from ..core.annotation import Annotation, Timeline
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


def write_rttm(file: TextIO, *annotations: Annotation) -> None:
    for annotation in annotations:
        annotation.write_rttm(file)


def dump_rttm(annotations: Dict[str, Annotation], path: PathLike) -> None:
    """One RTTM file of every annotation, in URI order."""
    with open(path, "w", encoding="utf-8") as f:
        for uri in sorted(annotations):
            annotations[uri].write_rttm(f)


def load_uem(path: PathLike) -> Dict[str, Timeline]:
    """Parse a UEM file into one Timeline per URI."""
    timelines: Dict[str, Timeline] = {}
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith(";"):
                continue
            uri, _channel, start, end = line.split()[:4]
            timeline = timelines.setdefault(uri, Timeline(uri=uri))
            timeline.add(Segment(float(start), float(end)))
    return timelines


def dump_uem(timelines: Dict[str, Timeline], path: PathLike) -> None:
    """One UEM file of every timeline, in URI order."""
    with open(path, "w", encoding="utf-8") as f:
        for uri in sorted(timelines):
            for segment in timelines[uri]:
                f.write(f"{uri} 1 {segment.start:.3f} {segment.end:.3f}\n")


def load_lst(path: PathLike) -> List[str]:
    """One URI per non-empty line."""
    with open(path, "r", encoding="utf-8") as f:
        return [line.strip() for line in f if line.strip()]
