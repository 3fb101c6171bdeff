"""Protocol file preprocessors.

Counterpart of pyannote_audio_tpu/utils/preprocessors.py:
``LowerTemporalResolution`` (annotation boundaries widened to a coarser
grid), ``DeriveMetaLabels`` (labels mapped, merged and intersected into
meta classes), ``Waveform`` (the decoded waveform) and ``SampleRate``. A
pipeline config names them under ``preprocessors: {key: {name: ...}}``,
by bare class name (resolved here) or by a ``pyannote.audio`` /
``pyannote_audio_tpu`` path (``core.pipeline.port_module_name``).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from ..core.annotation import Annotation
from ..core.io import Audio
from ..core.segment import Segment


class LowerTemporalResolution:
    """Each turn widened to the ``resolution`` grid around it (start
    floored, end ceiled); empty turns dropped."""

    def __init__(self, resolution: float = 0.1):
        self.resolution = resolution

    def __call__(self, file: Dict) -> Annotation:
        annotation: Annotation = file["annotation"]
        out = Annotation(uri=annotation.uri)
        for seg, _, label in annotation.itertracks(yield_label=True):
            start = self.resolution * np.floor(seg.start / self.resolution)
            end = self.resolution * np.ceil(seg.end / self.resolution)
            new_seg = Segment(start, end)
            if new_seg:
                out[new_seg, out.new_track(new_seg)] = label
        return out


class DeriveMetaLabels:
    """Labels mapped through ``mapping`` and kept where in ``classes``,
    plus a meta label over each of ``unions``' members' turns and over the
    intersection of each of ``intersections``' members' supports."""

    def __init__(self, classes: List[str], unions: Optional[Dict] = None,
                 intersections: Optional[Dict] = None,
                 mapping: Optional[Dict] = None):
        self.classes = classes
        self.unions = unions or {}
        self.intersections = intersections or {}
        self.mapping = mapping or {}

    def __call__(self, file: Dict) -> Annotation:
        annotation: Annotation = file["annotation"]
        out = Annotation(uri=annotation.uri)
        for seg, _, label in annotation.itertracks(yield_label=True):
            mapped = self.mapping.get(label, label)
            if mapped in self.classes:
                out[seg, out.new_track(seg)] = mapped
        for meta, members in self.unions.items():
            members = set(members)
            for seg, _, label in annotation.itertracks(yield_label=True):
                if label in members:
                    out[seg, out.new_track(seg)] = meta
        for meta, members in self.intersections.items():
            timelines = [annotation.label_timeline(m).support()
                         for m in members]
            if not timelines:
                continue
            inter = timelines[0]
            for tl in timelines[1:]:
                inter = inter.crop(tl)
            for seg in inter:
                out[seg, out.new_track(seg)] = meta
        return out


class Waveform:
    """The file's waveform, decoded and downmixed at ``sample_rate``."""

    def __init__(self, sample_rate: int = 16000):
        self.audio = Audio(sample_rate=sample_rate, mono="downmix")

    def __call__(self, file: Dict):
        waveform, _ = self.audio(file)
        return waveform


class SampleRate:
    def __init__(self, sample_rate: int = 16000):
        self.sample_rate = sample_rate

    def __call__(self, file: Dict) -> int:
        return self.sample_rate
