"""Timeline and Annotation: who-spoke-when containers.

Counterpart of pyannote_audio_tpu/core/annotation.py, cut to what the
diarization path uses: tracks, labels, ``rename_labels``, ``support`` and
``itertracks``. Host-side, plain Python.
"""

from __future__ import annotations

from typing import Dict, Hashable, Iterator, List, Optional, Tuple, Union

from .segment import Segment

Label = Hashable
TrackName = Union[str, int]


class Timeline:
    """An ordered set of (possibly overlapping) segments."""

    def __init__(self, segments: Optional[List[Segment]] = None,
                 uri: Optional[str] = None):
        self.uri = uri
        self._segments: List[Segment] = sorted(
            set(s for s in (segments or []) if s))

    def __len__(self) -> int:
        return len(self._segments)

    def __iter__(self) -> Iterator[Segment]:
        return iter(self._segments)

    def support(self, collar: float = 0.0) -> "Timeline":
        """Merge overlapping (or within-collar) segments."""
        merged: List[Segment] = []
        for s in self:
            if merged and s.start <= merged[-1].end + collar:
                merged[-1] = Segment(merged[-1].start,
                                     max(merged[-1].end, s.end))
            else:
                merged.append(s)
        return Timeline(merged, uri=self.uri)


class Annotation:
    """Speaker diarization container: (segment, track) -> label."""

    def __init__(self, uri: Optional[str] = None):
        self.uri = uri
        self._tracks: Dict[Segment, Dict[TrackName, Label]] = {}

    def __setitem__(self, key: Union[Segment, Tuple[Segment, TrackName]],
                    label: Label):
        segment, track = (key, "_") if isinstance(key, Segment) else key
        if not segment:
            return
        self._tracks.setdefault(segment, {})[track] = label

    def new_track(self, segment: Segment, prefix: str = "") -> TrackName:
        existing = set(self._tracks.get(segment, {}))
        i = 0
        while f"{prefix}{i}" in existing:
            i += 1
        return f"{prefix}{i}"

    def itertracks(self, yield_label: bool = False):
        for segment in sorted(self._tracks):
            for track in sorted(self._tracks[segment], key=str):
                if yield_label:
                    yield segment, track, self._tracks[segment][track]
                else:
                    yield segment, track

    def __len__(self) -> int:
        return len(self._tracks)

    def __bool__(self) -> bool:
        return len(self._tracks) > 0

    def __eq__(self, other) -> bool:
        return isinstance(other, Annotation) and \
            list(self.itertracks(yield_label=True)) == \
            list(other.itertracks(yield_label=True))

    def labels(self) -> List[Label]:
        return sorted({lbl for tracks in self._tracks.values()
                       for lbl in tracks.values()}, key=str)

    def label_timeline(self, label: Label) -> Timeline:
        return Timeline([seg for seg, _, lbl in
                         self.itertracks(yield_label=True) if lbl == label],
                        uri=self.uri)

    def rename_labels(self, mapping: Dict[Label, Label]) -> "Annotation":
        """Copy with labels mapped; labels absent from ``mapping`` stay."""
        out = Annotation(uri=self.uri)
        out._tracks = {seg: {t: mapping.get(lbl, lbl)
                             for t, lbl in tracks.items()}
                       for seg, tracks in self._tracks.items()}
        return out

    def support(self, collar: float = 0.0) -> "Annotation":
        """Merge same-label segments closer than ``collar``."""
        out = Annotation(uri=self.uri)
        for label in self.labels():
            for seg in self.label_timeline(label).support(collar):
                out[seg, out.new_track(seg)] = label
        return out

    def __repr__(self) -> str:
        return (f"<Annotation uri={self.uri} segments={len(self)} "
                f"labels={self.labels()}>")
