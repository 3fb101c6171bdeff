"""Timeline and Annotation: who-spoke-when containers.

Counterpart of pyannote_audio_tpu/core/annotation.py, cut to what the
pipelines, the oracles, the metrics and RTTM input and output use: tracks
(set, read, deleted), labels, ``rename_labels``, ``support``, ``crop``,
``extrude``, ``subset``, ``update``, ``get_overlap``, ``get_timeline`` and
``write_rttm``, and a Timeline with ``gaps``, ``crop``, ``union``,
``covers`` and ``to_annotation``; ``one_hot_decode`` turns binary frames
back into an Annotation. Host-side, plain Python.
"""

from __future__ import annotations

import io
import itertools
from typing import (Dict, Hashable, Iterator, List, Optional, Set, TextIO,
                    Tuple, Union)

import numpy as np

from .segment import Segment, SlidingWindow

Label = Hashable
TrackName = Union[str, int]


def string_generator() -> Iterator[str]:
    """A, B, ..., Z, AA, AB, ..."""
    for size in itertools.count(1):
        for letters in itertools.product(
                [chr(ord("A") + i) for i in range(26)], repeat=size):
            yield "".join(letters)


class Timeline:
    """An ordered set of (possibly overlapping) segments."""

    def __init__(self, segments: Optional[List[Segment]] = None,
                 uri: Optional[str] = None):
        self.uri = uri
        # ordered set: exact duplicates collapse
        self._segments: List[Segment] = sorted(
            set(s for s in (segments or []) if s))
        self._seen = set(self._segments)
        self._dirty = False

    def _sort(self):
        if self._dirty:
            self._segments.sort()
            self._dirty = False

    def add(self, segment: Segment) -> "Timeline":
        if segment and segment not in self._seen:
            self._segments.append(segment)
            self._seen.add(segment)
            self._dirty = True
        return self

    def __len__(self) -> int:
        return len(self._segments)

    def __bool__(self) -> bool:
        return len(self._segments) > 0

    def __iter__(self) -> Iterator[Segment]:
        self._sort()
        return iter(self._segments)

    def __getitem__(self, i: int) -> Segment:
        self._sort()
        return self._segments[i]

    def __eq__(self, other) -> bool:
        return isinstance(other, Timeline) and list(self) == list(other)

    def __contains__(self, segment: Segment) -> bool:
        return segment in self._seen

    def extent(self) -> Segment:
        if not self._segments:
            return Segment(0.0, 0.0)
        return Segment(min(s.start for s in self._segments),
                       max(s.end for s in self._segments))

    def duration(self) -> float:
        """Total duration of the support (overlaps counted once)."""
        return sum(s.duration for s in self.support())

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

    def gaps(self, support: Optional[Union[Segment, "Timeline"]] = None
             ) -> "Timeline":
        """The stretches of ``support`` (default: the extent) that no
        segment covers."""
        if support is None:
            support = self.extent()
        if isinstance(support, Segment):
            support = Timeline([support], uri=self.uri)
        out = Timeline(uri=self.uri)
        for seg in support.support():
            t = seg.start
            for s in self.support().crop_timeline(seg):
                gap = Segment(t, s.start)
                if gap:
                    out.add(gap)
                t = max(t, s.end)
            gap = Segment(t, seg.end)
            if gap:
                out.add(gap)
        return out

    def crop_timeline(self, focus: Segment) -> "Timeline":
        """Intersect every segment with ``focus`` (drops empties)."""
        out = Timeline(uri=self.uri)
        for s in self:
            inter = s & focus
            if inter:
                out.add(inter)
        return out

    def crop(self, support: Union[Segment, "Timeline"],
             mode: str = "intersection") -> "Timeline":
        """The segments within ``support``: intersected with it, or kept
        whole when inside it ("strict") or touching it ("loose"); a
        segment touching several support segments is kept once."""
        if isinstance(support, Segment):
            support = Timeline([support], uri=self.uri)
        out = Timeline(uri=self.uri)
        seen = set()
        for seg in support.support():
            for s in self:
                inter = s & seg
                if not inter:
                    continue
                if mode == "intersection":
                    out.add(inter)
                elif mode in ("strict", "loose"):
                    if s not in seen and (mode == "loose" or s in seg):
                        seen.add(s)
                        out.add(s)
                else:
                    raise ValueError(f"unknown mode {mode!r}")
        return out

    def overlapping(self, t: float) -> List[Segment]:
        return [s for s in self if s.overlaps(t)]

    def union(self, other: "Timeline") -> "Timeline":
        return Timeline(list(self) + list(other), uri=self.uri)

    def update(self, other: "Timeline") -> "Timeline":
        for s in other:
            self.add(s)
        return self

    def copy(self) -> "Timeline":
        return Timeline(list(self), uri=self.uri)

    def covers(self, other: "Timeline") -> bool:
        """Does the timeline cover every segment of ``other``?"""
        gaps = self.gaps(support=other.support())
        return len(gaps.crop(other)) == 0

    def to_annotation(self, generator: str = "string") -> "Annotation":
        """One track per segment, labelled A, B, ... (or 0, 1, ...)."""
        annotation = Annotation(uri=self.uri)
        names = string_generator() if generator == "string" \
            else itertools.count()
        for s in self:
            annotation[s] = next(names)
        return annotation

    def __repr__(self) -> str:
        return f"<Timeline uri={self.uri} segments={len(self)}>"

    def __str__(self) -> str:
        return "[" + " ".join(str(s) for s in self) + "]"


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

    def __getitem__(self, key: Union[Segment, Tuple[Segment, TrackName]]
                    ) -> Label:
        segment, track = (key, "_") if isinstance(key, Segment) else key
        return self._tracks[segment][track]

    def __delitem__(self, key: Union[Segment, Tuple[Segment, TrackName]]):
        """Delete a segment's every track, or one (segment, track)."""
        if isinstance(key, Segment):
            del self._tracks[key]
            return
        segment, track = key
        del self._tracks[segment][track]
        if not self._tracks[segment]:
            del self._tracks[segment]

    def new_track(self, segment: Segment, prefix: str = "") -> TrackName:
        existing = set(self._tracks.get(segment, {}))
        i = 0
        while f"{prefix}{i}" in existing:
            i += 1
        return f"{prefix}{i}"

    def itersegments(self) -> Iterator[Segment]:
        return iter(sorted(self._tracks))

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

    def label_duration(self, label: Label) -> float:
        return self.label_timeline(label).duration()

    def chart(self) -> List[Tuple[Label, float]]:
        """(label, duration) by decreasing duration."""
        return sorted(((lbl, self.label_duration(lbl))
                       for lbl in self.labels()),
                      key=lambda kv: kv[1], reverse=True)

    def get_timeline(self) -> Timeline:
        return Timeline(list(self._tracks), uri=self.uri)

    def get_tracks(self, segment: Segment) -> Set[TrackName]:
        return set(self._tracks.get(segment, {}))

    def get_labels(self, segment: Segment) -> Set[Label]:
        return set(self._tracks.get(segment, {}).values())

    def get_overlap(self) -> Timeline:
        """Regions where two or more tracks overlap."""
        segments = sorted(seg for seg, _ in self.itertracks())
        overlaps = Timeline(uri=self.uri)
        for i, s1 in enumerate(segments):
            for s2 in segments[i + 1:]:
                if s2.start >= s1.end:
                    break              # sorted: nothing later overlaps s1
                inter = s1 & s2
                if inter:
                    overlaps.add(inter)
        return overlaps.support()

    def rename_labels(self, mapping: Dict[Label, Label]) -> "Annotation":
        """Copy with labels mapped; labels absent from ``mapping`` stay."""
        out = Annotation(uri=self.uri)
        out._tracks = {seg: {t: mapping.get(lbl, lbl)
                             for t, lbl in tracks.items()}
                       for seg, tracks in self._tracks.items()}
        return out

    def subset(self, labels: List[Label], invert: bool = False
               ) -> "Annotation":
        """The tracks whose label is in ``labels`` (or not, ``invert``)."""
        labels = set(labels)
        out = Annotation(uri=self.uri)
        for seg, track, lbl in self.itertracks(yield_label=True):
            if (lbl in labels) != invert:
                out[seg, track] = lbl
        return out

    def crop(self, support: Union[Segment, Timeline],
             mode: str = "intersection") -> "Annotation":
        """Tracks intersected with ``support`` ("intersection"), or kept
        whole when inside it ("strict") or touching it ("loose")."""
        if isinstance(support, Segment):
            support = Timeline([support], uri=self.uri)
        support = support.support()
        out = Annotation(uri=self.uri)
        for seg, track, lbl in self.itertracks(yield_label=True):
            for sup in support:
                inter = seg & sup
                if not inter:
                    continue
                if mode == "intersection":
                    # distinct source tracks may crop to the same segment
                    if track in out._tracks.get(inter, {}):
                        out[inter, out.new_track(inter)] = lbl
                    else:
                        out[inter, track] = lbl
                elif mode == "loose" or (mode == "strict" and seg in sup):
                    out[seg, track] = lbl
        return out

    def extrude(self, removed: Union[Segment, Timeline],
                mode: str = "intersection") -> "Annotation":
        """The tracks with ``removed`` cut out of them."""
        if isinstance(removed, Segment):
            removed = Timeline([removed], uri=self.uri)
        extent = self.get_timeline().extent() | removed.extent()
        keep = removed.gaps(support=extent)
        inverted = {"strict": "loose", "loose": "strict"}.get(mode, mode)
        return self.crop(keep, mode=inverted)

    def support(self, collar: float = 0.0) -> "Annotation":
        """Merge same-label segments closer than ``collar``."""
        out = Annotation(uri=self.uri)
        for label in self.labels():
            for seg in self.label_timeline(label).support(collar):
                out[seg, out.new_track(seg)] = label
        return out

    def update(self, other: "Annotation", copy: bool = False
               ) -> "Annotation":
        """Add ``other``'s tracks (to a copy with ``copy``)."""
        target = self.copy() if copy else self
        for seg, track, lbl in other.itertracks(yield_label=True):
            target[seg, track] = lbl
        return target

    def copy(self) -> "Annotation":
        out = Annotation(uri=self.uri)
        out._tracks = {seg: dict(tracks)
                       for seg, tracks in self._tracks.items()}
        return out

    def write_rttm(self, file: TextIO) -> None:
        """One RTTM SPEAKER line per track."""
        for seg, _, lbl in self.itertracks(yield_label=True):
            file.write(f"SPEAKER {self.uri or '<NA>'} 1 {seg.start:.3f} "
                       f"{seg.duration:.3f} <NA> <NA> {lbl} <NA> <NA>\n")

    def to_rttm(self) -> str:
        buffer = io.StringIO()
        self.write_rttm(buffer)
        return buffer.getvalue()

    def __repr__(self) -> str:
        return (f"<Annotation uri={self.uri} segments={len(self)} "
                f"labels={self.labels()}>")


def one_hot_decode(data: np.ndarray, window: SlidingWindow,
                   labels: Optional[List[Label]] = None,
                   uri: Optional[str] = None) -> Annotation:
    """(frames, classes) binary ``data`` at ``window``'s frames -> an
    Annotation: each run of frames above 0.5 of class k is one segment of
    ``labels[k]`` ("class_k" without labels), from its first frame's start
    to its last frame's end, on track k."""
    data = np.asarray(data)
    num_frames, num_labels = data.shape
    if labels is None:
        labels = [f"class_{k}" for k in range(num_labels)]
    annotation = Annotation(uri=uri)
    for k in range(num_labels):
        padded = np.concatenate([[False], data[:, k] > 0.5, [False]])
        starts = np.nonzero(~padded[:-1] & padded[1:])[0]
        ends = np.nonzero(padded[:-1] & ~padded[1:])[0]
        for i0, i1 in zip(starts, ends):
            start = window.start + i0 * window.step
            end = window.start + (i1 - 1) * window.step + window.duration
            annotation[Segment(start, end), k] = labels[k]
    return annotation
