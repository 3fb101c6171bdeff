"""Diarization error rate: an exact interval sweep on the host.

Counterpart of the part of pyannote_audio_tpu/metrics/der.py that the
diarization pipeline uses (the reference's ``pyannote.metrics``):
``cooccurrence_matrix``, the Hungarian ``optimal_mapping`` that renames a
hypothesis after a reference annotation, ``DiarizationErrorRate`` and
``GreedyDiarizationErrorRate`` with their component sweep. The other
metrics of that file are not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Hashable, List, Optional, Tuple

import numpy as np
from scipy.optimize import linear_sum_assignment

from ..core.annotation import Annotation, Timeline
from ..core.segment import Segment


def _boundaries(*annotations: Annotation, uem: Optional[Timeline] = None
                ) -> np.ndarray:
    pts = set()
    for ann in annotations:
        for seg in ann.itersegments():
            pts.add(seg.start)
            pts.add(seg.end)
    if uem is not None:
        for seg in uem:
            pts.add(seg.start)
            pts.add(seg.end)
    return np.array(sorted(pts))


def _interval_active_labels(ann: Annotation, pts: np.ndarray
                            ) -> List[List[Hashable]]:
    """UNIQUE active labels per elementary interval [pts[i], pts[i+1]).

    ONE event sweep over the annotation's tracks (the per-interval
    rescan of every track was O(intervals x tracks log tracks), turning
    corpus evaluation into minutes of pure Python on 1-hour files).

    Deduplication matters: overlapping same-label tracks (legal in RTTM
    and in Annotation) must count as ONE active speaker, like
    pyannote.metrics' crop().labels() — otherwise n_correct can exceed
    min(n_ref, n_hyp) and confusion goes negative. The activity counter
    handles that: a label is active while ANY of its tracks covers the
    interval."""
    import bisect
    from collections import Counter

    n = len(pts) - 1
    if n <= 0:
        return []
    index = {float(t): i for i, t in enumerate(pts)}
    starts: List[List[Hashable]] = [[] for _ in range(n + 1)]
    ends: List[List[Hashable]] = [[] for _ in range(n + 1)]
    for seg, _, lbl in ann.itertracks(yield_label=True):
        i0 = index.get(seg.start)
        if i0 is None:
            i0 = bisect.bisect_left(pts, seg.start)
        i1 = index.get(seg.end)
        if i1 is None:
            i1 = bisect.bisect_left(pts, seg.end)
        i0, i1 = min(i0, n), min(i1, n)
        if i1 > i0:
            starts[i0].append(lbl)
            ends[i1].append(lbl)
    active: Counter = Counter()
    out: List[List[Hashable]] = []
    for i in range(n):
        for lbl in ends[i]:
            active[lbl] -= 1
            if active[lbl] == 0:
                del active[lbl]
        for lbl in starts[i]:
            active[lbl] += 1
        out.append(list(active.keys()))
    return out


def _uem_flags(uem: Optional[Timeline], pts: np.ndarray) -> np.ndarray:
    """Boolean per elementary interval: inside the (disjoint) uem?"""
    n = max(0, len(pts) - 1)
    if uem is None:
        return np.ones(n, dtype=bool)
    flags = np.zeros(n, dtype=bool)
    segs = list(uem)
    j = 0
    for i in range(n):
        mid = 0.5 * (pts[i] + pts[i + 1])
        while j < len(segs) and segs[j].end <= mid:
            j += 1
        flags[i] = j < len(segs) and segs[j].start <= mid < segs[j].end
    return flags


def cooccurrence_matrix(reference: Annotation, hypothesis: Annotation,
                        uem: Optional[Timeline] = None
                        ) -> Tuple[np.ndarray, List, List]:
    """Duration of joint activity for each (ref_label, hyp_label) pair."""
    ref_labels = reference.labels()
    hyp_labels = hypothesis.labels()
    ref_idx = {lbl: i for i, lbl in enumerate(ref_labels)}
    hyp_idx = {lbl: i for i, lbl in enumerate(hyp_labels)}
    mat = np.zeros((len(ref_labels), len(hyp_labels)))
    pts = _boundaries(reference, hypothesis, uem=uem)
    inside = _uem_flags(uem.support() if uem is not None else None, pts)
    ref_active = _interval_active_labels(reference, pts)
    hyp_active = _interval_active_labels(hypothesis, pts)
    for i, (lo, hi) in enumerate(zip(pts[:-1], pts[1:])):
        dur = hi - lo
        if dur <= 0 or not inside[i]:
            continue
        for rl in ref_active[i]:
            for hl in hyp_active[i]:
                mat[ref_idx[rl], hyp_idx[hl]] += dur
    return mat, ref_labels, hyp_labels


def optimal_mapping(reference: Annotation, hypothesis: Annotation,
                    uem: Optional[Timeline] = None) -> Dict:
    """Hungarian one-to-one hyp->ref label mapping maximizing overlap."""
    mat, ref_labels, hyp_labels = cooccurrence_matrix(
        reference, hypothesis, uem=uem)
    if mat.size == 0:
        return {}
    rows, cols = linear_sum_assignment(-mat)
    return {hyp_labels[j]: ref_labels[i]
            for i, j in zip(rows, cols) if mat[i, j] > 0}


@dataclass
class DERComponents:
    false_alarm: float = 0.0
    missed_detection: float = 0.0
    confusion: float = 0.0
    total: float = 0.0

    @property
    def der(self) -> float:
        if self.total == 0.0:
            return 0.0 if (self.false_alarm == 0.0) else np.inf
        return (self.false_alarm + self.missed_detection +
                self.confusion) / self.total

    def __iadd__(self, other: "DERComponents") -> "DERComponents":
        self.false_alarm += other.false_alarm
        self.missed_detection += other.missed_detection
        self.confusion += other.confusion
        self.total += other.total
        return self


def _scoring_uem(reference: Annotation, hypothesis: Annotation,
                 collar: float, uem: Optional[Timeline],
                 skip_overlap: bool = False) -> Optional[Timeline]:
    """Resolve the scoring region (pyannote.metrics uemify semantics).

    - missing uem -> union of the REFERENCE and HYPOTHESIS extents (a
      reference-only extent would silently drop false alarms outside it);
    - collar > 0 -> remove +-collar/2 around every reference boundary;
    - skip_overlap -> also remove (collar-extended) reference overlap
      regions, so BOTH the label mapping and the scoring sweep exclude
      them, exactly like pyannote.metrics' extruded uem.
    """
    if collar <= 0 and not skip_overlap:
        return uem
    half = 0.5 * collar
    if uem is None:
        ref_tl = reference.get_timeline()
        hyp_tl = hypothesis.get_timeline()
        if not ref_tl and not hyp_tl:
            return uem
        extents = [tl.extent() for tl in (ref_tl, hyp_tl) if tl]
        extent = Segment(min(e.start for e in extents) - half,
                         max(e.end for e in extents) + half)
        uem = Timeline([extent], uri=reference.uri)
    removed = Timeline(uri=reference.uri)
    if collar > 0:
        for seg in reference.itersegments():
            removed.add(Segment(seg.start - half, seg.start + half))
            removed.add(Segment(seg.end - half, seg.end + half))
    if skip_overlap:
        for seg in reference.get_overlap():
            removed.add(Segment(seg.start - half, seg.end + half))
    if not removed:
        return uem.support()
    return removed.gaps(support=uem.support())


def diarization_error_rate_components(
    reference: Annotation,
    hypothesis: Annotation,
    uem: Optional[Timeline] = None,
    collar: float = 0.0,
    skip_overlap: bool = False,
    mapping: Optional[Dict] = None,
) -> DERComponents:
    """Exact DER decomposition via a boundary sweep.

    For each elementary interval (between consecutive boundaries of
    ref+hyp+uem): with Nr ref speakers, Nh hyp speakers and Nc correctly
    mapped speakers active,
      miss += max(0, Nr-Nh) * dur
      fa   += max(0, Nh-Nr) * dur
      conf += (min(Nr,Nh) - Nc) * dur
      total += Nr * dur
    """
    uem = _scoring_uem(reference, hypothesis, collar, uem,
                       skip_overlap=skip_overlap)
    if uem is not None:
        uem = uem.support()
    if mapping is None:
        mapping = optimal_mapping(reference, hypothesis, uem=uem)
    comp = DERComponents()
    pts = _boundaries(reference, hypothesis, uem=uem)
    inside = _uem_flags(uem, pts)
    ref_active = _interval_active_labels(reference, pts)
    hyp_active = _interval_active_labels(hypothesis, pts)
    for i, (lo, hi) in enumerate(zip(pts[:-1], pts[1:])):
        dur = hi - lo
        if dur <= 0 or not inside[i]:
            continue
        # skip_overlap is fully handled by the extruded uem above (the
        # overlap regions are removed from scoring AND mapping)
        r = ref_active[i]
        h = hyp_active[i]
        mapped = {mapping.get(hl) for hl in h}
        n_ref, n_hyp = len(r), len(h)
        n_correct = sum(1 for rl in r if rl in mapped)
        comp.total += n_ref * dur
        comp.missed_detection += max(0, n_ref - n_hyp) * dur
        comp.false_alarm += max(0, n_hyp - n_ref) * dur
        comp.confusion += (min(n_ref, n_hyp) - n_correct) * dur
    return comp


def diarization_error_rate(
    reference: Annotation,
    hypothesis: Annotation,
    uem: Optional[Timeline] = None,
    collar: float = 0.0,
    skip_overlap: bool = False,
) -> float:
    return diarization_error_rate_components(
        reference, hypothesis, uem=uem, collar=collar,
        skip_overlap=skip_overlap).der


class DiarizationErrorRate:
    """Accumulating DER metric over a corpus (mirrors pyannote.metrics API)."""

    def __init__(self, collar: float = 0.0, skip_overlap: bool = False):
        self.collar = collar
        self.skip_overlap = skip_overlap
        self.components_ = DERComponents()
        self.uris_: List[str] = []

    def __call__(self, reference: Annotation, hypothesis: Annotation,
                 uem: Optional[Timeline] = None, detailed: bool = False):
        comp = diarization_error_rate_components(
            reference, hypothesis, uem=uem, collar=self.collar,
            skip_overlap=self.skip_overlap)
        self.components_ += comp
        self.uris_.append(reference.uri)
        if detailed:
            return {
                "diarization error rate": comp.der,
                "false alarm": comp.false_alarm,
                "missed detection": comp.missed_detection,
                "confusion": comp.confusion,
                "total": comp.total,
            }
        return comp.der

    def optimal_mapping(self, reference: Annotation, hypothesis: Annotation,
                        uem: Optional[Timeline] = None) -> Dict:
        return optimal_mapping(reference, hypothesis, uem=uem)

    def reset(self) -> None:
        """Drop accumulated components (pyannote.metrics BaseMetric.reset)."""
        self.components_ = DERComponents()
        self.uris_ = []

    def __abs__(self) -> float:
        return self.components_.der

    def report(self) -> Dict[str, float]:
        c = self.components_
        return {
            "diarization error rate": c.der,
            "false alarm": c.false_alarm,
            "missed detection": c.missed_detection,
            "confusion": c.confusion,
            "total": c.total,
        }


class GreedyDiarizationErrorRate(DiarizationErrorRate):
    """DER with greedy (instead of Hungarian) label mapping."""

    def __call__(self, reference: Annotation, hypothesis: Annotation,
                 uem: Optional[Timeline] = None, detailed: bool = False):
        # the greedy mapping uses the SAME extruded scoring region as the
        # component sweep (collar + skip_overlap)
        uem2 = _scoring_uem(reference, hypothesis, self.collar, uem,
                            skip_overlap=self.skip_overlap)
        mat, ref_labels, hyp_labels = cooccurrence_matrix(
            reference, hypothesis, uem=uem2)
        mapping = {}
        m = mat.copy()
        while m.size and m.max() > 0:
            i, j = np.unravel_index(np.argmax(m), m.shape)
            mapping[hyp_labels[j]] = ref_labels[i]
            m[i, :] = -1
            m[:, j] = -1
        comp = diarization_error_rate_components(
            reference, hypothesis, uem=uem, collar=self.collar,
            skip_overlap=self.skip_overlap, mapping=mapping)
        self.components_ += comp
        self.uris_.append(reference.uri)
        if detailed:
            return {
                "diarization error rate": comp.der,
                "false alarm": comp.false_alarm,
                "missed detection": comp.missed_detection,
                "confusion": comp.confusion,
                "total": comp.total,
            }
        return comp.der
