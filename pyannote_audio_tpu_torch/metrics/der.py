"""Diarization error rate: an exact interval sweep on the host.

Counterpart of pyannote_audio_tpu/metrics/der.py (the reference's
``pyannote.metrics``): ``cooccurrence_matrix``, the Hungarian
``optimal_mapping`` that renames a hypothesis after a reference
annotation, ``DiarizationErrorRate`` and ``GreedyDiarizationErrorRate``
with their component sweep, ``JaccardErrorRate``, the detection metrics
of voice activity detection (``DetectionErrorRate``,
``DetectionPrecisionRecallFMeasure``) and the ``IdentificationErrorRate``
of multilabel segmentation.
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


def _timeline_overlap_durations(a: Timeline, b: Timeline,
                                uem: Optional[Timeline] = None
                                ) -> Tuple[float, float, float]:
    """(intersection, a_only, b_only) durations via a boundary sweep."""
    pts = set()
    for tl in (a, b):
        for s in tl:
            pts.add(s.start)
            pts.add(s.end)
    if uem is not None:
        for s in uem:
            pts.add(s.start)
            pts.add(s.end)
    pts = np.array(sorted(pts))
    inter = a_only = b_only = 0.0
    for lo, hi in zip(pts[:-1], pts[1:]):
        mid, dur = 0.5 * (lo + hi), hi - lo
        if dur <= 0:
            continue
        if uem is not None and not any(
                s.start <= mid < s.end for s in uem):
            continue
        in_a = any(s.start <= mid < s.end for s in a)
        in_b = any(s.start <= mid < s.end for s in b)
        if in_a and in_b:
            inter += dur
        elif in_a:
            a_only += dur
        elif in_b:
            b_only += dur
    return inter, a_only, b_only


class JaccardErrorRate:
    """Jaccard error rate (DIHARD): per-reference-speaker Jaccard distance
    to the optimally mapped system speaker, averaged over reference
    speakers. For each reference speaker r with Hungarian-mapped system
    speaker s,
    JER_r = 1 - |r ∩ s| / |r ∪ s| (durations); unmapped reference speakers
    score 1.0. The corpus value averages over every reference speaker seen.
    """

    def __init__(self, collar: float = 0.0, skip_overlap: bool = False):
        self.collar = collar
        self.skip_overlap = skip_overlap
        self.speaker_error_ = 0.0
        self.speaker_count_ = 0
        self.uris_: List[str] = []

    def __call__(self, reference: Annotation, hypothesis: Annotation,
                 uem: Optional[Timeline] = None, detailed: bool = False):
        uem2 = _scoring_uem(reference, hypothesis, self.collar, uem,
                            skip_overlap=self.skip_overlap)
        if uem2 is not None:
            uem2 = uem2.support()
            # crop both annotations to the scoring region first: a
            # reference speaker whose every turn falls outside the
            # uem/collar is not counted
            reference = reference.crop(uem2, mode="intersection")
            hypothesis = hypothesis.crop(uem2, mode="intersection")
        mapping = optimal_mapping(reference, hypothesis, uem=uem2)
        ref_of_hyp = dict(mapping)              # hyp label -> ref label
        hyp_of_ref = {r: h for h, r in ref_of_hyp.items()}
        error = 0.0
        count = 0
        for ref_speaker in reference.labels():
            ref_tl = reference.label_timeline(ref_speaker).support()
            count += 1
            hyp_speaker = hyp_of_ref.get(ref_speaker)
            if hyp_speaker is None:
                error += 1.0
                continue
            hyp_tl = hypothesis.label_timeline(hyp_speaker).support()
            inter, a_only, b_only = _timeline_overlap_durations(
                ref_tl, hyp_tl, uem=uem2)
            union = inter + a_only + b_only
            error += (union - inter) / union if union > 0 else 0.0
        self.speaker_error_ += error
        self.speaker_count_ += count
        self.uris_.append(reference.uri)
        rate = error / count if count else 0.0
        if detailed:
            return {"jaccard error rate": rate, "speaker error": error,
                    "speaker count": count}
        return rate

    def __abs__(self) -> float:
        return self.speaker_error_ / self.speaker_count_ \
            if self.speaker_count_ else 0.0

    def reset(self) -> None:
        self.speaker_error_ = 0.0
        self.speaker_count_ = 0
        self.uris_ = []

    def report(self) -> Dict[str, float]:
        return {"jaccard error rate": abs(self),
                "speaker error": self.speaker_error_,
                "speaker count": self.speaker_count_}


def detection_error_rate(reference: Annotation, hypothesis: Annotation,
                         uem: Optional[Timeline] = None) -> float:
    """Speech-activity detection error (any-speaker vs any-speaker)."""
    fa, miss, total = _detection_components(reference, hypothesis, uem)
    return _rate(fa + miss, total)


def _rate(errors: float, total: float) -> float:
    """errors/total with the empty-reference convention of
    DERComponents.der: a file with no reference speech scores 0.0 only
    when the hypothesis made no errors either, inf otherwise — an
    always-on detector must not look perfect on noise-only files."""
    if total > 0:
        return errors / total
    return 0.0 if errors == 0.0 else np.inf


def _detection_components(reference: Annotation, hypothesis: Annotation,
                          uem: Optional[Timeline] = None
                          ) -> Tuple[float, float, float]:
    """(false_alarm, missed, total) durations of speech-activity detection."""
    ref = reference.get_timeline().support()
    hyp = hypothesis.get_timeline().support()
    pts = set()
    for tl in (ref, hyp):
        for s in tl:
            pts.add(s.start)
            pts.add(s.end)
    if uem is not None:
        for s in uem:
            pts.add(s.start)
            pts.add(s.end)
    pts = np.array(sorted(pts))
    # support()ed timelines are disjoint+sorted: one pointer sweep each
    inside = _uem_flags(uem.support() if uem is not None else None, pts)
    in_ref = _uem_flags(ref, pts)
    in_hyp = _uem_flags(hyp, pts)
    fa = miss = total = 0.0
    for i in range(len(pts) - 1):
        dur = pts[i + 1] - pts[i]
        if not inside[i]:
            continue
        if in_ref[i]:
            total += dur
            if not in_hyp[i]:
                miss += dur
        elif in_hyp[i]:
            fa += dur
    return fa, miss, total


class DetectionErrorRate:
    """Accumulating detection error rate (what
    VoiceActivityDetection.get_metric returns)."""

    def __init__(self, collar: float = 0.0, skip_overlap: bool = False):
        self.collar = collar
        self.skip_overlap = skip_overlap
        self.fa_ = 0.0
        self.miss_ = 0.0
        self.total_ = 0.0

    def __call__(self, reference: Annotation, hypothesis: Annotation,
                 uem: Optional[Timeline] = None, detailed: bool = False):
        uem = _scoring_uem(reference, hypothesis, self.collar, uem,
                           self.skip_overlap)
        fa, miss, total = _detection_components(reference, hypothesis, uem)
        self.fa_ += fa
        self.miss_ += miss
        self.total_ += total
        rate = _rate(fa + miss, total)
        if detailed:
            return {"detection error rate": rate, "false alarm": fa,
                    "miss": miss, "total": total}
        return rate

    def __abs__(self) -> float:
        return _rate(self.fa_ + self.miss_, self.total_)


class DetectionPrecisionRecallFMeasure:
    """Accumulating detection F-measure (VoiceActivityDetection's
    get_metric with fscore=True)."""

    def __init__(self, collar: float = 0.0, skip_overlap: bool = False):
        self.collar = collar
        self.skip_overlap = skip_overlap
        self.tp_ = 0.0
        self.fp_ = 0.0
        self.fn_ = 0.0

    def __call__(self, reference: Annotation, hypothesis: Annotation,
                 uem: Optional[Timeline] = None, detailed: bool = False):
        uem = _scoring_uem(reference, hypothesis, self.collar, uem,
                           self.skip_overlap)
        fa, miss, total = _detection_components(reference, hypothesis, uem)
        tp = total - miss
        self.tp_ += tp
        self.fp_ += fa
        self.fn_ += miss
        precision = tp / (tp + fa) if tp + fa > 0 else 1.0
        recall = tp / total if total > 0 else 1.0
        f = 2 * precision * recall / (precision + recall) \
            if precision + recall > 0 else 0.0
        if detailed:
            return {"precision": precision, "recall": recall, "fscore": f}
        return f

    def __abs__(self) -> float:
        p = self.tp_ / (self.tp_ + self.fp_) \
            if self.tp_ + self.fp_ > 0 else 1.0
        r = self.tp_ / (self.tp_ + self.fn_) \
            if self.tp_ + self.fn_ > 0 else 1.0
        return 2 * p * r / (p + r) if p + r > 0 else 0.0


class IdentificationErrorRate:
    """Accumulating identification error rate: labels compared directly
    (no optimal mapping), what MultiLabelSegmentation.get_metric returns.

    Per region with reference label set R and hypothesis label set H:
    confusion = min(|R\\H|, |H\\R|), miss = |R\\H| - confusion,
    false alarm = |H\\R| - confusion, total = |R| (duration-weighted).
    """

    def __init__(self, collar: float = 0.0, skip_overlap: bool = False):
        self.collar = collar
        self.skip_overlap = skip_overlap
        self.fa_ = 0.0
        self.miss_ = 0.0
        self.conf_ = 0.0
        self.total_ = 0.0

    @staticmethod
    def _components(reference: Annotation, hypothesis: Annotation,
                    uem: Optional[Timeline] = None):
        pts = set()
        for ann in (reference, hypothesis):
            for seg in ann.get_timeline():
                pts.add(seg.start)
                pts.add(seg.end)
        if uem is not None:
            for s in uem:
                pts.add(s.start)
                pts.add(s.end)
        pts = np.array(sorted(pts))
        inside = _uem_flags(uem.support() if uem is not None else None,
                            pts)
        ref_active = _interval_active_labels(reference, pts)
        hyp_active = _interval_active_labels(hypothesis, pts)
        fa = miss = conf = total = 0.0
        for i in range(len(pts) - 1):
            dur = pts[i + 1] - pts[i]
            if not inside[i]:
                continue
            r = set(ref_active[i])
            h = set(hyp_active[i])
            n_conf = min(len(r - h), len(h - r))
            conf += n_conf * dur
            miss += (len(r - h) - n_conf) * dur
            fa += (len(h - r) - n_conf) * dur
            total += len(r) * dur
        return fa, miss, conf, total

    def __call__(self, reference: Annotation, hypothesis: Annotation,
                 uem: Optional[Timeline] = None, detailed: bool = False):
        uem = _scoring_uem(reference, hypothesis, self.collar, uem,
                           self.skip_overlap)
        fa, miss, conf, total = self._components(reference, hypothesis, uem)
        self.fa_ += fa
        self.miss_ += miss
        self.conf_ += conf
        self.total_ += total
        rate = _rate(fa + miss + conf, total)
        if detailed:
            return {"identification error rate": rate, "false alarm": fa,
                    "missed detection": miss, "confusion": conf,
                    "total": total}
        return rate

    def __abs__(self) -> float:
        return _rate(self.fa_ + self.miss_ + self.conf_, self.total_)
