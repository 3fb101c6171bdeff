"""Plain count, reconstruction and annotation, in NumPy.

pyannote.audio's ``speaker_count``, ``reconstruct`` / ``to_diarization``
and ``Binarize`` (onset 0.5, no minimum durations), written from their
description for chunk-level binarized scores on a frame grid whose chunk
k starts at output frame ``offsets[k]``: overlap-add without weights,
the count rounded half to even, per cluster the maximum of its local
speakers' scores, and in each frame the ``count`` loudest clusters active
(ties to the lower index; the exclusive variant at most one). A segment
runs from its first active frame's centre to its first inactive frame's
centre (the last frame's centre at the end); labels are SPEAKER_00, ...
in cluster order over the clusters that have a segment.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np


def frame_offsets(num_chunks: int, chunk_step: float, frame_step: float
                  ) -> np.ndarray:
    t = np.arange(num_chunks) * chunk_step
    return np.rint(t / frame_step).astype(np.int64)


def num_output_frames(num_chunks: int, chunk_duration: float,
                      chunk_step: float, frame_step: float) -> int:
    end = chunk_duration + (num_chunks - 1) * chunk_step
    return int(np.rint(end / frame_step)) + 1


def overlap_add(scores: np.ndarray, offsets: np.ndarray, frames: int
                ) -> Tuple[np.ndarray, np.ndarray]:
    """(C, F, K) -> summed (frames, K) and the number of chunks covering
    each frame."""
    C, F, K = scores.shape
    total = np.zeros((frames, K))
    weight = np.zeros((frames, 1))
    for c in range(C):
        n = min(F, frames - offsets[c])
        total[offsets[c]:offsets[c] + n] += scores[c, :n]
        weight[offsets[c]:offsets[c] + n] += 1.0
    return total, weight


def speaker_count(binarized: np.ndarray, offsets: np.ndarray, frames: int
                  ) -> np.ndarray:
    total, weight = overlap_add(binarized.sum(axis=2, keepdims=True),
                                offsets, frames)
    average = np.where(weight > 0, total / np.maximum(weight, 1e-12), 0.0)
    return np.rint(average)[:, 0].astype(np.int64)


def reconstruct(binarized: np.ndarray, hard: np.ndarray, count: np.ndarray,
                offsets: np.ndarray, frames: int
                ) -> Tuple[np.ndarray, np.ndarray]:
    """(frames, K) normal and exclusive discrete diarizations."""
    C, F, S = binarized.shape
    K = max(int(hard.max()) + 1, int(count.max()) if len(count) else 0, 1)
    clustered = np.full((C, F, K), -np.inf)
    for k in range(K):
        member = hard == k                                   # (C, S)
        clustered[..., k] = np.where(member[:, None, :], binarized,
                                     -np.inf).max(axis=2)
    has = np.isfinite(clustered)
    total, weight = overlap_add(np.where(has, clustered, 0.0), offsets,
                                frames)
    covered, _ = overlap_add(has.astype(np.float64), offsets, frames)
    activation = np.where(covered > 0, total, 0.0)
    order = np.argsort(-activation, axis=1, kind="stable")
    ranks = np.empty_like(order)
    np.put_along_axis(ranks, order, np.broadcast_to(
        np.arange(K), order.shape).copy(), axis=1)
    return ranks < count[:, None], ranks < np.minimum(count, 1)[:, None]


def runs(binary: np.ndarray, frame_duration: float, frame_step: float
         ) -> List[List[Tuple[float, float]]]:
    """Per cluster, the (start, end) of each run of active frames."""
    frames, K = binary.shape
    t0 = 0.5 * frame_duration
    out = []
    for k in range(K):
        on = np.concatenate([[False], binary[:, k], [False]])
        starts = np.nonzero(~on[:-1] & on[1:])[0]
        ends = np.minimum(np.nonzero(on[:-1] & ~on[1:])[0], frames - 1)
        out.append([(t0 + a * frame_step, t0 + b * frame_step)
                    for a, b in zip(starts, ends) if b > a])
    return out


def segments(binary: np.ndarray, frame_duration: float, frame_step: float,
             named: np.ndarray = None) -> List[Tuple[float, float, str]]:
    """(start, end, label) of each run of active frames. Labels go to
    the clusters that have a run in ``named`` (the normal diarization,
    whose labels the exclusive one takes; ``binary`` itself by default)
    in the order of their indices' decimal strings, as pyannote.core's
    ``Annotation.labels`` sorts them (``key=str``: 10 before 2)."""
    named = binary if named is None else named
    present = sorted((k for k, r in enumerate(runs(named, frame_duration,
                                                   frame_step)) if r),
                     key=str)
    label = {k: f"SPEAKER_{i:02d}" for i, k in enumerate(present)}
    return sorted((a, b, label[k]) for k, r in enumerate(
        runs(binary, frame_duration, frame_step)) for a, b in r)
