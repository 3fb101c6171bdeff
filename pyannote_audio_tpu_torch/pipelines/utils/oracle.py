"""Oracle segmentation: what a perfect segmentation model would output.

Counterpart of pyannote_audio_tpu/pipelines/utils/oracle.py: the reference
annotation of a file, discretized over each sliding chunk at the model's
frame resolution.
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np

from ...core.annotation import Annotation
from ...core.io import Audio
from ...core.segment import Segment, SlidingWindow, SlidingWindowFeature


def oracle_segmentation(file, window: SlidingWindow,
                        frames: Union[SlidingWindow, float],
                        num_speakers: Optional[int] = None
                        ) -> SlidingWindowFeature:
    """(num_chunks, num_frames, num_speakers) binary scores from
    ``file["annotation"]``, one chunk per window over the file (the last
    one aligned on its end)."""
    if "annotation" not in file:
        raise ValueError("file must provide an 'annotation' key")
    annotation: Annotation = file["annotation"]
    duration = file.get("duration") or Audio().get_duration(file)
    if not isinstance(frames, SlidingWindow):
        frames = SlidingWindow(duration=frames, step=frames)

    labels = annotation.labels()
    if num_speakers is None:
        num_speakers = len(labels)

    window_frames = frames.samples(window.duration, mode="center")
    segmentations = []
    for chunk in window(Segment(0.0, duration), align_last=True):
        data = np.zeros((window_frames, num_speakers), dtype=np.float32)
        for seg, _, label in annotation.crop(chunk).itertracks(
                yield_label=True):
            k = labels.index(label)
            if k >= num_speakers:
                continue
            i0 = int(np.rint((seg.start - chunk.start) / frames.step))
            i1 = int(np.rint((seg.end - chunk.start) / frames.step))
            data[max(i0, 0):min(i1, window_frames), k] = 1.0
        segmentations.append(data)
    return SlidingWindowFeature(np.stack(segmentations), window,
                                labels=labels[:num_speakers])
