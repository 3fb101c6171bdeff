"""What the benchmark reads from the program, set from outside it.

``Capture.install(pipeline)`` puts wrappers on one ``SpeakerDiarization``
instance (instance attributes only; ``remove`` takes them off):

- ``_stage``, ``_finalize``, ``clustering``, ``_segmentation.slide``,
  ``_start_shared_trunk`` and ``get_embeddings``: host seconds in each
  (the layers' spans) and their intervals, and which file the calls
  inside belong to;
- ``_segmentation._convert``: each batch's raw model output, the
  segmentation log-probs, kept on the device with no copy and no sync;
- ``clustering``: its inputs (embeddings, clean and active frame counts)
  and its hard clusters, copied on the host;
- an SSL trunk's ``forward`` (SSeRiouSS): its last layer's output for
  the first segmentation batch of each file, kept on the device;
- ``_finalize``'s staged dict: the binarized segmentation (on the
  device) and the frame-level count (copied).

With ``ranges`` set, each of those calls also runs inside a
``torch.profiler.record_function`` range named ``portbench.<span>``
(``segmentation``: the slide; ``embedding``: the early shared trunk and
``get_embeddings``; ``stage``, ``finalize``, ``clustering``), which the
traced run's readers use to attribute device time.
"""

from __future__ import annotations

import time
from collections import defaultdict
from typing import Any, Callable, Dict, List, Tuple

import numpy as np
import torch


class Capture:
    def __init__(self, ranges: bool = False):
        self.ranges = ranges
        self.files: Dict[str, Dict[str, Any]] = defaultdict(dict)
        self.spans = defaultdict(float)
        # (start, end, label) on the host clock, for labelling idle gaps
        self.intervals: List[Tuple[float, float, str]] = []
        self.current = None
        self._installed = []

    def _wrap(self, owner, name: str, make: Callable) -> None:
        original = getattr(owner, name)
        self._installed.append((owner, name, name in owner.__dict__,
                                owner.__dict__.get(name)))
        setattr(owner, name, make(original))

    def _timed(self, label: str, fn: Callable) -> Callable:
        """``fn`` with its host seconds added to ``spans[label]``, its
        interval kept, and inside a profiler range with ``ranges``."""
        def run(*args, **kwargs):
            start = time.perf_counter()
            try:
                if self.ranges:
                    with torch.profiler.record_function(
                            f"portbench.{label}"):
                        return fn(*args, **kwargs)
                return fn(*args, **kwargs)
            finally:
                end = time.perf_counter()
                self.spans[label] += end - start
                self.intervals.append((start, end, label))
        return run

    def install(self, pipeline) -> "Capture":
        def stage(original):
            def run(file, *args, **kwargs):
                self.current = file["uri"]
                return original(file, *args, **kwargs)
            return self._timed("stage", run)

        def finalize(original):
            def run(staged):
                uri = staged["file"]["uri"]
                self.current = uri
                out = original(staged)
                record = self.files[uri]
                record["binarized"] = staged["binarized"]
                record["count"] = np.array(staged["host"]["count"])
                return out
            return self._timed("finalize", run)

        def convert(original):
            def run(out):
                self.files[self.current].setdefault("logp", []).append(out)
                return original(out)
            return run

        def clustering(original):
            def run(embeddings, clean_frames, **kwargs):
                out = original(embeddings, clean_frames, **kwargs)
                record = self.files[self.current]
                record["embeddings"] = np.array(embeddings)
                record["clean_frames"] = np.array(clean_frames)
                record["speaker_frames"] = np.array(kwargs["speaker_frames"])
                record["hard"] = np.array(out[0])
                return out
            return self._timed("clustering", run)

        def ssl(original):
            def run(*args, **kwargs):
                states = original(*args, **kwargs)
                self.files[self.current].setdefault("ssl", states[-1])
                return states
            return run

        trunk = getattr(pipeline._segmentation.model, "wav2vec", None)
        if trunk is not None:
            self._wrap(trunk, "forward", ssl)
        self._wrap(pipeline, "_stage", stage)
        self._wrap(pipeline, "_finalize", finalize)
        self._wrap(pipeline._segmentation, "_convert", convert)
        self._wrap(pipeline, "clustering", clustering)
        self._wrap(pipeline._segmentation, "slide",
                   lambda f: self._timed("segmentation", f))
        self._wrap(pipeline, "_start_shared_trunk",
                   lambda f: self._timed("embedding", f))
        self._wrap(pipeline, "get_embeddings",
                   lambda f: self._timed("embedding", f))
        return self

    def remove(self) -> None:
        for owner, name, own, value in reversed(self._installed):
            if own:
                setattr(owner, name, value)
            else:
                delattr(owner, name)
        self._installed = []
