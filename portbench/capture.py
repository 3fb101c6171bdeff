"""What the benchmark reads from the program, set from outside it.

A ``Capture`` puts wrappers on one pipeline instance (instance attributes
only; ``remove`` takes them off). Which calls it wraps, under which span
labels, and what it keeps for the check is the configuration's
(``install(capture, pipeline)`` in its module; ``portbench/diarization.py``
for the diarization pipelines). It holds:

- ``spans``: host seconds by label, summed over every call timed under
  it, and ``intervals``, each call's (start, end, label) on the host
  clock, which label the traced run's idle gaps;
- ``files``: what the check reads, by file URI (``current`` is the file
  the calls belong to, as the configuration's wrappers set it).

With ``ranges`` set, each timed call also runs inside a
``torch.profiler.record_function`` range named ``portbench.<label>``,
which the traced run's readers use to attribute device time.
"""

from __future__ import annotations

import time
from collections import defaultdict
from typing import Any, Callable, Dict, List, Tuple

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

    def wrap(self, owner, name: str, make: Callable) -> None:
        """``owner.name`` replaced by ``make(original)`` on the instance."""
        original = getattr(owner, name)
        self._installed.append((owner, name, name in owner.__dict__,
                                owner.__dict__.get(name)))
        setattr(owner, name, make(original))

    def timed(self, label: str, fn: Callable) -> Callable:
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

    def time(self, owner, name: str, label: str) -> None:
        """``owner.name`` timed under ``label``."""
        self.wrap(owner, name, lambda f: self.timed(label, f))

    def install(self, pipeline) -> "Capture":
        """The diarization pipelines' capture points
        (``portbench/diarization.py``), as ``tools/pipeline_spans.py``
        asks for them; the harness asks the configuration module."""
        from portbench.diarization import install
        install(self, pipeline)
        return self

    def remove(self) -> None:
        for owner, name, own, value in reversed(self._installed):
            if own:
                setattr(owner, name, value)
            else:
                delattr(owner, name)
        self._installed = []
