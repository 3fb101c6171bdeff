"""Spans and device units of the port's pipelines, recorded on demand.

Off by default. ``span(name, file=None, wait=False)`` is a context manager
that the pipelines open around their layers; while no recording is on it
hands back one shared no-op object after a single test of a module-level
pointer, and does nothing else. An operator turns recording on for a
stretch of work::

    from pyannote_audio_tpu_torch.telemetry import spans
    with spans.recording() as rec:
        pipeline(files)
    rec.totals()        # {path: seconds}
    rec.units           # the device units, on the host clock

While a recording is on, each span keeps its name, its path, its parent
(the enclosing span on the same thread), the file's ``uri`` (its parent's
where not given), the thread, its start and end from
``time.perf_counter_ns()`` and whether it is a wait (the thread blocked:
on the card, or on a worker thread). A span's path is its parent's path
and its name joined by "/", except that the pipeline's call spans
(``CALLS``: ``apply`` for one file, ``apply_batch`` for a list) start no
path: ``stage`` and ``finalize/clustering/vbx`` read the same under either
call, or with none. While a ``torch.profiler`` profile is active a span
also opens a ``record_function`` range named by its path.
``Recording.wall_profiler_offset`` puts the recording's times on the
profiler's base: the profiler counts wall-clock time from the trace's
start, and the recording keeps the wall clock's offset from its own.

Device units: ``device_mark(device)`` records a timing-enabled CUDA event
on the device's current stream (None off the card or while not
recording), and ``device_unit(name, file, start, end)`` keeps the work
queued between two such events as one unit of the file. The recording
maps event times onto its host clock through one anchor, an event
recorded on an idle stream when the device is first marked, so a unit's
interval is where the stream ran it. The diarization pipeline's units are
a file's staged program (``stage``) and its reconstruction
(``reconstruct``); one stream runs them in order, so the time between one
unit's end and the next one's start is time when the card had nothing of
the pipeline's to run. The separation pipeline's units are a file's
``separate`` (the model over every chunk) and ``overlap_add``.

Counters: ``counter(name, value)`` adds ``value`` to the recording's
``counters[name]``, ``counter(name, value, peak=True)`` keeps the largest
value seen; nothing while no recording is on.
``tools/pipeline_spans.py`` reads a recording: self times, idle shares
and gaps, the gaps' labels, the counters.
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections.abc import Mapping
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Tuple

import torch

# the spans that stand for a whole call into a pipeline; paths start below
CALLS = frozenset({"apply", "apply_batch"})

# the Recording while one is on; the only state the spans test when off
_RECORDER: Optional["Recording"] = None
_LOCAL = threading.local()


class _Off:
    """The span handed out while nothing is recorded."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


OFF = _Off()


def span(name: str, file=None, wait: bool = False):
    """A context manager around one stretch of a pipeline's work on this
    thread: ``file`` is the file dict (or its uri) it serves, ``wait``
    marks a stretch in which the thread only waits."""
    if _RECORDER is None:
        return OFF
    return Span(_RECORDER, name, file, wait)


def _stack() -> list:
    stack = getattr(_LOCAL, "stack", None)
    if stack is None:
        stack = _LOCAL.stack = []
    return stack


def _uri(file) -> Optional[str]:
    if isinstance(file, Mapping):
        return file.get("uri")
    return file


class Span:
    """One recorded span; ``end_ns`` is None until it closes."""

    __slots__ = ("name", "path", "parent", "uri", "thread", "start_ns",
                 "end_ns", "wait", "ranged", "_range", "_recording")

    def __init__(self, recording: "Recording", name: str, file, wait: bool):
        self._recording = recording
        self.name, self.uri, self.wait = name, _uri(file), wait
        self.end_ns = None
        self._range = None

    def __enter__(self):
        stack = _stack()
        parent = stack[-1] if stack else None
        self.parent = parent
        if self.uri is None and parent is not None:
            self.uri = parent.uri
        self.path = self.name if parent is None or parent.name in CALLS \
            else f"{parent.path}/{self.name}"
        self.thread = threading.get_ident()
        self.ranged = torch._C._autograd._profiler_enabled()
        if self.ranged:
            self._range = torch.profiler.record_function(self.path)
            self._range.__enter__()
        stack.append(self)
        self._recording.spans.append(self)
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.end_ns = time.perf_counter_ns()
        _stack().pop()
        if self._range is not None:
            self._range.__exit__(*exc)
            self._range = None
        return False

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-9

    def __repr__(self) -> str:
        return (f"Span({self.path!r}, uri={self.uri!r}, wait={self.wait}, "
                f"{self.start_ns}..{self.end_ns})")


@dataclass(frozen=True)
class Unit:
    """Device work of one file between two events, on the host clock."""

    name: str
    uri: Optional[str]
    device: int
    start_ns: int
    end_ns: int


def device_mark(device: torch.device) -> Optional["torch.cuda.Event"]:
    """A timing event recorded now on ``device``'s current stream while a
    recording is on and ``device`` is a CUDA device, else None."""
    recording = _RECORDER
    if recording is None or device.type != "cuda":
        return None
    return recording.mark(device)


def device_unit(name: str, file, start, end) -> None:
    """Keep the device work queued between the events ``start`` (from
    ``device_mark``) and ``end`` (a timing event recorded after it on the
    same stream) as one unit of ``file``; nothing when ``start`` is
    None."""
    recording = _RECORDER
    if start is None or recording is None:
        return
    recording.add_unit(name, file, start, end)


def counter(name: str, value: int, peak: bool = False) -> None:
    """Add ``value`` to the counter ``name`` (keep the largest with
    ``peak``) while a recording is on."""
    recording = _RECORDER
    if recording is not None:
        recording.count(name, value, peak)


@contextlib.contextmanager
def recording() -> Iterator["Recording"]:
    """Record spans and device units inside the block. Inside another
    recording this one is that recording, left on at the end. The units'
    times are resolved when the block ends (it waits for the events)."""
    global _RECORDER
    if _RECORDER is not None:
        yield _RECORDER
        return
    rec = Recording()
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        rec._anchor(torch.device("cuda", torch.cuda.current_device()))
    _RECORDER = rec
    try:
        yield rec
    finally:
        _RECORDER = None
        rec.resolve()


def _wall_offset() -> int:
    """``time.time_ns()`` less ``time.perf_counter_ns()``, from the
    tightest of a few bracketed readings."""
    best = None
    for _ in range(5):
        before = time.perf_counter_ns()
        wall = time.time_ns()
        after = time.perf_counter_ns()
        if best is None or after - before < best[0]:
            best = (after - before, wall - (before + after) // 2)
    return best[1]


class Recording:
    """What one ``recording()`` saw: ``spans`` in the order they opened,
    ``units`` once resolved, ``counters`` by name."""

    def __init__(self):
        self.spans: List[Span] = []
        self.units: List[Unit] = []
        self.counters: Dict[str, int] = {}
        self._pending: list = []
        # id of a marked event -> its device index, until its unit is kept
        self._marked: Dict[int, int] = {}
        # device index -> (event, host ns) of its anchor
        self._anchors: Dict[int, Tuple[object, int]] = {}
        # the wall clock (time.time_ns) less this recording's clock
        self.wall_offset_ns = _wall_offset()

    def count(self, name: str, value: int, peak: bool = False) -> None:
        if peak:
            self.counters[name] = max(self.counters.get(name, value), value)
        else:
            self.counters[name] = self.counters.get(name, 0) + value

    # -- device units ---------------------------------------------------------

    def _anchor(self, device: torch.device) -> int:
        """The device's index, its anchor taken on first use: an event
        recorded on the idle stream and the host time it ran at."""
        index = device.index if device.index is not None \
            else torch.cuda.current_device()
        if index not in self._anchors:
            torch.cuda.synchronize(index)
            event = torch.cuda.Event(enable_timing=True)
            before = time.perf_counter_ns()
            event.record(torch.cuda.current_stream(index))
            event.synchronize()
            self._anchors[index] = (event,
                                    (before + time.perf_counter_ns()) // 2)
        return index

    def mark(self, device: torch.device):
        index = self._anchor(device)
        event = torch.cuda.Event(enable_timing=True)
        event.record(torch.cuda.current_stream(index))
        self._marked[id(event)] = index
        return event

    def add_unit(self, name: str, file, start, end) -> None:
        self._pending.append((name, _uri(file), self._marked.pop(id(start)),
                              start, end))

    def resolve(self) -> List[Unit]:
        """Wait for the pending units' events and put them on the host
        clock from the device's anchor."""
        for name, uri, index, start, end in self._pending:
            anchor, host = self._anchors[index]
            end.synchronize()
            self.units.append(Unit(
                name, uri, index,
                host + round(anchor.elapsed_time(start) * 1e6),
                host + round(anchor.elapsed_time(end) * 1e6)))
        self._pending = []
        self.units.sort(key=lambda u: u.start_ns)
        return self.units

    # -- reading --------------------------------------------------------------

    def closed(self, start_ns: Optional[int] = None,
               end_ns: Optional[int] = None) -> List[Span]:
        """The closed spans, those that lie within [start_ns, end_ns]
        where given."""
        return [s for s in self.spans if s.end_ns is not None
                and (start_ns is None or s.start_ns >= start_ns)
                and (end_ns is None or s.end_ns <= end_ns)]

    def totals(self, start_ns: Optional[int] = None,
               end_ns: Optional[int] = None) -> Dict[str, float]:
        """Seconds by path over the closed spans (within the window)."""
        out: Dict[str, float] = {}
        for s in self.closed(start_ns, end_ns):
            out[s.path] = out.get(s.path, 0.0) + s.seconds
        return out

    def wall_profiler_offset(self, prof) -> int:
        """Nanoseconds to add to a recorded time to put it on the base of
        ``prof.events()``' ``time_range`` (microseconds since the trace
        began, times 1000): the profiler counts wall-clock time from the
        trace's start."""
        return self.wall_offset_ns - \
            prof.profiler.kineto_results.trace_start_ns()
