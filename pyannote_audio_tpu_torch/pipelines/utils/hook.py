"""Pipeline hooks: artifact capture, progress, timing, profiler regions.

Counterpart of pyannote_audio_tpu/pipelines/utils/hook.py. A hook is
called as ``hook(step_name, artifact, file=..., total=..., completed=...)``
at each stage of a pipeline; the pipeline binds ``file`` to the file being
processed, so stateful hooks write into that file's dict.
"""

from __future__ import annotations

import time
from copy import deepcopy
from pathlib import Path
from typing import Any, Mapping, Optional, Text

import torch

from ...telemetry import spans


class ArtifactHook:
    """Capture intermediate artifacts into ``file[file_key]``."""

    def __init__(self, *artifacts: Text, file_key: Text = "artifact"):
        self.artifacts = artifacts
        self.file_key = file_key

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        pass

    def __call__(self, step_name: Text, step_artifact: Any,
                 file: Optional[Mapping] = None, total: Optional[int] = None,
                 completed: Optional[int] = None):
        if step_artifact is None or file is None:
            return
        if self.artifacts and step_name not in self.artifacts:
            return
        file.setdefault(self.file_key, {})[step_name] = \
            deepcopy(step_artifact)


class ProgressHook:
    """One progress bar per pipeline step (needs ``rich``, imported when
    the hook is entered)."""

    def __init__(self, transient: bool = False):
        self.transient = transient
        self._progress = None
        self._task = None
        self._step_name = None

    def __enter__(self):
        from rich.progress import Progress
        self._progress = Progress(transient=self.transient)
        self._progress.__enter__()
        return self

    def __exit__(self, *exc):
        if self._progress is not None:
            self._progress.__exit__(*exc)
            self._progress = None

    def __call__(self, step_name: Text, step_artifact: Any,
                 file: Optional[Mapping] = None, total: Optional[int] = None,
                 completed: Optional[int] = None):
        if self._progress is None:
            return
        if completed is None:
            total = completed = 1
        if step_name != self._step_name:
            self._step_name = step_name
            self._task = self._progress.add_task(step_name,
                                                 total=total or 1)
        self._progress.update(self._task, total=total or 1,
                              completed=completed)
        self._progress.refresh()


class TimingHook:
    """Wall time per step, accumulated and written into
    ``file[file_key]`` at every call."""

    def __init__(self, file_key: Text = "timing"):
        self.file_key = file_key
        self._timing = {}
        self._start = None
        self._current = None
        self._file = None

    def __enter__(self):
        self._timing = {}
        self._current = None
        self._start = time.time()
        self._file = None
        return self

    def __exit__(self, *exc):
        # account for the last step, still open when the pipeline returns
        if self._current is not None and self._file is not None:
            self._timing[self._current] = \
                self._timing.get(self._current, 0.0) + \
                (time.time() - self._start)
            self._current = None
            self._file[self.file_key] = dict(self._timing)

    def __call__(self, step_name: Text, step_artifact: Any,
                 file: Optional[Mapping] = None, total: Optional[int] = None,
                 completed: Optional[int] = None):
        now = time.time()
        if self._current != step_name:
            if self._current is not None:
                # accumulate: a step recurs after others (the embeddings
                # artifact comes after speaker_counting)
                self._timing[self._current] = \
                    self._timing.get(self._current, 0.0) + \
                    (now - self._start)
            self._current = step_name
            self._start = now
        else:
            self._timing[step_name] = \
                self._timing.get(step_name, 0.0) + (now - self._start)
            self._start = now
        if file is not None:
            self._file = file
            file[self.file_key] = dict(self._timing)


class TraceHook:
    """One ``torch.profiler.record_function`` region per pipeline step.

    With a ``log_dir``, entering the hook also starts a
    ``torch.profiler.profile`` of the host and the CUDA device (when
    there is one) and turns span recording on (``telemetry/spans.py``),
    so the pipelines' spans show as ranges beside the steps; leaving it
    writes the Chrome trace ``trace.json`` there and keeps what was
    recorded in ``recording``.
    """

    def __init__(self, log_dir: Optional[Text] = None):
        self.log_dir = log_dir
        self._current = None
        self._span = None
        self._profile = None
        self._recorder = None
        self.recording = None

    def __enter__(self):
        if self.log_dir is not None:
            activities = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            self._profile = torch.profiler.profile(activities=activities)
            self._profile.__enter__()
            self._recorder = spans.recording()
            self.recording = self._recorder.__enter__()
        return self

    def __exit__(self, *exc):
        if self._span is not None:
            self._span.__exit__(None, None, None)
            self._span = None
            self._current = None
        if self._recorder is not None:
            self._recorder.__exit__(*exc)
            self._recorder = None
        if self._profile is not None:
            self._profile.__exit__(*exc)
            Path(self.log_dir).mkdir(parents=True, exist_ok=True)
            self._profile.export_chrome_trace(
                str(Path(self.log_dir) / "trace.json"))
            self._profile = None

    def __call__(self, step_name: Text, step_artifact: Any,
                 file: Optional[Mapping] = None, total: Optional[int] = None,
                 completed: Optional[int] = None):
        if step_name != self._current:
            if self._span is not None:
                self._span.__exit__(None, None, None)
            self._span = torch.profiler.record_function(step_name)
            self._span.__enter__()
            self._current = step_name


class Hooks:
    """Compose several hooks into one callable."""

    def __init__(self, *hooks):
        self.hooks = hooks

    def __enter__(self):
        for hook in self.hooks:
            if hasattr(hook, "__enter__"):
                hook.__enter__()
        return self

    def __exit__(self, *exc):
        for hook in self.hooks:
            if hasattr(hook, "__exit__"):
                hook.__exit__(*exc)

    def __call__(self, *args, **kwargs):
        for hook in self.hooks:
            hook(*args, **kwargs)
