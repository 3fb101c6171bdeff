"""Pipeline base: hyperparameters set by ``instantiate``, hooks, file or
list input.

Counterpart of the part of pyannote_audio_tpu/core/pipeline.py that the
diarization path uses. Hyperparameters are plain attributes (a dict value
becomes an attribute-access dict; a value for a sub-pipeline is passed
on to its ``instantiate``). A list of files goes to the subclass's
``apply_batch`` when it has one, else through ``apply`` one file after
another while a worker thread decodes the next. Config-file loading
(``from_pretrained``) and hyperparameter search spaces are not ported yet.
"""

from __future__ import annotations

import functools
import threading
from collections.abc import Mapping, MutableMapping
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Union

import torch

from .inference import pin_waveform
from .io import Audio, AudioFile


class _DotDict(dict):
    """Attribute access over an instantiated dict of hyperparameters."""

    __getattr__ = dict.__getitem__


class Pipeline:
    """Base class: ``apply(file, hook=None, **kwargs)`` is the subclass's
    work."""

    instantiated = False

    def default_parameters(self) -> Dict[str, Any]:
        raise NotImplementedError(
            f"{type(self).__name__} has no default parameters")

    def instantiate(self, params: Mapping) -> "Pipeline":
        """Set concrete hyperparameter values; dicts merge into the
        current ones."""
        for name, value in params.items():
            current = getattr(self, name, None)
            if isinstance(current, Pipeline):
                current.instantiate(value)
            elif isinstance(value, Mapping):
                merged = dict(current) if isinstance(current, Mapping) \
                    else {}
                merged.update(value)
                setattr(self, name, _DotDict(merged))
            else:
                setattr(self, name, value)
        self.instantiated = True
        return self

    def default_hook(self) -> Callable:
        def hook(step_name, step_artifact, file=None, total=None,
                 completed=None):
            pass
        return hook

    def setup_hook(self, file: AudioFile,
                   hook: Optional[Callable] = None) -> Callable:
        """``hook`` with ``file`` bound into every call, or a no-op."""
        if hook is None:
            return lambda *args, **kwargs: None
        return functools.partial(hook, file=file)

    def __call__(self, file: Union[AudioFile, List[AudioFile]],
                 hook: Optional[Callable] = None, **kwargs):
        """Apply to one file, or to a list (any iterable that is not a
        path or a mapping) of files through ``_apply_batch``."""
        if not self.instantiated:
            self.instantiate(self.default_parameters())
        if isinstance(file, (list, tuple)) or (
                hasattr(file, "__iter__")
                and not isinstance(file, (str, Path, Mapping))
                and not hasattr(file, "read")):
            return self._apply_batch(list(file), hook=hook, **kwargs)
        file = Audio.validate_file(file)
        # stateful hooks (TimingHook, ArtifactHook) write into the file
        return self.apply(file, hook=self.setup_hook(file, hook), **kwargs)

    def _apply_batch(self, files: List[AudioFile],
                     hook: Optional[Callable] = None, **kwargs):
        """Apply to a list of files.

        A subclass with an ``apply_batch`` gets the validated files. One
        that streams its own decode (``STREAMS_DECODE``) gets them as they
        are; any other would first get them decoded by
        ``_predecode_batch``. Without ``apply_batch`` the files run through
        ``apply`` one after another while a worker thread decodes the
        next, and each file's device buffers (and the host waveform this
        machinery decoded) are dropped once it is done: the list keeps
        every dict alive until the end.
        """
        files = [Audio.validate_file(f) for f in files]
        apply_batch = getattr(self, "apply_batch", None)
        if apply_batch is not None:
            if not getattr(self, "STREAMS_DECODE", False):
                self._predecode_batch(files)
            return apply_batch(files, hook=hook, **kwargs)

        prefetch: Dict[int, threading.Thread] = {}
        results = []
        try:
            for i, f in enumerate(files):
                t = prefetch.pop(i, None)
                if t is not None:
                    t.join()
                else:
                    self._decode_into(f)
                if i + 1 < len(files):
                    t = threading.Thread(target=self._decode_into,
                                         args=(files[i + 1],), daemon=True)
                    t.start()
                    prefetch[i + 1] = t
                results.append(self.apply(f, hook=self.setup_hook(f, hook),
                                          **kwargs))
                _evict(f)
        finally:
            for t in prefetch.values():
                t.join()
        return results

    def _decode_into(self, f, preload: bool = True) -> None:
        """Decode a path-backed file dict in place (safe in a worker
        thread: host work only, unless ``preload``).

        Sets ``waveform``, ``sample_rate`` and the ``_batch_decoded``
        marker, which lets batch eviction drop the waveform again. For a
        pipeline on a CUDA device the waveform lands in page-locked memory,
        so its upload need not wait. Decode errors are left to the
        consumer, which decodes again and raises the real exception.
        ``preload`` also starts the file's upload (``self.preload``);
        pipelines that order uploads themselves pass False.
        """
        audio = getattr(self, "_audio", None) or Audio(sample_rate=16000)
        if isinstance(f, MutableMapping) and "waveform" not in f \
                and isinstance(f.get("audio"), (str, Path)):
            try:
                waveform, sample_rate = audio(f)
            except (ValueError, OSError):
                return
            device = getattr(self, "device", None)
            if device is not None and torch.device(device).type == "cuda":
                waveform = pin_waveform(waveform)
            f["waveform"] = waveform
            f["sample_rate"] = sample_rate
            f["_batch_decoded"] = True
        if preload:
            try:
                self.preload(f)
            except (ValueError, OSError):
                pass               # the consumer uploads and raises

    def _predecode_batch(self, files: List[Dict]) -> None:
        """Decode a batch's path-backed files ahead of ``apply_batch``.

        The JAX package decodes them in parallel with its native C++
        decoder here. That decoder is not ported yet, so this does
        nothing: files decode where they are consumed.
        """

    def preload(self, file: Dict) -> None:
        """Start a file's device upload early; subclasses with a device
        path override this."""

    def apply(self, file: Dict, hook: Optional[Callable] = None, **kwargs):
        raise NotImplementedError


def _evict(f) -> None:
    """Drop a finished file's device buffers and, for a dict the batch
    machinery decoded itself, its host waveform. A waveform that came
    with the dict stays."""
    if isinstance(f, MutableMapping):
        f.pop("_device_waveform", None)
        f.pop("_longfile_uploads", None)
        if f.pop("_batch_decoded", None):
            f.pop("waveform", None)
            f.pop("sample_rate", None)
