"""Pipeline base: hyperparameters set by ``instantiate``, file or list
input.

Counterpart of the part of pyannote_audio_tpu/core/pipeline.py that the
diarization path uses. Hyperparameters are plain attributes (a dict value
becomes an attribute-access dict; a value for a sub-pipeline is passed
on to its ``instantiate``). Config-file loading (``from_pretrained``)
and hyperparameter search spaces are not ported yet.
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Any, Dict, List, Union

from .io import Audio, AudioFile


class _DotDict(dict):
    """Attribute access over an instantiated dict of hyperparameters."""

    __getattr__ = dict.__getitem__


class Pipeline:
    """Base class: ``apply(file, **kwargs)`` is the subclass's work."""

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

    def __call__(self, file: Union[AudioFile, List[AudioFile]], **kwargs):
        """Apply to one file, or to a list of files one after another."""
        if not self.instantiated:
            self.instantiate(self.default_parameters())
        if isinstance(file, (list, tuple)):
            return [self.apply(Audio.validate_file(f), **kwargs)
                    for f in file]
        return self.apply(Audio.validate_file(file), **kwargs)

    def apply(self, file: Dict, **kwargs):
        raise NotImplementedError
