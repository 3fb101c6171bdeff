"""Pipelines. ``SpeakerDiarization`` is importable from here, the path a
config's ``pipeline.name`` gives (``pyannote.audio.pipelines.
SpeakerDiarization``); it is imported on first access."""

_LAZY = {"SpeakerDiarization": ".speaker_diarization"}


def __getattr__(name):
    if name in _LAZY:
        import importlib
        return getattr(importlib.import_module(_LAZY[name], __name__), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
