"""Pipelines, importable from here, the path a config's ``pipeline.name``
gives (``pyannote.audio.pipelines.SpeakerDiarization``,
``...SpeakerEmbedding``, ``...SpeechSeparation``, ...); each is
imported on first access."""

_LAZY = {"SpeakerDiarization": ".speaker_diarization",
         "VoiceActivityDetection": ".voice_activity_detection",
         "OracleVoiceActivityDetection": ".voice_activity_detection",
         "MultiLabelSegmentation": ".multilabel",
         "SpeakerEmbedding": ".speaker_verification",
         "PretrainedSpeakerEmbedding": ".speaker_verification",
         "SpeechSeparation": ".speech_separation"}


def __getattr__(name):
    if name in _LAZY:
        import importlib
        return getattr(importlib.import_module(_LAZY[name], __name__), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
