"""A local stand-in for the pyannoteAI API.

Counterpart of pyannote_audio_tpu/pipelines/pyannoteai/local.py: the
``SDK``'s interface backed by the open-source ``SpeakerDiarization``
pipeline, so code written against the cloud API runs unchanged.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from ...core.io import AudioFile
from ...core.pipeline import Pipeline
from ..speaker_diarization import DiarizeOutput, SpeakerDiarization


class Local(Pipeline):
    """``pipeline`` is a ``SpeakerDiarization``, or what
    ``Pipeline.from_pretrained`` loads one from (a local snapshot
    directory, a ``config.yaml`` or a config dict), on ``device`` (the
    CUDA card by default)."""

    def __init__(self, pipeline: Union[SpeakerDiarization, str, dict],
                 device: Optional[Union[str, torch.device]] = None,
                 **kwargs):
        super().__init__()
        if isinstance(pipeline, SpeakerDiarization):
            self._pipeline = pipeline
        else:
            loaded = Pipeline.from_pretrained(pipeline, device=device)
            if not isinstance(loaded, SpeakerDiarization):
                raise ValueError(
                    "Local expects a SpeakerDiarization pipeline")
            self._pipeline = loaded

    def apply(self, file: AudioFile, num_speakers: Optional[int] = None,
              min_speakers: Optional[int] = None,
              max_speakers: Optional[int] = None,
              hook=None) -> DiarizeOutput:
        return self._pipeline.apply(
            self._pipeline.prepare_one(file), num_speakers=num_speakers,
            min_speakers=min_speakers, max_speakers=max_speakers,
            hook=hook)
