"""pyannoteAI cloud API wrapper.

Counterpart of pyannote_audio_tpu/pipelines/pyannoteai/sdk.py: ``SDK``
uploads a file, runs a diarization job and reads its output back as a
``DiarizeOutput``, through the REST client of ``client.py`` (whose base
url may point at a self-hosted ``serve.DiarizationServer``). Reaching the
public endpoint needs network access.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

from ...core.annotation import Annotation
from ...core.io import AudioFile
from ...core.pipeline import Pipeline
from ...core.segment import Segment
from ..speaker_diarization import DiarizeOutput
from .client import Client


class SDK(Pipeline):
    """Speaker diarization through the pyannoteAI web API.

    Parameters
    ----------
    model : str, optional
        pyannoteAI diarization model (default "precision-2").
    token : str, optional
        API key; defaults to the PYANNOTEAI_API_KEY environment variable.

    Usage
    -----
    >>> pipeline = SDK(token="{PYANNOTEAI_API_KEY}")
    >>> output = pipeline("/path/to/audio.wav")
    """

    def __init__(self, model: str = "precision-2",
                 token: Optional[str] = None, **kwargs):
        super().__init__()
        self.model = model
        self.token = token or os.environ.get("PYANNOTEAI_API_KEY")
        self._client: Optional[Client] = None

    @property
    def client(self) -> Client:
        if self._client is None:
            self._client = Client(self.token)
        return self._client

    def _deserialize(self, diarization: List[Dict]) -> Annotation:
        annotation = Annotation()
        for turn in diarization:
            segment = Segment(turn["start"], turn["end"])
            annotation[segment, annotation.new_track(segment)] = \
                turn["speaker"]
        return annotation

    def apply(self, file: AudioFile, hook=None,
              num_speakers: Optional[int] = None,
              min_speakers: Optional[int] = None,
              max_speakers: Optional[int] = None) -> DiarizeOutput:
        """Upload `file`, run a diarization job, deserialize its output.

        Raises PyannoteAIFailedJob / PyannoteAICanceledJob on job
        failure, urllib's HTTPError on transport errors. ``hook`` is
        accepted for the base Pipeline.__call__ contract (remote jobs
        expose no step-level progress, so it is unused).
        """
        del hook
        if self.token is None:
            raise RuntimeError(
                "pyannoteAI API key missing: set PYANNOTEAI_API_KEY or "
                "pass token=...")
        media_url = self.client.upload(file)
        job_id = self.client.diarize(
            media_url, num_speakers=num_speakers,
            min_speakers=min_speakers, max_speakers=max_speakers,
            confidence=False, model=self.model, exclusive=True)
        job_output = self.client.retrieve(job_id)
        output = job_output["output"]
        return DiarizeOutput(
            speaker_diarization=self._deserialize(output["diarization"]),
            exclusive_speaker_diarization=self._deserialize(
                output["exclusiveDiarization"]),
        )
