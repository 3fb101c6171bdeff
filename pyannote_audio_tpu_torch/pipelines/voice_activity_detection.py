"""Voice activity detection pipeline.

Counterpart of pyannote_audio_tpu/pipelines/voice_activity_detection.py:
sliding-window segmentation scores reduced to one "someone speaks" score
(the maximum over the model's classes, as the ``Inference``'s
``pre_aggregation_hook``, on the device), aggregated on the device, then
hysteresis binarization with ``min_duration_on`` / ``_off`` on the host.
Powerset models binarize at onset = offset = 0.5; other models tune both.
``OracleVoiceActivityDetection`` reads the speech regions off the file's
reference annotation.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Union

import torch

from ..core.annotation import Annotation
from ..core.inference import Inference
from ..core.io import AudioFile
from ..core.pipeline import Pipeline
from ..core.segment import SlidingWindowFeature
from ..metrics.der import DetectionErrorRate, DetectionPrecisionRecallFMeasure
from ..utils.runtime import check_device
from ..utils.signal import Binarize
from .parameter import Uniform
from .utils.getter import PipelineModel, get_model


def max_over_classes(scores: torch.Tensor) -> torch.Tensor:
    """(chunks, frames, classes) -> (chunks, frames, 1) maximum."""
    return scores.amax(dim=-1, keepdim=True)


class OracleVoiceActivityDetection(Pipeline):
    """Perfect VAD: the support of ``file["annotation"]``. ``device`` is
    resolved as for the other pipelines (nothing runs on it)."""

    def __init__(self, device: Union[str, torch.device, None] = None):
        super().__init__()
        self.device = check_device(device)

    def default_parameters(self):
        return {}

    def apply(self, file: AudioFile, hook: Optional[Callable] = None,
              **kwargs) -> Annotation:
        speech = file["annotation"].get_timeline().support()
        return speech.to_annotation()


class VoiceActivityDetection(Pipeline):
    """Voice activity detection with a segmentation model.

    ``segmentation`` is a model instance, a checkpoint path, a hub id or a
    ``{checkpoint, subfolder}`` dict; it runs on ``device`` (the CUDA card
    by default; without one the constructor raises, and ``device="cpu"``
    runs on the CPU). ``fscore`` selects the metric that ``get_metric``
    returns. Other keyword arguments go to the ``Inference`` (``step``,
    ``batch_size``, ``pre_aggregation_hook``, ...); ``token`` (or
    ``use_auth_token``) and ``cache_dir`` serve a hub id.
    """

    def __init__(self, segmentation: PipelineModel = None,
                 fscore: bool = False,
                 device: Union[str, torch.device, None] = None,
                 use_auth_token=None, token=None, cache_dir=None,
                 **inference_kwargs):
        super().__init__()
        self.segmentation = segmentation
        self.fscore = fscore
        model = get_model(segmentation, token=token or use_auth_token,
                          cache_dir=cache_dir)
        inference_kwargs.setdefault("pre_aggregation_hook", max_over_classes)
        self._segmentation = Inference(model, device=device,
                                       **inference_kwargs)
        self.device = self._segmentation.device
        if model.specifications.powerset:
            self.onset = self.offset = 0.5
        else:
            self.onset = Uniform(0.0, 1.0)
            self.offset = Uniform(0.0, 1.0)
        self.min_duration_on = Uniform(0.0, 1.0)
        self.min_duration_off = Uniform(0.0, 1.0)

    def default_parameters(self):
        return {"onset": 0.5, "offset": 0.5,
                "min_duration_on": 0.0, "min_duration_off": 0.0}

    def classes(self) -> List[str]:
        return ["SPEECH"]

    def initialize(self):
        self._binarize = Binarize(onset=self.onset, offset=self.offset,
                                  min_duration_on=self.min_duration_on,
                                  min_duration_off=self.min_duration_off)

    def preload(self, file) -> None:
        self._segmentation.preload(file)

    def apply(self, file: AudioFile,
              hook: Optional[Callable] = None) -> Annotation:
        self.initialize()
        if hook is not None:
            hook("segmentation", None)
        if self.training and "training_cache/segmentation" in file:
            segmentations = file["training_cache/segmentation"]
        else:
            segmentations: SlidingWindowFeature = self._segmentation(file)
            if self.training:
                file["training_cache/segmentation"] = segmentations
        if hook is not None:
            hook("segmentation", segmentations)
        speech = self._binarize(segmentations)
        speech.uri = file["uri"]
        return speech.rename_labels({label: "SPEECH"
                                     for label in speech.labels()})

    def get_metric(self):
        """DetectionErrorRate, or the detection F-measure with
        ``fscore``."""
        if self.fscore:
            return DetectionPrecisionRecallFMeasure()
        return DetectionErrorRate()

    def get_direction(self) -> str:
        return "maximize" if self.fscore else "minimize"
