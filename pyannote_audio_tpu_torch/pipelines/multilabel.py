"""Multi-label segmentation pipeline: per-class binarization.

Counterpart of pyannote_audio_tpu/pipelines/multilabel.py: sliding-window
inference (aggregated on the device) and, per class, hysteresis
binarization with its own onset and offset, and its own minimum durations
or, with ``share_min_duration``, ones shared by every class.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Union

import torch

from ..core.annotation import Annotation
from ..core.inference import Inference
from ..core.io import AudioFile
from ..core.pipeline import Pipeline
from ..core.segment import SlidingWindowFeature
from ..metrics.der import IdentificationErrorRate
from ..utils.metric import MacroAverageFMeasure
from ..utils.signal import Binarize
from .parameter import ParamDict, Uniform
from .utils.getter import PipelineModel, get_model


class MultiLabelSegmentation(Pipeline):
    """Multi-label segmentation with a (sigmoid-headed) model.

    ``segmentation`` is a model instance, a local checkpoint path or a
    ``{checkpoint, subfolder}`` dict; it runs on ``device`` (the CUDA card
    by default; without one the constructor raises). ``fscore`` selects
    the metric. Other keyword arguments go to the ``Inference``.
    """

    def __init__(self, segmentation: PipelineModel = None,
                 fscore: bool = False, share_min_duration: bool = False,
                 device: Union[str, torch.device, None] = None,
                 use_auth_token=None, token=None, cache_dir=None,
                 **inference_kwargs):
        super().__init__()
        self.segmentation = segmentation
        self.fscore = fscore
        self.share_min_duration = share_min_duration
        model = get_model(segmentation)
        self._classes = model.specifications.classes
        self._segmentation = Inference(model, device=device,
                                       **inference_kwargs)
        self.device = self._segmentation.device
        if share_min_duration:
            self.min_duration_on = Uniform(0.0, 2.0)
            self.min_duration_off = Uniform(0.0, 2.0)
            self.thresholds = ParamDict(**{
                label: ParamDict(onset=Uniform(0.0, 1.0),
                                 offset=Uniform(0.0, 1.0))
                for label in self._classes})
        else:
            self.thresholds = ParamDict(**{
                label: ParamDict(onset=Uniform(0.0, 1.0),
                                 offset=Uniform(0.0, 1.0),
                                 min_duration_on=Uniform(0.0, 2.0),
                                 min_duration_off=Uniform(0.0, 2.0))
                for label in self._classes})

    def default_parameters(self):
        per_label = {"onset": 0.5, "offset": 0.5}
        if self.share_min_duration:
            return {"min_duration_on": 0.0, "min_duration_off": 0.0,
                    "thresholds": {c: dict(per_label)
                                   for c in self._classes}}
        per_label.update({"min_duration_on": 0.0, "min_duration_off": 0.0})
        return {"thresholds": {c: dict(per_label) for c in self._classes}}

    def classes(self) -> List[str]:
        return list(self._classes)

    def preload(self, file) -> None:
        self._segmentation.preload(file)

    def apply(self, file: AudioFile,
              hook: Optional[Callable] = None) -> Annotation:
        if self.training and "training_cache/segmentation" in file:
            segmentations = file["training_cache/segmentation"]
        else:
            segmentations: SlidingWindowFeature = self._segmentation(file)
            if self.training:
                file["training_cache/segmentation"] = segmentations
        if hook is not None:
            hook("segmentation", segmentations, file=file)
        result = Annotation(uri=file["uri"])
        for k, label in enumerate(self._classes):
            params = self.thresholds[label]
            if self.share_min_duration:
                min_on, min_off = self.min_duration_on, self.min_duration_off
            else:
                min_on = params["min_duration_on"]
                min_off = params["min_duration_off"]
            binarize = Binarize(onset=params["onset"],
                                offset=params["offset"],
                                min_duration_on=min_on,
                                min_duration_off=min_off)
            scores = SlidingWindowFeature(segmentations.data[:, k:k + 1],
                                          segmentations.sliding_window,
                                          labels=[label])
            for seg, _, _ in binarize(scores).itertracks(yield_label=True):
                result[seg, result.new_track(seg)] = label
        return result

    def get_metric(self):
        """IdentificationErrorRate, or the macro-averaged per-class
        detection F-measure with ``fscore``."""
        if self.fscore:
            return MacroAverageFMeasure(self._classes)
        return IdentificationErrorRate()

    def get_direction(self) -> str:
        return "maximize" if self.fscore else "minimize"
