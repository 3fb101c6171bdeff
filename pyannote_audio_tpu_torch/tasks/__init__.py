from .embedding import (SupervisedRepresentationLearningTaskMixin,
                        SupervisedRepresentationLearningWithArcFace)
from .segmentation import (MultiLabelSegmentation, SegmentationTask,
                           SpeakerDiarization, VoiceActivityDetection)
from .separation import PixIT

#: the historical name of the diarization task
Segmentation = SpeakerDiarization

__all__ = ["MultiLabelSegmentation", "PixIT", "SegmentationTask",
           "Segmentation", "SpeakerDiarization",
           "SupervisedRepresentationLearningTaskMixin",
           "SupervisedRepresentationLearningWithArcFace",
           "VoiceActivityDetection"]
