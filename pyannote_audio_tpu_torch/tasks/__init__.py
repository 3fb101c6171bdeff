from .segmentation import (MultiLabelSegmentation, SegmentationTask,
                           SpeakerDiarization, VoiceActivityDetection)

__all__ = ["MultiLabelSegmentation", "SegmentationTask",
           "SpeakerDiarization", "VoiceActivityDetection"]
