from .mix import MixSpeakerDiarization
from .registry import (AugmentationSpec, get_augmentation,
                       register_augmentation, unregister_augmentation)

__all__ = [
    "MixSpeakerDiarization",
    "AugmentationSpec",
    "get_augmentation",
    "register_augmentation",
    "unregister_augmentation",
]
