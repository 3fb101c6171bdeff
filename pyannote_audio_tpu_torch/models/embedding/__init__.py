"""Speaker embedding models, under the JAX package's names."""

from .ecapa import ECAPA_TDNN
from .titanet import TitaNet
from .wespeaker import (BaseWeSpeakerResNet, WeSpeakerResNet18,
                        WeSpeakerResNet34, WeSpeakerResNet50,
                        WeSpeakerResNet101, WeSpeakerResNet152,
                        WeSpeakerResNet221, WeSpeakerResNet293)
from .xvector import XVectorMFCC, XVectorSincNet

__all__ = [
    "ECAPA_TDNN",
    "TitaNet",
    "BaseWeSpeakerResNet",
    "WeSpeakerResNet18",
    "WeSpeakerResNet34",
    "WeSpeakerResNet50",
    "WeSpeakerResNet101",
    "WeSpeakerResNet152",
    "WeSpeakerResNet221",
    "WeSpeakerResNet293",
    "XVectorMFCC",
    "XVectorSincNet",
]
