"""A fast segmentation model for tests: strided conv -> BiLSTM -> classifier.

Counterpart of pyannote_audio_tpu/models/segmentation/debug.py
(``SimpleSegmentationModel``): a conv front-end (32 filters of 400
samples, stride 160: 100 frames per second), tanh, a one-layer BiLSTM of
32 (the CUDA kernel on the card) and a log-softmax or sigmoid classifier.
The JAX package writes no torch layout for it; the port's is
``frontend.*`` (Conv1d), ``lstm.*`` (torch.nn.LSTM's names) and
``classifier.*`` (``utils.convert.debug_segmentation_state_dict``).
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...core.model import FrameModel, Problem, Specifications
from ...utils.receptive_field import (conv1d_num_frames,
                                      conv1d_receptive_field_center,
                                      conv1d_receptive_field_size)
from ...utils.runtime import exact_float32
from ..blocks.rnn import LSTM
from ..blocks.ssl import init_conv, init_linear

KERNEL = 400
STRIDE = 160
HIDDEN = 32


class SimpleSegmentationModel(FrameModel, nn.Module):
    """(B, 1, samples) -> (B, frames, dimension) scores; the
    specifications default to PyanNet's (10 s, 3 speakers, powerset)."""

    def __init__(self, specifications: Optional[Specifications] = None,
                 sample_rate: int = 16000,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.specifications = specifications or Specifications(
            duration=10.0, classes=["speaker#1", "speaker#2", "speaker#3"],
            powerset_max_classes=2)
        self.sample_rate = sample_rate
        self.frontend = init_conv(nn.Conv1d(1, HIDDEN, KERNEL,
                                            stride=STRIDE), generator)
        self.lstm = LSTM(HIDDEN, hidden_size=HIDDEN, num_layers=1,
                         bidirectional=True, generator=generator)
        self.classifier = init_linear(
            nn.Linear(2 * HIDDEN, self.specifications.dimension), generator)

    def forward(self, waveforms: torch.Tensor) -> torch.Tensor:
        with exact_float32():
            x = torch.tanh(self.frontend(waveforms)).transpose(1, 2)
            x = self.classifier(self.lstm(x))
            if self.specifications.problem == \
                    Problem.MONO_LABEL_CLASSIFICATION:
                return F.log_softmax(x, dim=-1)
            return torch.sigmoid(x)

    def reference_hparams(self) -> Dict:
        return {"sample_rate": self.sample_rate, "num_channels": 1}

    def load_reference_state_dict(self, state: Mapping
                                  ) -> "SimpleSegmentationModel":
        self.load_state_dict({k: torch.from_numpy(np.array(
            v, dtype=np.float32)) for k, v in state.items()}, strict=True)
        return self

    def num_frames(self, num_samples: int) -> int:
        return conv1d_num_frames(num_samples, kernel_size=KERNEL,
                                 stride=STRIDE)

    def receptive_field_size(self, num_frames: int = 1) -> int:
        return conv1d_receptive_field_size(num_frames, kernel_size=KERNEL,
                                           stride=STRIDE)

    def receptive_field_center(self, frame: int = 0) -> int:
        return conv1d_receptive_field_center(frame, kernel_size=KERNEL,
                                             stride=STRIDE)
