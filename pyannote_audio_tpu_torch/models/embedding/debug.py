"""A fast embedding model for tests: strided conv -> statistics pooling.

Counterpart of pyannote_audio_tpu/models/embedding/debug.py
(``SimpleEmbeddingModel``): a conv front-end (32 filters of 400 samples,
stride 160), tanh, weighted mean and standard deviation over time and a
linear projection to 32 dimensions. It has the ``frames`` / ``embed``
split the diarization pipeline's per-chunk path calls. Its torch layout is
``frontend.*`` and ``proj.*``
(``utils.convert.debug_embedding_state_dict``).
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch
from torch import nn

from ...core.model import Problem, Resolution, Specifications
from ...utils.receptive_field import conv1d_num_frames
from ...utils.runtime import exact_float32
from ..blocks.pooling import stats_pool
from ..blocks.ssl import init_conv, init_linear

KERNEL = 400
STRIDE = 160
HIDDEN = 32
EMBED_DIM = 32


class SimpleEmbeddingModel(nn.Module):
    """(B, 1, samples) [+ weights (B, [speakers,] frames')] -> (B,
    [speakers,] 32) embeddings."""

    def __init__(self, sample_rate: int = 16000,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.sample_rate = sample_rate
        self.specifications = Specifications(
            duration=2.0, classes=[], problem=Problem.REPRESENTATION,
            resolution=Resolution.CHUNK, min_duration=0.25)
        self.frontend = init_conv(nn.Conv1d(1, HIDDEN, KERNEL,
                                            stride=STRIDE), generator)
        self.proj = init_linear(nn.Linear(2 * HIDDEN, EMBED_DIM), generator)

    @property
    def dimension(self) -> int:
        return EMBED_DIM

    def frames(self, waveforms: torch.Tensor) -> torch.Tensor:
        """(B, 1, samples) -> (B, frames, 32)."""
        with exact_float32():
            return torch.tanh(self.frontend(waveforms)).transpose(1, 2)

    def embed(self, frames: torch.Tensor,
              weights: Optional[torch.Tensor] = None) -> torch.Tensor:
        with exact_float32():
            return self.proj(stats_pool(frames.transpose(1, 2),
                                        weights=weights))

    def forward(self, waveforms: torch.Tensor,
                weights: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self.embed(self.frames(waveforms), weights)

    def num_frames(self, num_samples: int) -> int:
        return conv1d_num_frames(num_samples, kernel_size=KERNEL,
                                 stride=STRIDE)

    def reference_hparams(self) -> Dict:
        return {"sample_rate": self.sample_rate, "num_channels": 1}

    def load_reference_state_dict(self, state: Mapping
                                  ) -> "SimpleEmbeddingModel":
        self.load_state_dict({k: torch.from_numpy(np.array(
            v, dtype=np.float32)) for k, v in state.items()}, strict=True)
        return self
