"""x-vector TDNN speaker embeddings (the reference's pyannote/embedding).

Counterpart of pyannote_audio_tpu/models/embedding/xvector.py
(``TDNNStack``, ``XVectorModule``, ``XVectorMFCC``, ``XVectorSincNet``;
its ``mfcc_features`` is ops/fbank.py's): a front-end (torchaudio's
MFCC, or the SincNet block of models/blocks/sincnet.py), five dilated Conv1d of 512, 512, 512, 512
and 1500 channels (kernels 5, 3, 3, 1, 1; dilations 1, 2, 3, 1, 1), each
followed by LeakyReLU and BatchNorm1d, then weighted statistics pooling
and Linear(3000 -> 512). Modules are named as the reference's
(``tdnns.{3i}`` conv, ``tdnns.{3i+2}`` batch norm, ``embedding``,
``sincnet.*``), so its state dict loads as it is; BatchNorm uses running
statistics (eval mode).

The MFCC, the TDNN, the pooling and the linear run in float32 under
``utils.runtime.exact_float32``; SincNet follows its own
PYANNOTE_TPU_SEG_BF16 gate, as in the JAX package.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch
from torch import nn

from ...core.model import FrameModel
from ...ops.fbank import mfcc_features
from ...utils.receptive_field import (multi_conv_num_frames,
                                      multi_conv_receptive_field_center,
                                      multi_conv_receptive_field_size)
from ...utils.runtime import exact_float32
from ..blocks.pooling import stats_pool
from ..blocks.sincnet import SincNet

TDNN_CHANNELS = (512, 512, 512, 512, 1500)
TDNN_KERNELS = (5, 3, 3, 1, 1)
TDNN_DILATIONS = (1, 2, 3, 1, 1)
_TDNN_LADDER = dict(kernel_size=list(TDNN_KERNELS), stride=[1] * 5,
                    padding=[0] * 5, dilation=list(TDNN_DILATIONS))


def _uniform_(tensor: torch.Tensor, fan_in: int,
              generator: Optional[torch.Generator]) -> None:
    bound = fan_in ** -0.5
    with torch.no_grad():
        tensor.copy_(torch.rand(tensor.shape, generator=generator) * 2
                     * bound - bound)


class _XVector(FrameModel, nn.Module):
    """Front-end -> TDNN -> stats pooling -> linear; ``FRONTEND`` is
    "mfcc" or "sincnet"."""

    FRONTEND = "mfcc"

    def __init__(self, sample_rate: int = 16000, num_channels: int = 1,
                 mfcc: Optional[dict] = None, sincnet: Optional[dict] = None,
                 dimension: int = 512,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.sample_rate = sample_rate
        self.dimension = dimension
        self.hparams = {"mfcc": {"n_mfcc": 40, **(mfcc or {})},
                        "sincnet": {"stride": 10, **(sincnet or {})},
                        "dimension": dimension}
        if self.FRONTEND == "sincnet":
            self.sincnet = SincNet(stride=self.sincnet_stride,
                                   sample_rate=sample_rate,
                                   generator=generator)
            in_channels = 60
        else:
            in_channels = self.hparams["mfcc"]["n_mfcc"]
        layers = []
        for c, k, d in zip(TDNN_CHANNELS, TDNN_KERNELS, TDNN_DILATIONS):
            conv = nn.Conv1d(in_channels, c, k, dilation=d)
            _uniform_(conv.weight, in_channels * k, generator)
            _uniform_(conv.bias, in_channels * k, generator)
            layers += [conv, nn.LeakyReLU(0.01), nn.BatchNorm1d(c)]
            in_channels = c
        self.tdnns = nn.ModuleList(layers)
        self.embedding = nn.Linear(2 * in_channels, dimension)
        _uniform_(self.embedding.weight, 2 * in_channels, generator)
        _uniform_(self.embedding.bias, 2 * in_channels, generator)

    @property
    def sincnet_stride(self) -> int:
        return self.hparams["sincnet"]["stride"]

    def features(self, waveforms: torch.Tensor) -> torch.Tensor:
        """(B, 1, samples) -> (B, frames, channels)."""
        if self.FRONTEND == "mfcc":
            return mfcc_features(waveforms, self.sample_rate,
                                 self.hparams["mfcc"]["n_mfcc"])
        return self.sincnet(waveforms)

    def frames(self, waveforms: torch.Tensor) -> torch.Tensor:
        """(B, 1, samples) -> frame-wise features (B, T', 1500)."""
        x = self.features(waveforms).transpose(1, 2)
        with exact_float32():
            for layer in self.tdnns:
                x = layer(x)
        return x.transpose(1, 2)

    def embed(self, frames: torch.Tensor,
              weights: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(B, T', 1500) frames -> (B, [S,] dimension) embeddings;
        ``weights`` (B, [S,] frames') at any frame rate."""
        with exact_float32():
            return self.embedding(stats_pool(frames.transpose(1, 2),
                                             weights=weights))

    def forward(self, waveforms: torch.Tensor,
                weights: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self.embed(self.frames(waveforms), weights=weights)

    def reference_hparams(self) -> Dict:
        """Hyper-parameters in the reference checkpoint layout."""
        return dict(self.hparams, sample_rate=self.sample_rate,
                    num_channels=1)

    def load_reference_state_dict(self, state: Mapping[str, np.ndarray]):
        """Load a reference ``tdnns.*`` / ``embedding.*`` (/ ``sincnet.*``)
        state dict. XVectorMFCC's ``mfcc.*`` entries are torchaudio's
        parameter-free buffers (window, mel banks, DCT), derived here, and
        are ignored."""
        self.load_state_dict({k: torch.tensor(np.asarray(v))
                              for k, v in state.items()
                              if not k.startswith("mfcc.")}, strict=True)
        return self

    # -- frame math ---------------------------------------------------------

    def _front_frames(self, num_samples: int) -> int:
        raise NotImplementedError

    def num_frames(self, num_samples: int) -> int:
        return multi_conv_num_frames(self._front_frames(num_samples),
                                     **_TDNN_LADDER)

    def _tdnn_field(self, num_frames: int) -> int:
        return multi_conv_receptive_field_size(
            num_frames, kernel_size=_TDNN_LADDER["kernel_size"],
            stride=_TDNN_LADDER["stride"],
            dilation=_TDNN_LADDER["dilation"])


class XVectorMFCC(_XVector):
    FRONTEND = "mfcc"
    # torchaudio's MelSpectrogram defaults: n_fft 400, centred, hop 200
    _N_FFT = 400
    _HOP = 200

    def _front_frames(self, num_samples: int) -> int:
        return 1 + num_samples // self._HOP

    def receptive_field_size(self, num_frames: int = 1) -> int:
        return self._N_FFT + (self._tdnn_field(num_frames) - 1) * self._HOP

    def receptive_field_center(self, frame: int = 0) -> int:
        return multi_conv_receptive_field_center(frame, **_TDNN_LADDER) \
            * self._HOP


class XVectorSincNet(_XVector):
    FRONTEND = "sincnet"

    def _front_frames(self, num_samples: int) -> int:
        return SincNet.num_frames(num_samples, stride=self.sincnet_stride)

    def receptive_field_size(self, num_frames: int = 1) -> int:
        return SincNet.receptive_field_size(self._tdnn_field(num_frames),
                                            stride=self.sincnet_stride)

    def receptive_field_center(self, frame: int = 0) -> int:
        return SincNet.receptive_field_center(
            multi_conv_receptive_field_center(frame, **_TDNN_LADDER),
            stride=self.sincnet_stride)
