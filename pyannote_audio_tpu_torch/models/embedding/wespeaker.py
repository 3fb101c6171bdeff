"""WeSpeaker ResNet speaker embeddings.

Counterpart of pyannote_audio_tpu/models/embedding/wespeaker.py
(``BasicBlock``, ``ResNetTrunk``, the ``frames`` / ``embed`` split and
``seg_1``): kaldi fbank -> ResNet (NCHW, the reference layout: input
(B, 1, mel, frames)) -> weighted TSTP statistics pooling -> linear.
BatchNorm uses running statistics (the module is meant to run in eval
mode). Parameter names follow the reference ``resnet.*`` layout, which
the JAX model's ``export_torch_state_dict`` emits. Float32 throughout (the
JAX default trunk is bf16; its tests pin float32).
"""

from __future__ import annotations

from typing import Mapping, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...ops.fbank import wespeaker_fbank
from ..blocks.pooling import stats_pool


def _conv(cin: int, cout: int, kernel: int, stride: int,
          generator: Optional[torch.Generator]) -> nn.Conv2d:
    conv = nn.Conv2d(cin, cout, kernel, stride=stride,
                     padding=kernel // 2, bias=False)
    # variance-preserving (LeCun) init, as flax's default conv init
    bound = (3.0 / (cin * kernel * kernel)) ** 0.5
    with torch.no_grad():
        conv.weight.copy_(torch.rand(conv.weight.shape, generator=generator)
                          * 2 * bound - bound)
    return conv


class BasicBlock(nn.Module):
    def __init__(self, in_planes: int, planes: int, stride: int = 1,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.conv1 = _conv(in_planes, planes, 3, stride, generator)
        self.bn1 = nn.BatchNorm2d(planes)
        self.conv2 = _conv(planes, planes, 3, 1, generator)
        self.bn2 = nn.BatchNorm2d(planes)
        self.shortcut = nn.Sequential()
        if stride != 1 or in_planes != planes:
            self.shortcut = nn.Sequential(
                _conv(in_planes, planes, 1, stride, generator),
                nn.BatchNorm2d(planes))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        return F.relu(out + self.shortcut(x))


class ResNet(nn.Module):
    """conv1 + 4 stages + seg_1; (B, 1, F, T) -> frames (B, T', C*F')."""

    def __init__(self, num_blocks: Sequence[int] = (3, 4, 6, 3),
                 m_channels: int = 32, num_mel_bins: int = 80,
                 embed_dim: int = 256,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.conv1 = _conv(1, m_channels, 3, 1, generator)
        self.bn1 = nn.BatchNorm2d(m_channels)
        in_planes = m_channels
        for stage, (n, mult, stride) in enumerate(
                zip(num_blocks, (1, 2, 4, 8), (1, 2, 2, 2))):
            blocks = []
            for i in range(n):
                blocks.append(BasicBlock(in_planes, m_channels * mult,
                                         stride if i == 0 else 1,
                                         generator))
                in_planes = m_channels * mult
            self.add_module(f"layer{stage + 1}", nn.Sequential(*blocks))
        freq = num_mel_bins
        for _ in range(3):              # stages 2-4 halve it (k3 s2 p1)
            freq = (freq + 1) // 2
        stats_dim = in_planes * freq * 2
        self.seg_1 = nn.Linear(stats_dim, embed_dim)
        bound = stats_dim ** -0.5
        with torch.no_grad():
            for p in (self.seg_1.weight, self.seg_1.bias):
                p.copy_(torch.rand(p.shape, generator=generator) * 2 * bound
                        - bound)

    def trunk(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.bn1(self.conv1(x)))
        for stage in (self.layer1, self.layer2, self.layer3, self.layer4):
            x = stage(x)
        return x


class WeSpeakerResNet34(nn.Module):
    """fbank -> ResNet34 trunk -> masked TSTP -> 256-d embedding."""

    def __init__(self, num_blocks: Sequence[int] = (3, 4, 6, 3),
                 m_channels: int = 32, num_mel_bins: int = 80,
                 embed_dim: int = 256, sample_rate: int = 16000,
                 frame_length: float = 25.0, frame_shift: float = 10.0,
                 window_type: str = "hamming",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_mel_bins = num_mel_bins
        self.sample_rate = sample_rate
        self.frame_length = frame_length
        self.frame_shift = frame_shift
        self.window_type = window_type
        self.dimension = embed_dim
        self.resnet = ResNet(num_blocks, m_channels, num_mel_bins, embed_dim,
                             generator)

    def frames(self, waveforms: torch.Tensor) -> torch.Tensor:
        """(B, 1, samples) -> frame-wise features (B, T', C*F')."""
        feats = wespeaker_fbank(waveforms, num_mel_bins=self.num_mel_bins,
                                sample_rate=self.sample_rate,
                                frame_length=self.frame_length,
                                frame_shift=self.frame_shift,
                                window_type=self.window_type)
        return self.frames_from_fbank(feats)

    def frames_from_fbank(self, feats: torch.Tensor) -> torch.Tensor:
        """(B, T, mel) centered fbank -> (B, T', C*F'), flattened c*F' + f
        like the reference TSTP."""
        x = self.resnet.trunk(feats.transpose(1, 2)[:, None])  # (B,C,F',T')
        B, C, Fr, T = x.shape
        return x.reshape(B, C * Fr, T).transpose(1, 2)

    def embed(self, frames: torch.Tensor,
              weights: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(B, T', D) frames -> (B, [S,] embed_dim) embeddings."""
        return self.resnet.seg_1(stats_pool(frames.transpose(1, 2),
                                            weights=weights))

    def forward(self, waveforms: torch.Tensor,
                weights: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self.embed(self.frames(waveforms), weights=weights)

    def load_reference_state_dict(self, state: Mapping[str, np.ndarray]):
        """Load a reference ``resnet.*`` state dict, BatchNorm running
        statistics included."""
        self.load_state_dict({k: torch.tensor(np.asarray(v))
                              for k, v in state.items()}, strict=True)
        return self
