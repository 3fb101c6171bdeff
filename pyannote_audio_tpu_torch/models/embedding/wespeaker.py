"""WeSpeaker ResNet speaker embeddings.

Counterpart of pyannote_audio_tpu/models/embedding/wespeaker.py
(``BasicBlock``, ``ResNetTrunk``, the ``frames`` / ``embed`` split and
``seg_1``): kaldi fbank -> ResNet (NCHW, the reference layout: input
(B, 1, mel, frames)) -> weighted TSTP statistics pooling -> linear.
BatchNorm uses running statistics (the module is meant to run in eval
mode). Parameter names follow the reference ``resnet.*`` layout, which
the JAX model's ``export_torch_state_dict`` emits.

The trunk (conv1, BatchNorm, layers 1-4) runs in ``compute_dtype``, bf16
by default as the JAX ``WeSpeakerModule``: conv operands rounded to bf16
with float32 accumulation and a bf16 output, BatchNorm computed in float32
from its float32 running statistics and rounded to bf16. Parameters stay
float32 and are cast per call. Fbank, the mean subtraction, pooling and
``seg_1`` stay float32, and the trunk's output is cast to float32 before
the flatten. A float32 trunk (the exact path), the pooling and ``seg_1``
run under ``utils.runtime.exact_float32``: cuDNN takes TF32 by default,
and a process may allow it for matmuls.
"""

from __future__ import annotations

from typing import Mapping, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...ops.fbank import wespeaker_fbank
from ...utils.runtime import exact_float32, exact_float32_if
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


def _apply_conv(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """``conv`` in the dtype of ``x`` (its float32 weight cast per call)."""
    return F.conv2d(x, conv.weight.to(x.dtype), None, conv.stride,
                    conv.padding)


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
        out = F.relu(self.bn1(_apply_conv(self.conv1, x)))
        out = self.bn2(_apply_conv(self.conv2, out))
        if len(self.shortcut):
            x = self.shortcut[1](_apply_conv(self.shortcut[0], x))
        return F.relu(out + x)


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
        # channels-last conv weights (and inputs, see ``trunk``): cuDNN
        # runs the bf16 trunk about 1.4x faster in this layout than in
        # NCHW on an H100 (PERF.md)
        self.to(memory_format=torch.channels_last)

    def trunk(self, x: torch.Tensor) -> torch.Tensor:
        """(B, 1, mel, T) -> (B, C, F', T'), in the dtype of ``x``, laid
        out channels-last."""
        x = x.contiguous(memory_format=torch.channels_last)
        x = F.relu(self.bn1(_apply_conv(self.conv1, x)))
        for stage in (self.layer1, self.layer2, self.layer3, self.layer4):
            x = stage(x)
        return x

    def num_frames(self, num_frames: int) -> int:
        """Trunk output frames for ``num_frames`` input frames, from the
        strides and paddings of the trunk's convs."""
        for conv in [self.conv1] + [stage[0].conv1 for stage in (
                self.layer1, self.layer2, self.layer3, self.layer4)]:
            num_frames = (num_frames + 2 * conv.padding[1]
                          - conv.kernel_size[1]) // conv.stride[1] + 1
        return num_frames


class WeSpeakerResNet34(nn.Module):
    """fbank -> ResNet34 trunk -> masked TSTP -> 256-d embedding."""

    def __init__(self, num_blocks: Sequence[int] = (3, 4, 6, 3),
                 m_channels: int = 32, num_mel_bins: int = 80,
                 embed_dim: int = 256, sample_rate: int = 16000,
                 frame_length: float = 25.0, frame_shift: float = 10.0,
                 window_type: str = "hamming",
                 compute_dtype: torch.dtype = torch.bfloat16,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.num_mel_bins = num_mel_bins
        self.sample_rate = sample_rate
        self.frame_length = frame_length
        self.frame_shift = frame_shift
        self.window_type = window_type
        self.dimension = embed_dim
        self.num_blocks = tuple(num_blocks)
        self.m_channels = m_channels
        self.resnet = ResNet(num_blocks, m_channels, num_mel_bins, embed_dim,
                             generator)

    def frames(self, waveforms: torch.Tensor) -> torch.Tensor:
        """(B, 1, samples) -> frame-wise features (B, T', C*F')."""
        feats = wespeaker_fbank(waveforms, num_mel_bins=self.num_mel_bins,
                                sample_rate=self.sample_rate,
                                frame_length=self.frame_length,
                                frame_shift=self.frame_shift,
                                window_type=self.window_type)
        return self.frames_from_fbank(feats, centered=True)

    def frames_from_fbank(self, feats: torch.Tensor,
                          centered: bool = False) -> torch.Tensor:
        """(B, T, mel) fbank -> (B, T', C*F'), flattened c*F' + f like the
        reference TSTP.

        ``centered=False`` subtracts each chunk's mean here: the entry of
        the shared whole-file fbank, whose slices arrive uncentered.
        """
        if not centered:
            feats = feats - feats.mean(dim=-2, keepdim=True)
        x = feats.transpose(1, 2)[:, None].to(self.compute_dtype)
        with exact_float32_if(self.compute_dtype):
            x = self.resnet.trunk(x).float()                  # (B,C,F',T')
        B, C, Fr, T = x.shape
        return x.reshape(B, C * Fr, T).transpose(1, 2)

    def embed(self, frames: torch.Tensor,
              weights: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(B, T', D) frames -> (B, [S,] embed_dim) embeddings, pooled and
        projected in float32 with TF32 off."""
        with exact_float32():
            return self.resnet.seg_1(stats_pool(frames.transpose(1, 2),
                                                weights=weights))

    def forward(self, waveforms: torch.Tensor,
                weights: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self.embed(self.frames(waveforms), weights=weights)

    def reference_hparams(self) -> dict:
        """Hyper-parameters in the reference checkpoint layout, with the
        port's trunk shape and dtype (which a reference checkpoint of the
        published ResNet34 leaves at their defaults)."""
        return {"sample_rate": self.sample_rate,
                "num_mel_bins": self.num_mel_bins,
                "frame_length": self.frame_length,
                "frame_shift": self.frame_shift,
                "window_type": self.window_type,
                "num_blocks": list(self.num_blocks),
                "m_channels": self.m_channels, "embed_dim": self.dimension,
                "compute_dtype": str(self.compute_dtype).split(".")[-1]}

    def load_reference_state_dict(self, state: Mapping[str, np.ndarray]):
        """Load a reference ``resnet.*`` state dict, BatchNorm running
        statistics included."""
        self.load_state_dict({k: torch.tensor(np.asarray(v))
                              for k, v in state.items()}, strict=True)
        return self
