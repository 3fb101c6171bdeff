"""WeSpeaker ResNet speaker embeddings, every published depth.

Counterpart of pyannote_audio_tpu/models/embedding/wespeaker.py
(``BasicBlock``, ``Bottleneck``, ``ResNetTrunk``, ``BaseWeSpeakerResNet``
and ResNet18/34/50/101/152/221/293 with the bare ``ResNet*`` aliases,
the ``frames`` / ``embed`` split and ``seg_1``): kaldi fbank -> ResNet
(NCHW, the reference layout: input (B, 1, mel, frames)) -> weighted TSTP
statistics pooling -> linear. Every depth has ``frames_from_fbank``, so
the diarization pipeline's shared-fbank and shared-trunk paths serve it.
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

from typing import Mapping, Optional, Sequence, Tuple

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
    expansion = 1

    def __init__(self, in_planes: int, planes: int, stride: int = 1,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.conv1 = _conv(in_planes, planes, 3, stride, generator)
        self.bn1 = nn.BatchNorm2d(planes)
        self.conv2 = _conv(planes, planes, 3, 1, generator)
        self.bn2 = nn.BatchNorm2d(planes)
        self.shortcut = _shortcut(in_planes, planes, stride, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(_apply_conv(self.conv1, x)))
        out = self.bn2(_apply_conv(self.conv2, out))
        return F.relu(out + _apply_shortcut(self.shortcut, x))


class Bottleneck(nn.Module):
    """1x1 -> 3x3 (strided) -> 1x1 to ``expansion * planes`` channels."""

    expansion = 4

    def __init__(self, in_planes: int, planes: int, stride: int = 1,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        out_planes = self.expansion * planes
        self.conv1 = _conv(in_planes, planes, 1, 1, generator)
        self.bn1 = nn.BatchNorm2d(planes)
        self.conv2 = _conv(planes, planes, 3, stride, generator)
        self.bn2 = nn.BatchNorm2d(planes)
        self.conv3 = _conv(planes, out_planes, 1, 1, generator)
        self.bn3 = nn.BatchNorm2d(out_planes)
        self.shortcut = _shortcut(in_planes, out_planes, stride, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(_apply_conv(self.conv1, x)))
        out = F.relu(self.bn2(_apply_conv(self.conv2, out)))
        out = self.bn3(_apply_conv(self.conv3, out))
        return F.relu(out + _apply_shortcut(self.shortcut, x))


def _shortcut(in_planes: int, out_planes: int, stride: int,
              generator: Optional[torch.Generator]) -> nn.Sequential:
    """Strided 1x1 conv + BatchNorm where the shape changes, else empty."""
    if stride == 1 and in_planes == out_planes:
        return nn.Sequential()
    return nn.Sequential(_conv(in_planes, out_planes, 1, stride, generator),
                         nn.BatchNorm2d(out_planes))


def _apply_shortcut(shortcut: nn.Sequential, x: torch.Tensor
                    ) -> torch.Tensor:
    if len(shortcut):
        return shortcut[1](_apply_conv(shortcut[0], x))
    return x


# time strides of the four stages (stage 1 keeps the frame rate)
STAGE_STRIDES = (1, 2, 2, 2)


class ResNetTrunk(nn.Module):
    """conv1 + 4 stages + seg_1; (B, 1, F, T) -> frames (B, T', C*F')."""

    def __init__(self, num_blocks: Sequence[int] = (3, 4, 6, 3),
                 m_channels: int = 32, num_mel_bins: int = 80,
                 embed_dim: int = 256, bottleneck: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        Block = Bottleneck if bottleneck else BasicBlock
        self.conv1 = _conv(1, m_channels, 3, 1, generator)
        self.bn1 = nn.BatchNorm2d(m_channels)
        in_planes = m_channels
        for stage, (n, mult, stride) in enumerate(
                zip(num_blocks, (1, 2, 4, 8), STAGE_STRIDES)):
            blocks = []
            for i in range(n):
                blocks.append(Block(in_planes, m_channels * mult,
                                    stride if i == 0 else 1, generator))
                in_planes = m_channels * mult * Block.expansion
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
        out channels-last; where autograd records on the CPU, contiguous
        (weights included, converted in place once): there the backward of
        the channels-last trunk corrupts the heap (oneDNN, torch 2.13)."""
        if x.device.type == "cpu" and torch.is_grad_enabled():
            if not self.layer1[0].conv2.weight.is_contiguous():
                self.to(memory_format=torch.contiguous_format)
            x = x.contiguous()
        else:
            x = x.contiguous(memory_format=torch.channels_last)
        x = F.relu(self.bn1(_apply_conv(self.conv1, x)))
        for stage in (self.layer1, self.layer2, self.layer3, self.layer4):
            x = stage(x)
        return x

    @staticmethod
    def num_frames(num_frames: int) -> int:
        """Trunk output frames for ``num_frames`` input frames: conv1 keeps
        them, each stage's first 3x3 conv (padding 1) divides them by its
        stride."""
        for stride in STAGE_STRIDES:
            num_frames = (num_frames - 1) // stride + 1
        return num_frames


class BaseWeSpeakerResNet(nn.Module):
    """fbank -> ResNet trunk -> masked TSTP -> 256-d embedding.

    The depth is ``NUM_BLOCKS`` per stage and ``BOTTLENECK`` picks the
    block, as in the JAX package's classes; ``num_blocks`` overrides the
    depth (a shallow trunk for tests).
    """

    NUM_BLOCKS: Tuple[int, ...] = (3, 4, 6, 3)
    BOTTLENECK = False

    def __init__(self, num_blocks: Optional[Sequence[int]] = None,
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
        self.num_blocks = tuple(self.NUM_BLOCKS if num_blocks is None
                                else num_blocks)
        self.m_channels = m_channels
        self.resnet = ResNetTrunk(self.num_blocks, m_channels, num_mel_bins,
                                  embed_dim, self.BOTTLENECK, generator)

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
        published depths leave at their defaults)."""
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


class WeSpeakerResNet18(BaseWeSpeakerResNet):
    NUM_BLOCKS = (2, 2, 2, 2)


class WeSpeakerResNet34(BaseWeSpeakerResNet):
    NUM_BLOCKS = (3, 4, 6, 3)


class WeSpeakerResNet50(BaseWeSpeakerResNet):
    NUM_BLOCKS = (3, 4, 6, 3)
    BOTTLENECK = True


class WeSpeakerResNet101(BaseWeSpeakerResNet):
    NUM_BLOCKS = (3, 4, 23, 3)
    BOTTLENECK = True


class WeSpeakerResNet152(BaseWeSpeakerResNet):
    NUM_BLOCKS = (3, 8, 36, 3)
    BOTTLENECK = True


class WeSpeakerResNet221(BaseWeSpeakerResNet):
    NUM_BLOCKS = (6, 16, 48, 3)
    BOTTLENECK = True


class WeSpeakerResNet293(BaseWeSpeakerResNet):
    NUM_BLOCKS = (10, 20, 64, 3)
    BOTTLENECK = True


# the reference's bare ResNet names, as the JAX package exports them
ResNet = BaseWeSpeakerResNet
ResNet18 = WeSpeakerResNet18
ResNet34 = WeSpeakerResNet34
ResNet50 = WeSpeakerResNet50
ResNet101 = WeSpeakerResNet101
ResNet152 = WeSpeakerResNet152
ResNet221 = WeSpeakerResNet221
ResNet293 = WeSpeakerResNet293
