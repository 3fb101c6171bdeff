"""SincNet learnable band-pass front-end.

Counterpart of pyannote_audio_tpu/models/blocks/sincnet.py (and its
``InstanceNorm1d``): instance norm -> 80 parameterized sinc filters (251
taps, stride 10) -> abs -> 3 x (max-pool 3, instance norm, leaky relu)
with two Conv1d(k=5) in between. Float32 throughout (the JAX package's
bf16 SincNet is an accelerator fast path not ported yet). Submodules are
named as the reference's, so the state dict has its ``sincnet.*`` keys.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...utils.receptive_field import (multi_conv_num_frames,
                                      multi_conv_receptive_field_center,
                                      multi_conv_receptive_field_size)

SINC_KERNEL_SIZE = 251


def _ladder(stride: int):
    """The conv/pool ladder of the block: [sinc, pool, conv, pool, conv,
    pool]."""
    return dict(kernel_size=[SINC_KERNEL_SIZE, 3, 5, 3, 5, 3],
                stride=[stride, 3, 1, 3, 1, 3],
                padding=[0] * 6, dilation=[1] * 6)


def mel_initialized_bands(n_filters: int, sample_rate: int,
                          min_low_hz: float, min_band_hz: float
                          ) -> Tuple[np.ndarray, np.ndarray]:
    """Mel-spaced initial (low_hz, band_hz), as in public SincNet."""
    high_hz = sample_rate / 2 - (min_low_hz + min_band_hz)

    def to_mel(hz):
        return 2595.0 * np.log10(1.0 + hz / 700.0)

    hz = 700.0 * (10.0 ** (np.linspace(to_mel(30.0), to_mel(high_hz),
                                       n_filters + 1) / 2595.0) - 1.0)
    return hz[:-1].astype(np.float32), np.diff(hz).astype(np.float32)


def sinc_filters(low_hz: torch.Tensor, band_hz: torch.Tensor,
                 kernel_size: int, sample_rate: int,
                 min_low_hz: float = 50.0,
                 min_band_hz: float = 50.0) -> torch.Tensor:
    """(n_filters,) parameters -> (n_filters, 1, kernel_size) conv weights.

    band_pass(t) = (sin(2 pi f_hi t) - sin(2 pi f_lo t)) / (pi t),
    Hamming-windowed and normalized per filter.
    """
    low = min_low_hz + low_hz.abs()
    high = torch.clamp(low + min_band_hz + band_hz.abs(), min_low_hz,
                       sample_rate / 2)
    band = high - low
    half = (kernel_size - 1) // 2
    device = low_hz.device
    t = torch.arange(-half, 0, dtype=torch.float32, device=device)
    n_ = 2.0 * math.pi * t / sample_rate
    window = 0.54 - 0.46 * torch.cos(
        2.0 * math.pi * torch.arange(half, dtype=torch.float32,
                                     device=device) / (kernel_size - 1))
    left = ((torch.sin(high[:, None] * n_) - torch.sin(low[:, None] * n_))
            / (n_ / 2.0)) * window
    filters = torch.cat([left, 2.0 * band[:, None], left.flip(1)], dim=1)
    return (filters / (2.0 * band[:, None]))[:, None, :]


class _ParamSincFB(nn.Module):
    """The learnable band edges (reference key ``filterbank.low_hz_``)."""

    def __init__(self, n_filters: int, sample_rate: int):
        super().__init__()
        low, band = mel_initialized_bands(n_filters, sample_rate, 50.0, 50.0)
        self.low_hz_ = nn.Parameter(torch.from_numpy(low)[:, None])
        self.band_hz_ = nn.Parameter(torch.from_numpy(band)[:, None])


class SincConv(nn.Module):
    """Sinc filterbank as a strided conv: (B, 1, samples) -> (B, 80, T)."""

    def __init__(self, n_filters: int = 80, stride: int = 10,
                 sample_rate: int = 16000):
        super().__init__()
        self.stride = stride
        self.sample_rate = sample_rate
        self.filterbank = _ParamSincFB(n_filters, sample_rate)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        kernels = sinc_filters(self.filterbank.low_hz_[:, 0],
                               self.filterbank.band_hz_[:, 0],
                               SINC_KERNEL_SIZE, self.sample_rate)
        return F.conv1d(x, kernels, stride=self.stride)


class SincNet(nn.Module):
    """(B, 1, samples) -> (B, frames, 60)."""

    def __init__(self, stride: int = 10, sample_rate: int = 16000,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.stride = stride
        self.wav_norm1d = nn.InstanceNorm1d(1, affine=True)
        self.conv1d = nn.ModuleList([
            SincConv(stride=stride, sample_rate=sample_rate),
            nn.Conv1d(80, 60, 5), nn.Conv1d(60, 60, 5)])
        self.norm1d = nn.ModuleList([nn.InstanceNorm1d(80, affine=True),
                                     nn.InstanceNorm1d(60, affine=True),
                                     nn.InstanceNorm1d(60, affine=True)])
        with torch.no_grad():
            for conv in self.conv1d[1:]:
                bound = (conv.in_channels * 5) ** -0.5
                for p in (conv.weight, conv.bias):
                    p.copy_(torch.rand(p.shape, generator=generator)
                            * 2 * bound - bound)

    def forward(self, waveforms: torch.Tensor) -> torch.Tensor:
        x = self.wav_norm1d(waveforms)
        x = self.conv1d[0](x).abs()
        for i in range(3):
            if i > 0:
                x = self.conv1d[i](x)
            x = F.leaky_relu(self.norm1d[i](F.max_pool1d(x, 3, 3)), 0.01)
        return x.transpose(1, 2)

    @staticmethod
    def num_frames(num_samples: int, stride: int = 10) -> int:
        return multi_conv_num_frames(num_samples, **_ladder(stride))

    @staticmethod
    def receptive_field_size(num_frames: int = 1, stride: int = 10) -> int:
        spec = _ladder(stride)
        return multi_conv_receptive_field_size(
            num_frames, kernel_size=spec["kernel_size"],
            stride=spec["stride"], dilation=spec["dilation"])

    @staticmethod
    def receptive_field_center(frame: int = 0, stride: int = 10) -> int:
        return multi_conv_receptive_field_center(frame, **_ladder(stride))
