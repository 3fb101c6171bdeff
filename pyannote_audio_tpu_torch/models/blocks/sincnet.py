"""SincNet learnable band-pass front-end.

Counterpart of pyannote_audio_tpu/models/blocks/sincnet.py (and its
``InstanceNorm1d``): instance norm -> 80 parameterized sinc filters (251
taps, stride 10) -> abs -> 3 x (max-pool 3, instance norm, leaky relu)
with two Conv1d(k=5) in between. Submodules are named as the
reference's, so the state dict has its ``sincnet.*`` keys.

The three convolutions run in bf16 where the PYANNOTE_TPU_SEG_BF16 gate
is on (by default on a CUDA device, off on the CPU; resolved per call from
the input's device): operands rounded to bf16, float32 accumulation, the
output rounded to bf16 and cast back to float32. Instance norms, abs and
pooling stay float32. Where they run in float32 (the exact path) the
convolutions run under ``utils.runtime.exact_float32``: cuDNN takes TF32
by default, and the JAX package pins ``Precision.HIGHEST`` there.
``whole_conv`` / ``from_conv`` are the shared whole-file front-end (the JAX package's, ``sincnet.py:208-244``).
Layout is channel-first (B, C, T) inside the block, as torch's convs take
it; ``forward`` returns (B, frames, 60) as the JAX block does.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...utils.receptive_field import (conv1d_num_frames,
                                      multi_conv_num_frames,
                                      multi_conv_receptive_field_center,
                                      multi_conv_receptive_field_size)
from ...utils.runtime import device_flag, exact_float32_if

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
    """(n_filters,) parameters -> (n_filters, 1, kernel_size) conv weights,
    in the parameters' dtype.

    band_pass(t) = (sin(2 pi f_hi t) - sin(2 pi f_lo t)) / (pi t),
    Hamming-windowed and normalized per filter.
    """
    low = min_low_hz + low_hz.abs()
    high = torch.clamp(low + min_band_hz + band_hz.abs(), min_low_hz,
                       sample_rate / 2)
    band = high - low
    half = (kernel_size - 1) // 2
    like = dict(dtype=low_hz.dtype, device=low_hz.device)
    t = torch.arange(-half, 0, **like)
    n_ = 2.0 * math.pi * t / sample_rate
    window = 0.54 - 0.46 * torch.cos(
        2.0 * math.pi * torch.arange(half, **like) / (kernel_size - 1))
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

    def kernels(self) -> torch.Tensor:
        """Materialized (n_filters, 1, taps) filterbank, in the
        parameters' dtype (float32)."""
        return sinc_filters(self.filterbank.low_hz_[:, 0],
                            self.filterbank.band_hz_[:, 0],
                            SINC_KERNEL_SIZE, self.sample_rate)

    def raw_conv(self, x: torch.Tensor,
                 dtype: torch.dtype = torch.float32) -> torch.Tensor:
        """The strided conv in ``dtype``; the output is left in ``dtype``
        (bf16 rounds it once, as the JAX ``raw_conv`` does)."""
        return F.conv1d(x.to(dtype), self.kernels().to(dtype),
                        stride=self.stride)

    def forward(self, x: torch.Tensor,
                dtype: torch.dtype = torch.float32) -> torch.Tensor:
        return self.raw_conv(x, dtype).to(x.dtype)


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

    @staticmethod
    def compute_dtype(x: torch.Tensor) -> torch.dtype:
        """bf16 where the PYANNOTE_TPU_SEG_BF16 gate is on for ``x``'s
        device, else ``x``'s dtype (float32; float64 for a model in
        float64)."""
        return torch.bfloat16 if device_flag("PYANNOTE_TPU_SEG_BF16",
                                             x.device) else x.dtype

    def forward(self, waveforms: torch.Tensor) -> torch.Tensor:
        dtype = self.compute_dtype(waveforms)
        with exact_float32_if(dtype):
            x = self.wav_norm1d(waveforms)
            return self.post_conv(self.conv1d[0](x, dtype), dtype)

    def post_conv(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        """Everything after the sinc conv: abs + 3 x (pool, norm, leaky
        relu) with the two k=5 convs in ``dtype``; (B, 80, T) float32 ->
        (B, frames, 60) in the input's dtype."""
        x = x.abs()
        for i in range(3):
            if i > 0:
                conv = self.conv1d[i]
                # conv, then the bias added in ``dtype``: two roundings in
                # bf16, as flax's nn.Conv(dtype=bf16) does them
                x = (F.conv1d(x.to(dtype), conv.weight.to(dtype))
                     + conv.bias.to(dtype)[:, None]).to(x.dtype)
            x = F.leaky_relu(self.norm1d[i](F.max_pool1d(x, 3, 3)), 0.01)
        return x.transpose(1, 2)

    # -- shared whole-file front-end -----------------------------------------
    #
    # The sinc conv is linear, so the conv of an instance-normalized chunk
    # is an affine function of the conv of the raw waveform: with the
    # chunk's mean m and population variance v and the norm's affine
    # (gamma, beta),
    #   conv(gamma * (x - m) / sqrt(v + eps) + beta)
    #     = gamma / sqrt(v + eps) * conv(x)
    #       + (beta - gamma * m / sqrt(v + eps)) * K1
    # where K1[f] is the sum of filter f's taps. One conv over the whole
    # file then serves every chunk whose start lies on the conv stride.

    def whole_conv(self, waveform: torch.Tensor) -> torch.Tensor:
        """Sinc conv of the raw (un-normalized) waveform: (B, 1, T) ->
        (B, 80, F_all), kept in the compute dtype (bf16 halves the
        whole-file buffer)."""
        dtype = self.compute_dtype(waveform)
        with exact_float32_if(dtype):
            return self.conv1d[0].raw_conv(waveform, dtype)

    def from_conv(self, frames: torch.Tensor, mean: torch.Tensor,
                  var: torch.Tensor) -> torch.Tensor:
        """Finish the block from gathered ``whole_conv`` frames.

        frames: (B, 80, F_c) slices of ``whole_conv``'s output; mean, var:
        (B,) each chunk's raw-waveform mean and population variance.
        """
        norm = self.wav_norm1d
        k1 = self.conv1d[0].kernels()[:, 0].sum(dim=-1)        # (80,)
        inv = norm.weight[0] / torch.sqrt(var + norm.eps)      # (B,)
        shift = norm.bias[0] - mean * inv
        x = frames.to(inv.dtype) * inv[:, None, None] \
            + shift[:, None, None] * k1[None, :, None]
        dtype = self.compute_dtype(x)
        with exact_float32_if(dtype):
            return self.post_conv(x, dtype)

    @staticmethod
    def conv_num_frames(num_samples: int, stride: int = 10) -> int:
        """Sinc-conv output frames for ``num_samples`` input samples."""
        return conv1d_num_frames(num_samples, kernel_size=SINC_KERNEL_SIZE,
                                 stride=stride)

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
