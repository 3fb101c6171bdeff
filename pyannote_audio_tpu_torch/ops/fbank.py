"""Kaldi-compatible log-mel filterbank features in PyTorch.

Counterpart of pyannote_audio_tpu/ops/fbank.py's exact path
(``kaldi_mel_banks``, the rfft branch of ``fbank_impl``,
``wespeaker_fbank``): snip-edges framing, DC-offset removal, preemphasis
0.97, window, power-of-two FFT padding, Kaldi mel banks, log with a
float-eps floor, then the WeSpeaker per-chunk mean subtraction.
``whole_fbank`` is the uncentered whole-file fbank that the diarization
pipeline slices per chunk (the JAX pipeline's ``_make_whole_fbank_fn``).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

EPSILON = 1.1920928955078125e-07  # float32 machine epsilon, kaldi's log floor


def _mel(hz):
    return 1127.0 * np.log(1.0 + hz / 700.0)


@functools.lru_cache(maxsize=None)
def kaldi_mel_banks(num_bins: int, window_length_padded: int,
                    sample_rate: float, low_freq: float = 20.0,
                    high_freq: float = 0.0) -> np.ndarray:
    """(num_fft_bins+1, num_bins) triangular mel filterbank, Kaldi-style.

    ``high_freq <= 0`` means nyquist + high_freq. The extra final row is the
    zero-padded nyquist bin.
    """
    num_fft_bins = window_length_padded // 2
    nyquist = 0.5 * sample_rate
    if high_freq <= 0.0:
        high_freq = nyquist + high_freq
    fft_bin_width = sample_rate / window_length_padded
    mel_low = _mel(low_freq)
    mel_high = _mel(high_freq)
    mel_delta = (mel_high - mel_low) / (num_bins + 1)

    bin_mels = _mel(fft_bin_width * np.arange(num_fft_bins))
    left = mel_low + np.arange(num_bins) * mel_delta
    center = left + mel_delta
    right = center + mel_delta

    up = (bin_mels[None, :] - left[:, None]) / mel_delta
    down = (right[:, None] - bin_mels[None, :]) / mel_delta
    banks = np.maximum(0.0, np.minimum(up, down))
    banks = np.concatenate([banks, np.zeros((num_bins, 1))], axis=1)
    return banks.T.astype(np.float32)


@functools.lru_cache(maxsize=None)
def _window(window_type: str, length: int) -> np.ndarray:
    n = np.arange(length, dtype=np.float64)
    if window_type == "hamming":
        w = 0.54 - 0.46 * np.cos(2 * np.pi * n / (length - 1))
    elif window_type == "hanning":
        w = 0.5 - 0.5 * np.cos(2 * np.pi * n / (length - 1))
    elif window_type == "povey":
        w = (0.5 - 0.5 * np.cos(2 * np.pi * n / (length - 1))) ** 0.85
    elif window_type == "rectangular":
        w = np.ones(length)
    else:
        raise ValueError(f"unknown window type {window_type!r}")
    return w.astype(np.float32)


def fbank_num_frames(num_samples: int, sample_rate: int = 16000,
                     frame_length: float = 25.0,
                     frame_shift: float = 10.0) -> int:
    window_size = int(sample_rate * frame_length * 0.001)
    window_shift = int(sample_rate * frame_shift * 0.001)
    if num_samples < window_size:
        return 0
    return 1 + (num_samples - window_size) // window_shift


def fbank(waveform: torch.Tensor, sample_rate: int = 16000,
          num_mel_bins: int = 80, frame_length: float = 25.0,
          frame_shift: float = 10.0, window_type: str = "povey",
          preemphasis_coefficient: float = 0.97) -> torch.Tensor:
    """(..., num_samples) -> (..., num_frames, num_mel_bins) log-mel."""
    window_size = int(sample_rate * frame_length * 0.001)
    window_shift = int(sample_rate * frame_shift * 0.001)
    padded = 1 << (window_size - 1).bit_length()
    batch_shape = waveform.shape[:-1]
    num_frames = fbank_num_frames(waveform.shape[-1], sample_rate,
                                  frame_length, frame_shift)
    if num_frames == 0:
        return waveform.new_zeros(batch_shape + (0, num_mel_bins))
    x = waveform.reshape(-1, waveform.shape[-1])
    frames = x.unfold(-1, window_size, window_shift)[:, :num_frames]
    frames = frames - frames.mean(dim=-1, keepdim=True)
    if preemphasis_coefficient != 0.0:
        frames = torch.cat(
            [frames[..., :1] - preemphasis_coefficient * frames[..., :1],
             frames[..., 1:] - preemphasis_coefficient * frames[..., :-1]],
            dim=-1)
    frames = frames * torch.from_numpy(
        _window(window_type, window_size)).to(frames.device)
    spectrum = torch.fft.rfft(frames, n=padded, dim=-1)
    power = spectrum.real.square() + spectrum.imag.square()
    banks = torch.from_numpy(kaldi_mel_banks(
        num_mel_bins, padded, sample_rate)).to(power.device)
    mel = torch.matmul(power, banks)
    out = torch.log(torch.clamp(mel, min=EPSILON))
    return out.reshape(batch_shape + (num_frames, num_mel_bins))


def wespeaker_fbank(waveforms: torch.Tensor, num_mel_bins: int = 80,
                    sample_rate: int = 16000, frame_length: float = 25.0,
                    frame_shift: float = 10.0,
                    window_type: str = "hamming") -> torch.Tensor:
    """WeSpeaker front-end: x * 2^15 -> fbank -> per-chunk mean centering.

    Input (batch, channel, samples), mono (the channel axis is squeezed);
    output (batch, frames, mel).
    """
    x = waveforms[..., 0, :] if waveforms.dim() == 3 else waveforms
    feats = fbank(x * 32768.0, sample_rate=sample_rate,
                  num_mel_bins=num_mel_bins, frame_length=frame_length,
                  frame_shift=frame_shift, window_type=window_type)
    return feats - feats.mean(dim=-2, keepdim=True)


def whole_fbank(waveform: torch.Tensor, num_mel_bins: int = 80,
                sample_rate: int = 16000, frame_length: float = 25.0,
                frame_shift: float = 10.0,
                window_type: str = "hamming") -> torch.Tensor:
    """(channel, samples) mono waveform -> (frames, mel) uncentered fbank
    in the kaldi x32768 scale; ``fbank_num_frames(samples)`` frames.

    Each frame depends only on its own window, so when a chunk starts on
    the frame shift, frames ``start // shift`` onwards are exactly the
    chunk's own fbank before centering.
    """
    return fbank(waveform[0] * 32768.0, sample_rate=sample_rate,
                 num_mel_bins=num_mel_bins, frame_length=frame_length,
                 frame_shift=frame_shift, window_type=window_type)
