"""Kaldi-compatible log-mel filterbank features in PyTorch.

Counterpart of pyannote_audio_tpu/ops/fbank.py's exact path
(``kaldi_mel_banks``, the rfft branch of ``fbank_impl``,
``wespeaker_fbank``): snip-edges framing, DC-offset removal, preemphasis
0.97, window, power-of-two FFT padding, Kaldi mel banks, log with a
float-eps floor, then the WeSpeaker per-chunk mean subtraction.
``whole_fbank`` is the uncentered whole-file fbank that the diarization
pipeline slices per chunk (the JAX pipeline's ``_make_whole_fbank_fn``).

The power spectrum takes one of the JAX package's three routes:

- the composed conv (PYANNOTE_TPU_CONV_FBANK, by default on a CUDA
  device, off on the CPU): DC removal, preemphasis, window and the real
  DFT are linear maps of a frame, so they compose into one (window,
  2 x bins) kernel, built in float64; the spectrum is then one float32
  convolution of stride ``shift`` over the waveform, with no framed
  copy of it;
- the DFT as two float32 matmuls over the frames (PYANNOTE_TPU_DFT_FBANK
  = "1", opt-in; the conv gate wins when both are on);
- the rfft of the zero-padded frames (cuFFT on the card), otherwise.

The conv and the matmuls are library calls, as in the JAX package, which
computes them outside any Pallas kernel; they run in float32 with TF32 off
(the JAX package's ``Precision.HIGHEST``).
"""

from __future__ import annotations

import functools
import os

import numpy as np
import torch

from ..utils.runtime import device_flag, exact_float32

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


@functools.lru_cache(maxsize=None)
def _conv_dft_kernel_np(window_size: int, padded: int, window_type: str,
                        remove_dc_offset: bool,
                        preemphasis_coefficient: float) -> np.ndarray:
    """(window_size, 2*(padded//2+1)) composed frame -> [re | im] matrix.

    For a frame column vector f: out = C^T W P A f, with A the DC removal,
    P the preemphasis (kaldi's edge: the first sample is its own left
    neighbour), W = diag(window), C the real-DFT basis. As a row-vector
    kernel K = A^T P^T W C, composed in float64.
    """
    n = window_size
    A = np.eye(n)
    if remove_dc_offset:
        A = A - np.full((n, n), 1.0 / n)
    P = np.eye(n)
    if preemphasis_coefficient != 0.0:
        c = float(preemphasis_coefficient)
        P[np.arange(1, n), np.arange(0, n - 1)] = -c
        P[0, 0] = 1.0 - c
    w = _window(window_type, n).astype(np.float64)
    k = np.arange(padded // 2 + 1)
    angle = 2.0 * np.pi * np.outer(np.arange(n), k) / padded
    C = np.concatenate([np.cos(angle), -np.sin(angle)], axis=1)
    K = A.T @ P.T @ (w[:, None] * C)
    return K.astype(np.float32)


@functools.lru_cache(maxsize=None)
def _dft_basis_np(window_size: int, padded: int) -> np.ndarray:
    """(window_size, 2*(padded//2+1)) [cos | -sin] real-DFT basis; rows
    past the window, which would meet zero padding, are left out."""
    k = np.arange(padded // 2 + 1)
    angle = 2.0 * np.pi * np.outer(np.arange(window_size), k) / padded
    return np.concatenate([np.cos(angle), -np.sin(angle)],
                          axis=1).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _constant(make, args: tuple, device: torch.device) -> torch.Tensor:
    """``make(*args)``, a numpy constant, as a tensor on ``device``,
    made once per device; to a CUDA device from page-locked memory, so
    that the copy does not make the host wait."""
    host = torch.from_numpy(make(*args))
    if device.type == "cuda":
        return host.pin_memory().to(device, non_blocking=True)
    return host


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
    device = x.device
    bins = padded // 2 + 1
    with exact_float32():
        if device_flag("PYANNOTE_TPU_CONV_FBANK", device):
            kernel = _constant(_conv_dft_kernel_np, (
                window_size, padded, window_type, True,
                float(preemphasis_coefficient)), device)  # (window, 2 bins)
            out = torch.nn.functional.conv1d(
                x[:, None, :], kernel.T[:, None, :],
                stride=window_shift)[:, :, :num_frames]
            power = (out[:, :bins].square()
                     + out[:, bins:].square()).transpose(1, 2)
        else:
            frames = x.unfold(-1, window_size, window_shift)[:, :num_frames]
            frames = frames - frames.mean(dim=-1, keepdim=True)
            if preemphasis_coefficient != 0.0:
                frames = torch.cat(
                    [frames[..., :1]
                     - preemphasis_coefficient * frames[..., :1],
                     frames[..., 1:]
                     - preemphasis_coefficient * frames[..., :-1]], dim=-1)
            frames = frames * _constant(_window, (window_type, window_size),
                                        device)
            if os.environ.get("PYANNOTE_TPU_DFT_FBANK", "0") == "1":
                out = torch.matmul(frames, _constant(
                    _dft_basis_np, (window_size, padded), device))
                power = out[..., :bins].square() + out[..., bins:].square()
            else:
                spectrum = torch.fft.rfft(frames, n=padded, dim=-1)
                power = spectrum.real.square() + spectrum.imag.square()
        mel = torch.matmul(power, _constant(
            kaldi_mel_banks, (num_mel_bins, padded, sample_rate), device))
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
