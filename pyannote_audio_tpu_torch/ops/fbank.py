"""Kaldi-compatible log-mel filterbank features in PyTorch.

Counterpart of pyannote_audio_tpu/ops/fbank.py's exact path
(``kaldi_mel_banks``, the rfft branch of ``fbank_impl``,
``wespeaker_fbank``): snip-edges framing, DC-offset removal, preemphasis
0.97, window, power-of-two FFT padding, Kaldi mel banks, log with a
float-eps floor, then the WeSpeaker per-chunk mean subtraction.
``whole_fbank`` is the uncentered whole-file fbank that the diarization
pipeline slices per chunk (the JAX pipeline's ``_make_whole_fbank_fn``).
``speechbrain_fbank`` (ECAPA-TDNN), ``nemo_mel_spectrogram`` (TitaNet)
and ``mfcc_features`` (the x-vectors; the JAX package's
models/embedding/xvector.py) are the other front-ends: centred STFTs
through the rfft, their mel matmuls in float32 with TF32 off.

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
from typing import Optional

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


# -- the SpeechBrain (ECAPA-TDNN) and NeMo (TitaNet) front-ends --------------

@functools.lru_cache(maxsize=None)
def _speechbrain_mel_banks(n_mels: int, n_fft: int, sample_rate: int,
                           f_min: float, f_max: float) -> np.ndarray:
    """(n_fft//2+1, n_mels) SpeechBrain filterbank: n_mels+2 points on the
    HTK mel scale, each triangle symmetric around its centre with
    half-width the gap to its left neighbour."""
    def to_mel(hz):
        return 2595.0 * np.log10(1.0 + hz / 700.0)

    def to_hz(mel):
        return 700.0 * (10.0 ** (mel / 2595.0) - 1.0)

    hz = to_hz(np.linspace(to_mel(f_min), to_mel(f_max), n_mels + 2))
    band = (hz[1:] - hz[:-1])[:-1]          # (n_mels,) left gaps
    f_central = hz[1:-1]
    all_freqs = np.linspace(0, sample_rate // 2, n_fft // 2 + 1)
    slope = (all_freqs[:, None] - f_central[None, :]) / band[None, :]
    banks = np.maximum(0.0, np.minimum(slope + 1.0, -slope + 1.0))
    return banks.astype(np.float32)


def speechbrain_fbank_num_frames(num_samples: int, hop: int = 160) -> int:
    """Centred STFT frame count: 1 + num_samples // hop."""
    return 1 + num_samples // hop


@functools.lru_cache(maxsize=None)
def _centered_window(kind: str, win_length: int, n_fft: int) -> np.ndarray:
    """A ``win_length`` window zero-padded to ``n_fft`` on both sides, as
    torch.stft centres a short window: "hamming" periodic (SpeechBrain),
    "hann" symmetric (NeMo), "periodic_hann" (torchaudio's MFCC)."""
    n = np.arange(win_length, dtype=np.float64)
    if kind == "hamming":
        window = 0.54 - 0.46 * np.cos(2 * np.pi * n / win_length)
    elif kind == "periodic_hann":
        window = 0.5 - 0.5 * np.cos(2 * np.pi * n / win_length)
    else:
        window = 0.5 - 0.5 * np.cos(2 * np.pi * n / (win_length - 1))
    full = np.zeros(n_fft, dtype=np.float32)
    left = (n_fft - win_length) // 2
    full[left:left + win_length] = window
    return full


def _centered_stft_power(x: torch.Tensor, n_fft: int, hop_length: int,
                         num_frames: int, window: torch.Tensor,
                         pad_mode: str = "constant") -> torch.Tensor:
    """torch.stft(center=True) power spectrum: (batch, samples) ->
    (batch, num_frames, n_fft//2+1). Pads ``n_fft//2`` on both sides in
    ``pad_mode``, then zeros up to the last frame's end."""
    pad = n_fft // 2
    x = torch.nn.functional.pad(x[:, None], (pad, pad), mode=pad_mode)[:, 0]
    needed = (num_frames - 1) * hop_length + n_fft
    if x.shape[-1] < needed:
        x = torch.nn.functional.pad(x, (0, needed - x.shape[-1]))
    frames = x.unfold(-1, n_fft, hop_length)[:, :num_frames] * window
    spectrum = torch.fft.rfft(frames, dim=-1)
    return spectrum.real.square() + spectrum.imag.square()


def _power_to_db(power: torch.Tensor, amin: float, top_db: float
                 ) -> torch.Tensor:
    """10 log10(max(power, amin)), floored at ``top_db`` below each item's
    maximum (torchaudio's ``amplitude_to_DB``, SpeechBrain's ``Fbank``)."""
    db = 10.0 * torch.log10(torch.clamp(power, min=amin))
    return torch.maximum(db, db.amax(dim=(-2, -1), keepdim=True) - top_db)


def speechbrain_fbank(waveforms: torch.Tensor, n_mels: int = 80,
                      sample_rate: int = 16000, n_fft: int = 400,
                      win_length: Optional[int] = None,
                      hop_length: Optional[int] = None,
                      f_min: float = 0.0, f_max: float = 8000.0,
                      amin: float = 1e-10, top_db: float = 80.0
                      ) -> torch.Tensor:
    """SpeechBrain ``Fbank`` (ECAPA-TDNN's input): centred STFT with zero
    padding and a periodic hamming window, power spectrum, SpeechBrain's
    mel banks, 10 log10 with a per-utterance ``max - top_db`` floor.

    (batch[, 1], samples) -> (batch, 1 + samples // hop, n_mels).
    ``win_length`` / ``hop_length`` default to 25 / 10 ms.
    """
    if win_length is None:
        win_length = int(round(sample_rate * 0.025))
    if hop_length is None:
        hop_length = int(round(sample_rate * 0.010))
    x = waveforms[..., 0, :] if waveforms.dim() == 3 else waveforms
    device = x.device
    num_frames = speechbrain_fbank_num_frames(x.shape[-1], hop_length)
    with exact_float32():
        power = _centered_stft_power(
            x, n_fft, hop_length, num_frames,
            _constant(_centered_window, ("hamming", win_length, n_fft),
                      device))
        mel = torch.matmul(power, _constant(_speechbrain_mel_banks, (
            n_mels, n_fft, sample_rate, f_min, f_max), device))
    return _power_to_db(mel, amin, top_db)


@functools.lru_cache(maxsize=None)
def _htk_mel_fbanks(n_freqs: int, n_mels: int, sample_rate: int
                    ) -> np.ndarray:
    """(n_freqs, n_mels) triangular filterbank, torchaudio
    ``melscale_fbanks`` with mel_scale="htk", norm=None, 0 Hz to
    Nyquist."""
    def hz_to_mel(f):
        return 2595.0 * np.log10(1.0 + np.asarray(f) / 700.0)

    def mel_to_hz(m):
        return 700.0 * (10.0 ** (np.asarray(m) / 2595.0) - 1.0)

    all_freqs = np.linspace(0, sample_rate // 2, n_freqs)
    f_pts = mel_to_hz(np.linspace(hz_to_mel(0.0),
                                  hz_to_mel(sample_rate / 2.0), n_mels + 2))
    f_diff = f_pts[1:] - f_pts[:-1]
    slopes = f_pts[None, :] - all_freqs[:, None]
    down = -slopes[:, :-2] / f_diff[:-1]
    up = slopes[:, 2:] / f_diff[1:]
    return np.maximum(0.0, np.minimum(down, up)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _dct_ortho(n_mfcc: int, n_mels: int) -> np.ndarray:
    """(n_mels, n_mfcc) DCT-II basis with ortho norm (torchaudio
    ``create_dct``)."""
    k = np.arange(n_mfcc)[:, None]
    m = np.arange(n_mels)[None, :]
    basis = np.cos(np.pi / n_mels * (m + 0.5) * k) * np.sqrt(2.0 / n_mels)
    basis[0] *= 1.0 / np.sqrt(2.0)
    return basis.T.astype(np.float32)


def mfcc_features(waveforms: torch.Tensor, sample_rate: int = 16000,
                  n_mfcc: int = 40, n_mels: int = 128, n_fft: int = 400,
                  hop: int = 200, top_db: float = 80.0) -> torch.Tensor:
    """torchaudio ``transforms.MFCC`` at its defaults (the x-vector's
    input): reflect-padded centred STFT with a periodic hann window (hop
    ``n_fft // 2``), power, HTK mel banks with no norm,
    ``amplitude_to_DB`` floored at ``top_db`` below each item's maximum,
    then an ortho DCT-II.

    (batch[, 1], samples) -> (batch, 1 + samples // hop, n_mfcc).
    """
    x = waveforms[..., 0, :] if waveforms.dim() == 3 else waveforms
    device = x.device
    with exact_float32():
        power = _centered_stft_power(
            x, n_fft, hop, 1 + x.shape[-1] // hop,
            _constant(_centered_window, ("periodic_hann", n_fft, n_fft),
                      device), pad_mode="reflect")
        mel = torch.matmul(power, _constant(
            _htk_mel_fbanks, (n_fft // 2 + 1, n_mels, sample_rate), device))
        return torch.matmul(_power_to_db(mel, 1e-10, top_db), _constant(
            _dct_ortho, (n_mfcc, n_mels), device))


@functools.lru_cache(maxsize=None)
def _slaney_mel_banks(n_mels: int, n_fft: int, sample_rate: int,
                      f_min: float, f_max: float) -> np.ndarray:
    """(n_fft//2+1, n_mels) librosa mel filterbank: Slaney mel scale
    (linear below 1 kHz, log above) with Slaney area normalisation, as
    NeMo's FilterbankFeatures builds it."""
    f_sp = 200.0 / 3.0
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0

    def to_mel(hz):
        hz = np.asarray(hz, dtype=np.float64)
        return np.where(hz >= min_log_hz,
                        min_log_mel + np.log(np.maximum(hz, min_log_hz)
                                             / min_log_hz) / logstep,
                        hz / f_sp)

    def to_hz(mel):
        mel = np.asarray(mel, dtype=np.float64)
        return np.where(mel >= min_log_mel,
                        min_log_hz * np.exp(logstep * (mel - min_log_mel)),
                        f_sp * mel)

    pts = to_hz(np.linspace(to_mel(f_min), to_mel(f_max), n_mels + 2))
    all_freqs = np.linspace(0, sample_rate / 2, n_fft // 2 + 1)
    fdiff = np.diff(pts)
    ramps = pts[:, None] - all_freqs[None, :]       # (n_mels+2, F)
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    weights *= (2.0 / (pts[2:] - pts[:-2]))[:, None]
    return weights.T.astype(np.float32)


def nemo_mel_num_frames(num_samples: int, hop: int = 160) -> int:
    """Centred STFT frame count: 1 + num_samples // hop."""
    return 1 + num_samples // hop


def nemo_mel_spectrogram(waveforms: torch.Tensor,
                         lengths: Optional[torch.Tensor] = None,
                         n_mels: int = 80, sample_rate: int = 16000,
                         n_fft: int = 512, win_length: int = 400,
                         hop_length: int = 160, preemph: float = 0.97,
                         log_zero_guard: float = 2.0 ** -24,
                         normalize: str = "per_feature",
                         frame_mask: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """NeMo ``AudioToMelSpectrogramPreprocessor`` (TitaNet's input) in eval
    mode: pre-emphasis, centred reflect-padded STFT with a symmetric hann
    window of ``win_length`` centred in ``n_fft``, power, Slaney mel
    banks, log(mel + 2^-24), then per-feature normalisation (unbiased std
    + 1e-5) over the valid frames, padded frames zeroed.

    ``lengths`` are sample counts (valid frames ``1 + lengths // hop``);
    a (batch, frames) ``frame_mask`` replaces them and may have holes.
    (batch[, 1], samples) -> (batch, 1 + samples // hop, n_mels).
    """
    x = waveforms[..., 0, :] if waveforms.dim() == 3 else waveforms
    device = x.device
    num_frames = nemo_mel_num_frames(x.shape[-1], hop_length)
    x = torch.cat([x[:, :1], x[:, 1:] - preemph * x[:, :-1]], dim=-1)
    with exact_float32():
        power = _centered_stft_power(
            x, n_fft, hop_length, num_frames,
            _constant(_centered_window, ("hann", win_length, n_fft), device),
            pad_mode="reflect")
        mel = torch.matmul(power, _constant(_slaney_mel_banks, (
            n_mels, n_fft, sample_rate, 0.0, sample_rate / 2.0), device))
    feats = torch.log(mel + log_zero_guard)               # (B, T, M)
    if frame_mask is not None:
        mask = frame_mask[:, :, None].to(feats.dtype)
    else:
        if lengths is None:
            valid = torch.full((x.shape[0],), num_frames, device=device)
        else:
            valid = 1 + torch.as_tensor(lengths, device=device).long() \
                // hop_length
        mask = (torch.arange(num_frames, device=device)[None, :, None]
                < valid[:, None, None]).to(feats.dtype)
    if normalize == "per_feature":
        count = torch.clamp(mask.sum(dim=1, keepdim=True), min=1.0)
        mean = (feats * mask).sum(dim=1, keepdim=True) / count
        var = ((feats - mean).square() * mask).sum(dim=1, keepdim=True) \
            / torch.clamp(count - 1.0, min=1.0)
        feats = (feats - mean) / (var.sqrt() + 1e-5)
    elif normalize not in (None, "none"):
        raise ValueError(f"unsupported normalize mode {normalize!r}")
    return feats * mask
