"""Plain PyanNet: SincNet -> BiLSTM -> feed-forward -> powerset log-softmax.

The published pyannote segmentation model (pyannote/segmentation-3.0's
architecture, as pyannote.audio's ``PyanNet`` and asteroid's
``ParamSincFB`` define it), written from that description in plain
PyTorch over a state dict in the reference checkpoint layout
(``sincnet.*``, ``lstm.weight_ih_l0``, ``linear.{i}.*``,
``classifier.*``). Each chunk is normalised and convolved on its own;
the LSTM is an explicit loop over time (no library recurrence), both
directions of a layer stepped together. Every product is float32 with
TF32 off, unless a ``Numerics`` mode rounds the operands that the
configuration computes in bf16 (the sinc and 1-D convolutions, the
recurrent product's h and W_hh).
"""

from __future__ import annotations

import itertools
import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from .numerics import Numerics

SINC_TAPS = 251
SINC_FILTERS = 80
# (kernel, stride) of sinc conv, pool, conv, pool, conv, pool
LADDER = ((SINC_TAPS, None), (3, 3), (5, 1), (3, 3), (5, 1), (3, 3))


def mel_bands(n_filters: int, sample_rate: int) -> Tuple[torch.Tensor,
                                                          torch.Tensor]:
    """asteroid's mel-spaced initial (low_hz_, band_hz_), as (n, 1)."""
    high = sample_rate / 2 - (50.0 + 50.0)
    to_mel = lambda hz: 2595.0 * math.log10(1.0 + hz / 700.0)  # noqa: E731
    mels = torch.linspace(to_mel(30.0), to_mel(high), n_filters + 1,
                          dtype=torch.float64)
    hz = 700.0 * (10.0 ** (mels / 2595.0) - 1.0)
    return hz[:-1, None].float(), (hz[1:] - hz[:-1])[:, None].float()


def sinc_kernels(low_hz_: torch.Tensor, band_hz_: torch.Tensor,
                 sample_rate: int) -> torch.Tensor:
    """(n, 1) band edges -> (n, 1, 251) Hamming-windowed band-pass
    filters, each divided by twice its band (asteroid ParamSincFB)."""
    low = 50.0 + low_hz_.abs()
    high = torch.clamp(low + 50.0 + band_hz_.abs(), 50.0, sample_rate / 2)
    band = (high - low)[:, 0]
    half = (SINC_TAPS - 1) // 2
    n = torch.arange(-half, 0, dtype=low.dtype, device=low.device)
    n_ = 2 * math.pi * n / sample_rate
    n_lin = torch.linspace(0, SINC_TAPS / 2 - 1, int(SINC_TAPS / 2),
                           dtype=low.dtype, device=low.device)
    window = 0.54 - 0.46 * torch.cos(2 * math.pi * n_lin / SINC_TAPS)
    left = (torch.sin(high * n_) - torch.sin(low * n_)) / (n_ / 2) * window
    filters = torch.cat([left, 2 * band[:, None], left.flip(1)], dim=1)
    return (filters / (2 * band[:, None]))[:, None, :]


def instance_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                  eps: float = 1e-5) -> torch.Tensor:
    mean = x.mean(dim=-1, keepdim=True)
    var = (x - mean).square().mean(dim=-1, keepdim=True)
    return (x - mean) / torch.sqrt(var + eps) * weight[:, None] \
        + bias[:, None]


def sincnet(waveforms: torch.Tensor, p: Dict[str, torch.Tensor],
            stride: int, sample_rate: int, num: Numerics) -> torch.Tensor:
    """(B, 1, samples) -> (B, frames, 60)."""
    x = instance_norm(waveforms, p["sincnet.wav_norm1d.weight"],
                      p["sincnet.wav_norm1d.bias"])
    kernels = sinc_kernels(p["sincnet.conv1d.0.filterbank.low_hz_"],
                           p["sincnet.conv1d.0.filterbank.band_hz_"],
                           sample_rate)
    x = F.conv1d(num.low(x), num.low(kernels), stride=stride).abs()
    for i in range(3):
        if i > 0:
            x = F.conv1d(num.low(x), num.low(p[f"sincnet.conv1d.{i}.weight"]),
                         p[f"sincnet.conv1d.{i}.bias"])
        x = F.max_pool1d(x, 3, 3)
        x = F.leaky_relu(instance_norm(x, p[f"sincnet.norm1d.{i}.weight"],
                                       p[f"sincnet.norm1d.{i}.bias"]), 0.01)
    return x.transpose(1, 2)


def lstm(x: torch.Tensor, p: Dict[str, torch.Tensor], prefix: str,
         num_layers: int, num: Numerics) -> torch.Tensor:
    """(B, T, I) -> (B, T, 2H): a bidirectional LSTM (gates i, f, g, o;
    both biases), the input projection float32, the recurrent product on
    ``num.low`` operands."""
    for i in range(num_layers):
        names = [f"{prefix}.{{}}_l{i}", f"{prefix}.{{}}_l{i}_reverse"]
        xw = torch.stack([
            x @ p[n.format("weight_ih")].t() + p[n.format("bias_ih")]
            + p[n.format("bias_hh")] for n in names])         # (2, B, T, 4H)
        xw[1] = xw[1].flip(1)
        w_hh = torch.stack([p[n.format("weight_hh")] for n in names])
        w_hh = num.low(w_hh).transpose(1, 2)                   # (2, H, 4H)
        D, B, T, H4 = xw.shape
        H = H4 // 4
        h = xw.new_zeros(D, B, H)
        c = xw.new_zeros(D, B, H)
        out = xw.new_empty(D, B, T, H)
        for t in range(T):
            gates = xw[:, :, t] + torch.bmm(num.low(h), w_hh)
            g_i, g_f, g_g, g_o = gates.split(H, dim=-1)
            c = torch.sigmoid(g_f) * c + torch.sigmoid(g_i) * torch.tanh(g_g)
            h = torch.sigmoid(g_o) * torch.tanh(c)
            out[:, :, t] = h
        out[1] = out[1].flip(1)
        x = torch.cat([out[0], out[1]], dim=-1)
    return x


def head(x: torch.Tensor, p: Dict[str, torch.Tensor], hp: dict,
         logits: bool = False) -> torch.Tensor:
    """The linear layers and the classifier over the BiLSTM's output."""
    for i in range(hp["linear"]["num_layers"]):
        x = F.leaky_relu(x @ p[f"linear.{i}.weight"].t()
                         + p[f"linear.{i}.bias"], 0.01)
    x = x @ p["classifier.weight"].t() + p["classifier.bias"]
    return x if logits else torch.log_softmax(x, dim=-1)


def pyannet(chunks: torch.Tensor, p: Dict[str, torch.Tensor], hp: dict,
            num: Numerics, logits: bool = False, features: bool = False
            ) -> torch.Tensor:
    """(B, 1, samples) chunks -> (B, frames, classes) powerset log-probs
    (the classifier's logits with ``logits``, the BiLSTM's output with
    ``features``)."""
    with num.flags():
        x = sincnet(chunks, p, hp["sincnet"]["stride"], hp["sample_rate"],
                    num)
        x = lstm(x, p, "lstm", hp["lstm"]["num_layers"], num)
        return x if features else head(x, p, hp, logits)


def powerset_mapping(num_classes: int, max_set: int) -> torch.Tensor:
    """(powerset classes, classes) 0/1: the empty set, then the
    singletons, then the pairs, each in lexicographic order."""
    rows = [[float(k in combo) for k in range(num_classes)]
            for size in range(max_set + 1)
            for combo in itertools.combinations(range(num_classes), size)]
    return torch.tensor(rows)


def to_multilabel(logprobs: torch.Tensor, mapping: torch.Tensor
                  ) -> torch.Tensor:
    """Hard powerset decoding: the first best class, then its members."""
    return mapping.to(logprobs.device)[logprobs.argmax(dim=-1)]


def conv_frames(num_samples: int, stride: int) -> int:
    """Output frames of the SincNet ladder for ``num_samples`` inputs."""
    n = num_samples
    for kernel, step in LADDER:
        n = (n - kernel) // (step or stride) + 1
    return n


def receptive_field(stride: int, sample_rate: int) -> Tuple[float, float]:
    """(duration, step) in seconds of one output frame."""
    size, jump = 1, 1
    for kernel, step in LADDER:
        size += (kernel - 1) * jump
        jump *= step or stride
    return size / sample_rate, jump / sample_rate


def leaves(hp: dict, weight_scale: float):
    """The state dict's leaves and how the benchmark draws them: torch's
    inits (the LSTM's and the linear layers' weights ``weight_scale``
    times theirs), the sinc band edges at asteroid's mel spacing."""
    from ..weights import Leaf
    low, band = mel_bands(SINC_FILTERS, hp["sample_rate"])
    out = [Leaf("sincnet.wav_norm1d.weight", (1,), ("const", 1.0)),
           Leaf("sincnet.wav_norm1d.bias", (1,), ("const", 0.0)),
           Leaf("sincnet.conv1d.0.filterbank.low_hz_", (80, 1),
                ("given", low)),
           Leaf("sincnet.conv1d.0.filterbank.band_hz_", (80, 1),
                ("given", band))]
    for i, cin in ((1, 80), (2, 60)):
        bound = (cin * 5) ** -0.5
        out += [Leaf(f"sincnet.conv1d.{i}.weight", (60, cin, 5),
                     ("uniform", bound)),
                Leaf(f"sincnet.conv1d.{i}.bias", (60,), ("uniform", bound))]
    for i, width in enumerate((80, 60, 60)):
        out += [Leaf(f"sincnet.norm1d.{i}.weight", (width,), ("const", 1.0)),
                Leaf(f"sincnet.norm1d.{i}.bias", (width,), ("const", 0.0))]
    H, layers = hp["lstm"]["hidden_size"], hp["lstm"]["num_layers"]
    bound = H ** -0.5
    width = 60
    for i in range(layers):
        for suffix in ("", "_reverse"):
            out += [Leaf(f"lstm.weight_ih_l{i}{suffix}", (4 * H, width),
                         ("uniform", bound * weight_scale)),
                    Leaf(f"lstm.weight_hh_l{i}{suffix}", (4 * H, H),
                         ("uniform", bound * weight_scale)),
                    Leaf(f"lstm.bias_ih_l{i}{suffix}", (4 * H,),
                         ("uniform", bound)),
                    Leaf(f"lstm.bias_hh_l{i}{suffix}", (4 * H,),
                         ("uniform", bound))]
        width = 2 * H
    for i in range(hp["linear"]["num_layers"]):
        bound = width ** -0.5
        out += [Leaf(f"linear.{i}.weight", (hp["linear"]["hidden_size"],
                                            width),
                     ("uniform", bound * weight_scale)),
                Leaf(f"linear.{i}.bias", (hp["linear"]["hidden_size"],),
                     ("uniform", bound))]
        width = hp["linear"]["hidden_size"]
    return out, width


def head_leaves(spec: dict, width: int):
    """The classifier's leaves at torch's init, one output per powerset
    class of ``spec``'s specifications."""
    from ..weights import Leaf
    classes = powerset_mapping(
        len(spec["specifications"]["classes"]),
        spec["specifications"]["powerset_max_classes"]).shape[0]
    bound = width ** -0.5
    return [Leaf("classifier.weight", (classes, width), ("uniform", bound)),
            Leaf("classifier.bias", (classes,), ("uniform", bound))]


# -- the segmentation kind "pyannet" (``segmentation_models``) ----------------

BATCH = 256


def hparams(spec: dict) -> dict:
    """The hyper-parameters ``pyannet`` takes."""
    return spec["hparams"]


def forward(spec: dict, p: Dict[str, torch.Tensor], chunks: torch.Tensor,
            num: Numerics, features: bool = False) -> torch.Tensor:
    """(B, 1, samples) -> (B, frames, powerset classes) log-probs (the
    BiLSTM's output with ``features``), in batches that fit the card."""
    return torch.cat([
        pyannet(chunks[b:b + BATCH].contiguous(), p, spec["hparams"], num,
                features=features)
        for b in range(0, len(chunks), BATCH)])


def num_frames(spec: dict, num_samples: int) -> int:
    return conv_frames(num_samples, spec["hparams"]["sincnet"]["stride"])


def frames(spec: dict) -> Tuple[float, float]:
    return receptive_field(spec["hparams"]["sincnet"]["stride"],
                           spec["hparams"]["sample_rate"])


def chunk_flops(spec: dict, window: int, classes: int) -> Tuple[int, int]:
    """(FLOPs after the shared sinc conv, LSTM steps) of one chunk."""
    from ..flops import pyannet_chunk_flops
    hp = spec["hparams"]
    return pyannet_chunk_flops(
        window, hp["sincnet"]["stride"], hp["lstm"]["hidden_size"],
        hp["lstm"]["num_layers"], hp["linear"]["hidden_size"],
        hp["linear"]["num_layers"], classes)


def shared_flops(spec: dict, padded: int) -> Dict[str, int]:
    """The sinc conv, which the chunks share, over the grid-padded
    recording."""
    from ..flops import conv1d_flops, conv1d_out
    stride = spec["hparams"]["sincnet"]["stride"]
    return {"sinc": conv1d_flops(conv1d_out(padded, SINC_TAPS, stride),
                                 SINC_TAPS, 1, SINC_FILTERS)}
