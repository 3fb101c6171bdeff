"""Plain WeSpeaker ResNet embeddings on the shared whole-file trunk.

The pipeline that both configurations run embeds every (chunk, local
speaker) pair from one trunk pass over the whole file (the accelerator
path of the program, the JAX package's design), not from one pass per
chunk as pyannote.audio does. That path is what is judged, so this
reference computes it, from its description, in plain PyTorch over a
state dict in the reference checkpoint layout (``resnet.*``):

1. Kaldi log-mel fbank (torchaudio.compliance.kaldi.fbank with
   WeSpeaker's settings: 25 ms Hamming frames every 10 ms, DC offset
   removed, preemphasis 0.97, 512-point FFT, 80 triangular mel bins from
   20 Hz, the float32 epsilon as log floor) of the waveform x 32768,
   zero-padded to the chunk grid;
2. a sliding mean over a chunk's worth of frames around each frame
   (frames [i - half, i + half), clipped to the real audio), frames past
   the real audio set to zero;
3. the ResNet trunk (BasicBlocks, BatchNorm on running statistics) over
   panels of 512 trunk frames with 64 frames of context on each side,
   which cover its receptive field, so that each panel's core equals the
   trunk of the whole file;
4. per chunk, its 125 trunk frames, weighted mean and unbiased weighted
   standard deviation under the speaker's frame mask (nearest-neighbour
   from the segmentation's frames), then the ``seg_1`` projection.

Every product is float32 with TF32 off, unless a ``Numerics`` mode rounds
the trunk's convolution operands (bf16 in the configuration).
"""

from __future__ import annotations

import math
from typing import Dict, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from .numerics import Numerics

SAMPLE_RATE = 16000
WINDOW = 400            # 25 ms
SHIFT = 160             # 10 ms
FFT = 512
MEL_BINS = 80
EPSILON = float(np.finfo(np.float32).eps)
STAGE_STRIDES = (1, 2, 2, 2)
PANEL_CORE, PANEL_HALO = 512, 64
BN_EPS = 1e-5


def fbank_frames(num_samples: int) -> int:
    return 0 if num_samples < WINDOW else 1 + (num_samples - WINDOW) // SHIFT


def mel_banks(device) -> torch.Tensor:
    """(FFT/2 + 1, MEL_BINS) Kaldi triangular mel weights (the Nyquist bin
    weighs nothing)."""
    mel = lambda hz: 1127.0 * np.log(1.0 + hz / 700.0)  # noqa: E731
    low, high = mel(20.0), mel(SAMPLE_RATE / 2)
    delta = (high - low) / (MEL_BINS + 1)
    bins = mel(SAMPLE_RATE / FFT * np.arange(FFT // 2))
    left = low + np.arange(MEL_BINS) * delta
    up = (bins[None] - left[:, None]) / delta
    down = (left[:, None] + 2 * delta - bins[None]) / delta
    banks = np.maximum(0.0, np.minimum(up, down))
    banks = np.concatenate([banks, np.zeros((MEL_BINS, 1))], axis=1)
    return torch.tensor(banks.T, dtype=torch.float32, device=device)


def fbank(samples: torch.Tensor) -> torch.Tensor:
    """(samples,) waveform in [-1, 1] -> (frames, MEL_BINS) log-mel."""
    n = fbank_frames(samples.shape[0])
    frames = (samples * 32768.0).unfold(0, WINDOW, SHIFT)[:n]
    frames = frames - frames.mean(dim=1, keepdim=True)
    frames = torch.cat([frames[:, :1] * (1 - 0.97),
                        frames[:, 1:] - 0.97 * frames[:, :-1]], dim=1)
    k = torch.arange(WINDOW, dtype=torch.float64, device=samples.device)
    window = (0.54 - 0.46 * torch.cos(2 * math.pi * k / (WINDOW - 1))).float()
    spectrum = torch.fft.rfft(frames * window, n=FFT, dim=1)
    power = spectrum.real.square() + spectrum.imag.square()
    mel = power @ mel_banks(samples.device)
    return torch.log(torch.clamp(mel, min=EPSILON))


def sliding_cmn(feats: torch.Tensor, num_real: int, chunk_frames: int
                ) -> torch.Tensor:
    """Each frame minus the mean of frames [i - half, i + half) clipped to
    the ``num_real`` real frames; frames past them become 0."""
    T = feats.shape[0]
    idx = torch.arange(T, device=feats.device)
    real = (idx < num_real)[:, None]
    csum = F.pad(torch.cumsum(torch.where(real, feats, 0.0).double(), 0),
                 (0, 0, 1, 0))
    half = chunk_frames // 2
    lo = torch.clamp(idx - half, min=0)
    hi = torch.maximum(torch.clamp(idx + half, max=max(num_real, 1)), lo + 1)
    mean = ((csum[hi] - csum[lo]) / (hi - lo)[:, None]).float()
    return (feats - mean) * real


def batch_norm(x: torch.Tensor, p: Dict[str, torch.Tensor], name: str
               ) -> torch.Tensor:
    scale = p[f"{name}.weight"] / torch.sqrt(p[f"{name}.running_var"]
                                             + BN_EPS)
    shift = p[f"{name}.bias"] - p[f"{name}.running_mean"] * scale
    return x * scale[:, None, None] + shift[:, None, None]


def conv(x: torch.Tensor, weight: torch.Tensor, stride: int,
         num: Numerics) -> torch.Tensor:
    return F.conv2d(num.low(x), num.low(weight), stride=stride,
                    padding=weight.shape[-1] // 2)


def trunk(x: torch.Tensor, p: Dict[str, torch.Tensor],
          num_blocks: Sequence[int], num: Numerics) -> torch.Tensor:
    """(B, 1, mel, T) -> (B, C, F', T') with BasicBlocks."""
    x = F.relu(batch_norm(conv(x, p["resnet.conv1.weight"], 1, num), p,
                          "resnet.bn1"))
    for stage, (blocks, stride) in enumerate(zip(num_blocks, STAGE_STRIDES)):
        for i in range(blocks):
            name = f"resnet.layer{stage + 1}.{i}"
            s = stride if i == 0 else 1
            out = F.relu(batch_norm(conv(x, p[f"{name}.conv1.weight"], s, num),
                                    p, f"{name}.bn1"))
            out = batch_norm(conv(out, p[f"{name}.conv2.weight"], 1, num), p,
                             f"{name}.bn2")
            if f"{name}.shortcut.0.weight" in p:
                x = batch_norm(conv(x, p[f"{name}.shortcut.0.weight"], s, num),
                               p, f"{name}.shortcut.1")
            x = F.relu(out + x)
    return x


def trunk_frames(num_frames: int) -> int:
    for stride in STAGE_STRIDES:
        num_frames = (num_frames - 1) // stride + 1
    return num_frames


def whole_trunk(feats: torch.Tensor, rows: int, p: Dict[str, torch.Tensor],
                num_blocks: Sequence[int], num: Numerics,
                panels_per_call: int = 4) -> torch.Tensor:
    """(T, mel) centred fbank -> (rows, C * F') trunk frames, computed in
    panels of PANEL_CORE frames with PANEL_HALO frames of context."""
    stride = math.prod(STAGE_STRIDES)
    halo, core = PANEL_HALO * stride, PANEL_CORE * stride
    num_panels = -(-rows // PANEL_CORE)
    total = num_panels * core + 2 * halo
    x = F.pad(feats, (0, 0, halo, max(0, total - halo - feats.shape[0])))
    x = x[:total].T.contiguous()                            # (mel, frames)
    panels = x.unfold(1, core + 2 * halo, core)             # (mel, P, len)
    out = []
    for b in range(0, num_panels, panels_per_call):
        batch = panels[:, b:b + panels_per_call].transpose(0, 1)[:, None]
        y = trunk(batch.contiguous(), p, num_blocks, num)   # (P, C, F', t)
        y = y[..., PANEL_HALO:PANEL_HALO + PANEL_CORE]
        out.append(y.flatten(1, 2).permute(0, 2, 1).reshape(
            -1, y.shape[1] * y.shape[2]))
    return torch.cat(out)[:rows]


def stats_pool(frames: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """(B, T, D) frames and (B, S, F) weights -> (B, S, 2D): weighted
    mean and unbiased weighted standard deviation (pyannote StatsPool),
    the weights taken to T frames by nearest neighbour."""
    T, Fw = frames.shape[1], weights.shape[-1]
    weights = weights[..., (torch.arange(T, device=weights.device) * Fw)
                      // T]
    v1 = weights.sum(dim=-1) + 1e-8                           # (B, S)
    mean = torch.einsum("bst,btd->bsd", weights, frames) / v1[..., None]
    dx2 = (frames[:, None] - mean[:, :, None]).square()      # (B,S,T,D)
    v2 = weights.square().sum(dim=-1)
    var = torch.einsum("bst,bstd->bsd", weights, dx2) \
        / (v1 - v2 / v1 + 1e-8)[..., None]
    return torch.cat([mean, var.sqrt()], dim=-1)


def embeddings(samples: torch.Tensor, starts: np.ndarray, window: int,
               masks: torch.Tensor, p: Dict[str, torch.Tensor], hp: dict,
               num: Numerics, chunks_per_call: int = 64,
               project: bool = True) -> torch.Tensor:
    """(C, S, dim) embeddings of the chunks at ``starts`` (samples of the
    grid-padded ``samples``, whose first ``real`` samples are audio) under
    (C, S, F) masks. ``hp['real_samples']`` is the file's length. Without
    ``project``, the pooled statistics that ``seg_1`` projects."""
    chunk_frames = fbank_frames(window)
    width = trunk_frames(chunk_frames)
    feats = sliding_cmn(fbank(samples), fbank_frames(hp["real_samples"]),
                        chunk_frames)
    first = starts // SHIFT // math.prod(STAGE_STRIDES)
    rows = int(first[-1]) + width
    with num.flags():
        frames = whole_trunk(feats, rows, p, hp["num_blocks"], num)
        out = []
        offsets = torch.arange(width, device=frames.device)
        first = torch.as_tensor(first, device=frames.device)
        for b in range(0, len(starts), chunks_per_call):
            x = frames[first[b:b + chunks_per_call, None] + offsets]
            pooled = stats_pool(x, masks[b:b + chunks_per_call])
            out.append(pooled @ p["resnet.seg_1.weight"].t()
                       + p["resnet.seg_1.bias"] if project else pooled)
    return torch.cat(out)


def leaves(hp: dict):
    """The state dict's leaves (``num_batches_tracked`` aside) and how the
    benchmark draws them: LeCun-uniform convolutions, BatchNorm at its
    initial statistics, torch's init for ``seg_1``."""
    from ..weights import Leaf
    m = hp["m_channels"]

    def conv_leaf(name, cout, cin, k):
        return Leaf(name, (cout, cin, k, k),
                    ("uniform", (3.0 / (cin * k * k)) ** 0.5))

    def bn_leaves(name, c):
        return [Leaf(f"{name}.weight", (c,), ("const", 1.0)),
                Leaf(f"{name}.bias", (c,), ("const", 0.0)),
                Leaf(f"{name}.running_mean", (c,), ("const", 0.0)),
                Leaf(f"{name}.running_var", (c,), ("const", 1.0))]

    out = [conv_leaf("resnet.conv1.weight", m, 1, 3)]
    out += bn_leaves("resnet.bn1", m)
    cin = m
    for stage, (blocks, stride) in enumerate(zip(hp["num_blocks"],
                                                 STAGE_STRIDES)):
        mid = m * (1, 2, 4, 8)[stage]
        for i in range(blocks):
            name = f"resnet.layer{stage + 1}.{i}"
            s = stride if i == 0 else 1
            out.append(conv_leaf(f"{name}.conv1.weight", mid, cin, 3))
            out += bn_leaves(f"{name}.bn1", mid)
            out.append(conv_leaf(f"{name}.conv2.weight", mid, mid, 3))
            out += bn_leaves(f"{name}.bn2", mid)
            if s != 1 or cin != mid:
                out.append(conv_leaf(f"{name}.shortcut.0.weight", mid, cin,
                                     1))
                out += bn_leaves(f"{name}.shortcut.1", mid)
            cin = mid
    freq = hp["num_mel_bins"]
    for _ in range(3):
        freq = (freq + 1) // 2
    stats = cin * freq * 2
    bound = stats ** -0.5
    out += [Leaf("resnet.seg_1.weight", (hp["embed_dim"], stats),
                 ("uniform", bound)),
            Leaf("resnet.seg_1.bias", (hp["embed_dim"],), ("uniform", bound))]
    return out
