"""ECAPA-TDNN speaker embedding, loaded from a SpeechBrain snapshot.

Counterpart of pyannote_audio_tpu/models/embedding/ecapa.py, at
speechbrain/spkrec-ecapa-voxceleb's widths by default:

  fbank(80) -> sentence mean subtraction
  -> TDNNBlock(C0, k=5, d=1)                             blocks.0
  -> 3 x SERes2NetBlock(Ci, k=3, d=2/3/4, scale=8)       blocks.1-3
  -> cat(blocks 1..3 outputs) -> TDNNBlock(3*C, k=1)     mfa
  -> attentive stats pooling (global context)            asp
  -> BatchNorm -> 1x1 conv (lin_neurons)                 asp_bn, fc

Modules nest as SpeechBrain's wrappers do (a TDNNBlock's conv is
``conv.conv``, its batch norm ``norm.norm``), so the module's state dict
is an ``embedding_model.ckpt``'s: ``convert_speechbrain_state_dict``
loads one as it is and ``export_speechbrain_state_dict`` writes one.
Convolutions pad "same" in reflect mode. Masks are binary (batch,
frames): the input mean and the SE means divide by the raw mask total
(an all-silent row gives NaN, the wrappers' sentinel), and the attention
softmax is masked with -inf. BatchNorm uses running statistics (eval
mode). Everything runs in float32 under ``utils.runtime.exact_float32``
(the JAX package's XLA default is float32 on its CPU reference; no TF32).

``from_speechbrain(dir or hub id)`` reads a snapshot
(``hyperparams.yaml`` by a lenient scan, no PyYAML;
``embedding_model.ckpt`` by ``torch.load``), a hub id's through
``utils/hf_hub.py``.
"""

from __future__ import annotations

import re
from pathlib import Path
from typing import Dict, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...ops.fbank import speechbrain_fbank, speechbrain_fbank_num_frames
from ...utils.runtime import exact_float32
from ...utils.signal import nearest_binary_mask


class _Conv1d(nn.Module):
    """SpeechBrain ``Conv1d``: reflect "same" padding, inner ``conv``."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int, dilation: int = 1,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.conv = nn.Conv1d(in_channels, out_channels, kernel_size,
                              dilation=dilation)
        self.pad = dilation * (kernel_size - 1) // 2
        bound = (in_channels * kernel_size) ** -0.5
        with torch.no_grad():
            for p in (self.conv.weight, self.conv.bias):
                p.copy_(torch.rand(p.shape, generator=generator) * 2 * bound
                        - bound)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.pad:
            x = F.pad(x, (self.pad, self.pad), mode="reflect")
        return self.conv(x)


class _BatchNorm1d(nn.Module):
    """SpeechBrain ``BatchNorm1d``: inner ``norm``."""

    def __init__(self, size: int):
        super().__init__()
        self.norm = nn.BatchNorm1d(size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.norm(x)


class _TDNNBlock(nn.Module):
    """conv -> ReLU -> BatchNorm."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int, dilation: int = 1, generator=None):
        super().__init__()
        self.conv = _Conv1d(in_channels, out_channels, kernel_size,
                            dilation, generator)
        self.norm = _BatchNorm1d(out_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.norm(F.relu(self.conv(x)))


class _Res2NetBlock(nn.Module):
    """Channels in ``scale`` groups: group 0 passes through, group i > 0
    runs a TDNN over (x_i + y_{i-1})."""

    def __init__(self, channels: int, scale: int, kernel_size: int,
                 dilation: int, generator=None):
        super().__init__()
        self.scale = scale
        self.blocks = nn.ModuleList([
            _TDNNBlock(channels // scale, channels // scale, kernel_size,
                       dilation, generator) for _ in range(scale - 1)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xs = torch.chunk(x, self.scale, dim=1)
        ys = [xs[0]]
        for i, block in enumerate(self.blocks, start=1):
            ys.append(block(xs[i] if i == 1 else xs[i] + ys[-1]))
        return torch.cat(ys, dim=1)


def _masked_mean(x: torch.Tensor, mask: Optional[torch.Tensor]
                 ) -> torch.Tensor:
    """(B, C, T) -> (B, C, 1) mean over the mask's frames, divided by the
    raw mask total (NaN for an all-silent row)."""
    if mask is None:
        return x.mean(dim=2, keepdim=True)
    m = mask[:, None, :]
    return (x * m).sum(dim=2, keepdim=True) / m.sum(dim=2, keepdim=True)


class _SEBlock(nn.Module):
    """Squeeze-excitation over the (masked) temporal mean."""

    def __init__(self, channels: int, se_channels: int, generator=None):
        super().__init__()
        self.conv1 = _Conv1d(channels, se_channels, 1, generator=generator)
        self.conv2 = _Conv1d(se_channels, channels, 1, generator=generator)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor]
                ) -> torch.Tensor:
        s = F.relu(self.conv1(_masked_mean(x, mask)))
        return torch.sigmoid(self.conv2(s)) * x


class _SERes2NetBlock(nn.Module):
    def __init__(self, in_channels: int, channels: int, scale: int,
                 se_channels: int, kernel_size: int, dilation: int,
                 generator=None):
        super().__init__()
        self.tdnn1 = _TDNNBlock(in_channels, channels, 1, 1, generator)
        self.res2net_block = _Res2NetBlock(channels, scale, kernel_size,
                                           dilation, generator)
        self.tdnn2 = _TDNNBlock(channels, channels, 1, 1, generator)
        self.se_block = _SEBlock(channels, se_channels, generator)
        self.shortcut = _Conv1d(in_channels, channels, 1,
                                generator=generator) \
            if in_channels != channels else None

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor]
                ) -> torch.Tensor:
        residual = x if self.shortcut is None else self.shortcut(x)
        y = self.tdnn2(self.res2net_block(self.tdnn1(x)))
        return self.se_block(y, mask) + residual


def _weighted_stats(x: torch.Tensor, w: torch.Tensor, eps: float
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, C, T) values, (B, C|1, T) weights -> mean, std (B, C)."""
    mean = (w * x).sum(dim=2)
    var = (w * (x - mean[..., None]).square()).sum(dim=2)
    return mean, torch.sqrt(torch.clamp(var, min=eps))


class _AttentiveStatsPool(nn.Module):
    """Attention logits from conv(tanh(tdnn([x; mean; std]))), softmax over
    the mask's frames, then attention-weighted mean and std."""

    eps = 1e-12

    def __init__(self, channels: int, attention_channels: int,
                 global_context: bool, generator=None):
        super().__init__()
        self.global_context = global_context
        self.tdnn = _TDNNBlock(channels * (3 if global_context else 1),
                               attention_channels, 1, 1, generator)
        self.conv = _Conv1d(attention_channels, channels, 1,
                            generator=generator)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor]
                ) -> torch.Tensor:
        B, C, T = x.shape
        m = x.new_ones(B, 1, T) if mask is None else mask[:, None, :]
        attn = x
        if self.global_context:
            mean, std = _weighted_stats(x, m / m.sum(dim=2, keepdim=True),
                                        self.eps)
            attn = torch.cat([x, mean[..., None].expand(B, C, T),
                              std[..., None].expand(B, C, T)], dim=1)
        attn = self.conv(torch.tanh(self.tdnn(attn)))
        attn = torch.softmax(attn.masked_fill(m == 0, float("-inf")), dim=2)
        mean, std = _weighted_stats(x, attn, self.eps)
        return torch.cat([mean, std], dim=1)                # (B, 2C)


class ECAPA_TDNN(nn.Module):
    """ECAPA-TDNN on SpeechBrain's fbank: (B, 1, samples) -> (B, 192)."""

    def __init__(self, sample_rate: int = 16000, num_channels: int = 1,
                 n_mels: int = 80,
                 channels: Sequence[int] = (1024, 1024, 1024, 1024, 3072),
                 kernel_sizes: Sequence[int] = (5, 3, 3, 3, 1),
                 dilations: Sequence[int] = (1, 2, 3, 4, 1),
                 attention_channels: int = 128, res2net_scale: int = 8,
                 se_channels: int = 128, global_context: bool = True,
                 lin_neurons: int = 192, n_fft: int = 400,
                 win_length: Optional[int] = None,
                 hop_length: Optional[int] = None,
                 f_min: float = 0.0, f_max: float = 8000.0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.sample_rate = sample_rate
        self.n_mels = n_mels
        # SpeechBrain's Fbank: 25 ms / 10 ms windows at the model's rate;
        # n_fft and f_max do not follow the rate
        self.n_fft = int(n_fft)
        self.win_length = int(win_length if win_length is not None
                              else round(sample_rate * 0.025))
        self.hop_length = int(hop_length if hop_length is not None
                              else round(sample_rate * 0.010))
        self.f_min = float(f_min)
        self.f_max = float(f_max)
        self.channels = tuple(int(c) for c in channels)
        self.kernel_sizes = tuple(int(k) for k in kernel_sizes)
        self.dilations = tuple(int(d) for d in dilations)
        self.dimension = lin_neurons
        blocks = [_TDNNBlock(n_mels, self.channels[0], self.kernel_sizes[0],
                             self.dilations[0], generator)]
        for i in range(1, len(self.channels) - 1):
            blocks.append(_SERes2NetBlock(
                self.channels[i - 1], self.channels[i], res2net_scale,
                se_channels, self.kernel_sizes[i], self.dilations[i],
                generator))
        self.blocks = nn.ModuleList(blocks)
        self.mfa = _TDNNBlock(sum(self.channels[1:-1]), self.channels[-1],
                              self.kernel_sizes[-1], self.dilations[-1],
                              generator)
        self.asp = _AttentiveStatsPool(self.channels[-1], attention_channels,
                                       bool(global_context), generator)
        self.asp_bn = _BatchNorm1d(2 * self.channels[-1])
        self.fc = _Conv1d(2 * self.channels[-1], lin_neurons, 1,
                          generator=generator)

    def num_frames(self, num_samples: int) -> int:
        return speechbrain_fbank_num_frames(num_samples, self.hop_length)

    @property
    def min_num_samples(self) -> int:
        """Shortest input every reflect pad accepts: a pad of p frames
        needs T >= p + 1 = 1 + samples // hop frames."""
        pad = max(d * (k - 1) // 2
                  for k, d in zip(self.kernel_sizes, self.dilations))
        return pad * self.hop_length

    def fbank(self, waveforms: torch.Tensor) -> torch.Tensor:
        return speechbrain_fbank(waveforms, n_mels=self.n_mels,
                                 sample_rate=self.sample_rate,
                                 n_fft=self.n_fft,
                                 win_length=self.win_length,
                                 hop_length=self.hop_length,
                                 f_min=self.f_min, f_max=self.f_max)

    def forward_features(self, feats: torch.Tensor,
                         mask: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
        """(B, T, n_mels) fbank [+ (B, T) binary frame mask] -> (B, lin)."""
        with exact_float32():
            x = feats.transpose(1, 2)
            x = x - _masked_mean(x, mask)
            x = self.blocks[0](x)
            hidden = []
            for block in self.blocks[1:]:
                x = block(x, mask)
                hidden.append(x)
            x = self.mfa(torch.cat(hidden, dim=1))
            x = self.asp_bn(self.asp(x, mask)[..., None])
            return self.fc(x)[..., 0]

    def forward_with_frame_mask(self, signals: torch.Tensor,
                                frame_mask: Optional[torch.Tensor]
                                ) -> torch.Tensor:
        """(B, samples) signals + (B, frames) binary mask -> (B, dim): the
        SpeechBrain wrapper's entry (speech compacted, relative lengths
        as a mask)."""
        return self.forward_features(self.fbank(signals), frame_mask)

    def forward(self, waveforms: torch.Tensor,
                weights: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(B, [1,] samples) [+ (B, frames) weights at any rate,
        nearest-interpolated to fbank frames and binarized at 0.5]."""
        mask = None
        if weights is not None:
            mask = nearest_binary_mask(
                weights, self.num_frames(waveforms.shape[-1])).float()
        return self.forward_with_frame_mask(waveforms, mask)

    # -- SpeechBrain checkpoints ----------------------------------------------

    def convert_speechbrain_state_dict(self, state: Mapping[str, np.ndarray]
                                       ) -> "ECAPA_TDNN":
        """Load an ``embedding_model.ckpt`` state dict (its keys are this
        module's; missing ``num_batches_tracked`` counters are filled)."""
        tensors = {k: torch.tensor(np.asarray(v)) for k, v in state.items()}
        for key in self.state_dict():
            if key.endswith("num_batches_tracked"):
                tensors.setdefault(key, torch.tensor(0))
        self.load_state_dict(tensors, strict=True)
        return self

    def export_speechbrain_state_dict(self) -> Dict[str, np.ndarray]:
        """The module's weights as an ``embedding_model.ckpt`` state dict
        of numpy arrays."""
        return {k: v.detach().cpu().numpy().copy()
                for k, v in self.state_dict().items()}

    @classmethod
    def from_speechbrain(cls, source: Union[str, Path],
                         revision: Optional[str] = None,
                         token: Optional[str] = None,
                         cache_dir=None) -> "ECAPA_TDNN":
        """Load a SpeechBrain snapshot (``hyperparams.yaml`` for what
        shapes cannot tell, and ``embedding_model.ckpt``): a local
        directory or a hub id (``utils/hf_hub.py``; a snapshot without
        ``hyperparams.yaml`` is read from the weights alone); the module
        comes back on the CPU in eval mode."""
        from ...utils.hf_hub import hub_asset
        hub = dict(revision=revision, token=token, cache_dir=cache_dir)
        path = Path(source)
        ckpt = hub_asset(source, "embedding_model.ckpt", **hub) or \
            path / "embedding_model.ckpt"
        if not ckpt.is_file():
            raise ValueError(
                f"{source!r} is not a SpeechBrain snapshot directory "
                f"holding embedding_model.ckpt, locally or as a hub id")
        hyper_path = ckpt.parent / "hyperparams.yaml"
        if ckpt.parent != path:
            try:
                hyper_path = hub_asset(source, "hyperparams.yaml", **hub)
            except ValueError:
                hyper_path = None
        raw = torch.load(ckpt, map_location="cpu", weights_only=True)
        state = {k: v.numpy() for k, v in raw.items()}
        hyper = _parse_hyperparams(hyper_path.read_text()) \
            if hyper_path is not None and hyper_path.is_file() else {}
        model = cls(**_infer_ecapa_config(state, hyper))
        return model.convert_speechbrain_state_dict(state).eval()


def _parse_hyperparams(text: str) -> Dict[str, object]:
    """Lenient scan of SpeechBrain's HyperPyYAML for the ECAPA arguments
    (its ``!new:`` tags are not plain YAML): scalars, the three lists and
    ``global_context``."""
    out: Dict[str, object] = {}
    for key in ("sample_rate", "n_mels", "lin_neurons",
                "attention_channels", "res2net_scale", "se_channels"):
        match = re.search(rf"^\s*{key}:\s*(\d+)\s*$", text, re.M)
        if match:
            out[key] = int(match.group(1))
    for key in ("channels", "kernel_sizes", "dilations"):
        match = re.search(rf"^\s*{key}:\s*\[([\d,\s]+)\]", text, re.M)
        if match:
            out[key] = [int(v) for v in match.group(1).split(",")]
    match = re.search(r"^\s*global_context:\s*(\w+)", text, re.M)
    if match:
        out["global_context"] = match.group(1).lower() == "true"
    return out


def _infer_ecapa_config(state: Mapping[str, np.ndarray],
                        hyper: Mapping[str, object]) -> Dict[str, object]:
    """The architecture from the weights' shapes; ``hyper`` wins for what
    shapes cannot tell (dilations, sample rate)."""
    w0 = state["blocks.0.conv.conv.weight"]          # (C0, n_mels, k0)
    num_se = len({int(m.group(1)) for k in state
                  for m in [re.match(r"blocks\.(\d+)\.tdnn1\.", k)] if m})
    scale = 1 + len({int(m.group(1)) for k in state
                     for m in [re.match(
                         r"blocks\.1\.res2net_block\.blocks\.(\d+)\.", k)]
                     if m})
    channels = [int(w0.shape[0])]
    kernel_sizes = [int(w0.shape[2])]
    for i in range(1, num_se + 1):
        channels.append(
            int(state[f"blocks.{i}.tdnn1.conv.conv.weight"].shape[0]))
        kernel_sizes.append(int(state[
            f"blocks.{i}.res2net_block.blocks.0.conv.conv.weight"].shape[2]))
    w_mfa = state["mfa.conv.conv.weight"]
    channels.append(int(w_mfa.shape[0]))
    kernel_sizes.append(int(w_mfa.shape[2]))
    w_att = state["asp.tdnn.conv.conv.weight"]
    config = {
        "n_mels": int(w0.shape[1]),
        "channels": channels,
        "kernel_sizes": hyper.get("kernel_sizes", kernel_sizes),
        "dilations": hyper.get("dilations",
                               [1] + list(range(2, num_se + 2)) + [1]),
        "attention_channels": int(w_att.shape[0]),
        "res2net_scale": scale,
        "se_channels": int(
            state["blocks.1.se_block.conv1.conv.weight"].shape[0]),
        "global_context": bool(hyper.get(
            "global_context", w_att.shape[1] == 3 * channels[-1])),
        "lin_neurons": int(state["fc.conv.weight"].shape[0]),
    }
    if "n_mels" in hyper:
        config["n_mels"] = int(hyper["n_mels"])
    if "sample_rate" in hyper:
        config["sample_rate"] = int(hyper["sample_rate"])
    return config
