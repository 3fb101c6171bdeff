"""Self-supervised speech encoder (wav2vec2 / WavLM family).

Counterpart of pyannote_audio_tpu/models/blocks/ssl.py: a 7-layer strided
conv feature extractor (512 channels, strides 5, 2, 2, 2, 2, 2, 2), a
layer-norm + projection, a grouped conv positional embedding, and a
transformer stack, returning every layer's hidden states. Two trunk
kinds: BASE models are post-LN with one group norm after conv 0
(``pre_ln=False, conv_norm="group"``); LARGE models are pre-LN with a
layer norm after every conv and biased convs (``pre_ln=True,
conv_norm="layer"``). WavLM adds a bucketed relative position bias,
computed once from layer 0's table and gated per layer.

Submodules carry the HF ``Wav2Vec2Model`` / ``WavLMModel`` names, so an HF
state dict loads as it is and ``state_dict()`` is one. The torchaudio
``wav2vec2_model`` nesting folds onto it (``normalize_ssl_keys``) and back
(``torchaudio_layout``). The positional conv keeps HF's weight-norm pair
(``weight_g``, ``weight_v``) and fuses it as ``g / (||v|| + 1e-8) * v``
over the (out, in) axes at each forward, as the JAX package's converter
fuses it. Attention is composed torch ops (matmul, softmax, matmul), as
the JAX package composes it in XLA. Everything runs in float32 with TF32
off (``utils.runtime.exact_float32``): the JAX package leaves its default
precision here, which is float32. The linears and the feature extractor's
convs 1-6 run through ``ops.tf32x3_gemm`` (float32-accurate products: the
hand-written 3xTF32 kernel on a CUDA device, its plain version on the CPU,
torch's own ops where autograd needs a graph), the q, k and v projections
as one product; from conv 0's norm and GELU on, the feature extractor
keeps its activations channels-last, so a strided conv reads its input
rows in place.
"""

from __future__ import annotations

import math
from typing import Dict, List, Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...ops.tf32x3_gemm import linear, linears, strided_conv
from ...utils.receptive_field import (multi_conv_num_frames,
                                      multi_conv_receptive_field_center,
                                      multi_conv_receptive_field_size)
from ...utils.runtime import exact_float32

CONV_KERNELS = (10, 3, 3, 3, 3, 2, 2)
CONV_STRIDES = (5, 2, 2, 2, 2, 2, 2)
POS_CONV_KERNEL = 128
POS_CONV_GROUPS = 16
NUM_BUCKETS = 320
MAX_DISTANCE = 800
EPS = 1e-5


def uniform_(tensor: torch.Tensor, bound: float,
              generator: Optional[torch.Generator]) -> None:
    with torch.no_grad():
        tensor.copy_((torch.rand(tensor.shape, generator=generator) * 2 - 1)
                     * bound)


def init_linear(layer: nn.Linear, generator: Optional[torch.Generator]
                ) -> nn.Linear:
    """torch's default bound, U(-1/sqrt(in), 1/sqrt(in)), drawn from
    ``generator``."""
    bound = layer.in_features ** -0.5
    uniform_(layer.weight, bound, generator)
    if layer.bias is not None:
        uniform_(layer.bias, bound, generator)
    return layer


def init_conv(conv: nn.Conv1d, generator: Optional[torch.Generator]
              ) -> nn.Conv1d:
    fan_in = conv.weight.shape[1] * conv.weight.shape[2]
    uniform_(conv.weight, fan_in ** -0.5, generator)
    if conv.bias is not None:
        uniform_(conv.bias, fan_in ** -0.5, generator)
    return conv


class ConvLayer(nn.Module):
    """One feature-extractor conv, its norm (if any) and GELU: conv 0 takes
    (B, 1, T) and returns channels-last (B, T', C), the others take and
    return channels-last."""

    def __init__(self, in_channels: int, channels: int, kernel: int,
                 stride: int, norm: Optional[str],
                 generator: Optional[torch.Generator]):
        super().__init__()
        self.conv = init_conv(nn.Conv1d(in_channels, channels, kernel,
                                        stride=stride,
                                        bias=norm == "layer"), generator)
        self.norm = norm
        if norm == "layer":
            self.layer_norm = nn.LayerNorm(channels, eps=EPS)
        elif norm == "group":
            self.layer_norm = nn.GroupNorm(channels, channels, eps=EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.conv.in_channels == 1:
            x = self.conv(x)
            if self.norm == "group":
                x = self.layer_norm(x)
            x = x.transpose(1, 2)
            if self.norm == "layer":
                x = self.layer_norm(x)
            return F.gelu(x)
        if self.norm is None:
            return strided_conv(x, self.conv, gelu=True)
        return F.gelu(self.layer_norm(strided_conv(x, self.conv)))


class FeatureExtractor(nn.Module):
    """(B, T) waveform -> (B, T', C) features."""

    def __init__(self, channels: int = 512, norm_mode: str = "group",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        layers = []
        for i, (k, s) in enumerate(zip(CONV_KERNELS, CONV_STRIDES)):
            norm = "layer" if norm_mode == "layer" else \
                ("group" if i == 0 else None)
            layers.append(ConvLayer(1 if i == 0 else channels, channels, k,
                                    s, norm, generator))
        self.conv_layers = nn.ModuleList(layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x[:, None]
        for layer in self.conv_layers:
            h = layer(h)
        return h


class FeatureProjection(nn.Module):
    def __init__(self, channels: int, hidden: int,
                 generator: Optional[torch.Generator]):
        super().__init__()
        self.layer_norm = nn.LayerNorm(channels, eps=EPS)
        self.projection = init_linear(nn.Linear(channels, hidden), generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return linear(self.layer_norm(x), self.projection)


class WeightNormConv(nn.Module):
    """The grouped positional conv with HF's weight-norm pair: ``weight_v``
    (hidden, hidden / groups, kernel), ``weight_g`` (1, 1, kernel)."""

    def __init__(self, hidden: int, kernel: int, groups: int,
                 generator: Optional[torch.Generator]):
        super().__init__()
        self.groups = groups
        self.weight_v = nn.Parameter(torch.empty(hidden, hidden // groups,
                                                 kernel))
        self.weight_g = nn.Parameter(torch.empty(1, 1, kernel))
        self.bias = nn.Parameter(torch.empty(hidden))
        fan_in = hidden // groups * kernel
        uniform_(self.weight_v, fan_in ** -0.5, generator)
        uniform_(self.bias, fan_in ** -0.5, generator)
        with torch.no_grad():
            self.weight_g.copy_(torch.linalg.vector_norm(
                self.weight_v, dim=(0, 1), keepdim=True))

    def weight(self) -> torch.Tensor:
        """g / (||v|| + 1e-8) * v, the norm over the (out, in) axes."""
        norm = torch.linalg.vector_norm(self.weight_v, dim=(0, 1),
                                        keepdim=True)
        return self.weight_g / (norm + 1e-8) * self.weight_v

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        kernel = self.weight_v.shape[-1]
        return F.conv1d(x, self.weight(), self.bias, padding=kernel // 2,
                        groups=self.groups)


class ConvPositionalEmbedding(nn.Module):
    def __init__(self, hidden: int, generator: Optional[torch.Generator]):
        super().__init__()
        self.conv = WeightNormConv(hidden, POS_CONV_KERNEL, POS_CONV_GROUPS,
                                   generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # x: (B, T, D); an even kernel gives one frame too many: drop it
        h = self.conv(x.transpose(1, 2))
        if POS_CONV_KERNEL % 2 == 0:
            h = h[..., :-1]
        return x + F.gelu(h).transpose(1, 2)


def relative_position_buckets(seq_len: int, num_buckets: int = NUM_BUCKETS,
                              max_distance: int = MAX_DISTANCE,
                              device=None) -> torch.Tensor:
    """(T, T) int64 WavLM buckets of ``memory - context`` positions.

    The JAX package's ``RelPositionBias._bucket`` op for op: half the
    buckets per sign, exact below ``max_exact``, then a float32 log scale
    truncated to int32 and clamped to the last bucket.
    """
    pos = torch.arange(seq_len, device=device)
    rel = pos[None, :] - pos[:, None]
    half = num_buckets // 2
    ret = (rel > 0).to(torch.int32) * half
    n = rel.abs()
    max_exact = half // 2
    log_ratio = torch.log(torch.clamp(n.to(torch.float32), min=1.0)
                          / max_exact)
    scale = torch.tensor(math.log(max_distance / max_exact),
                         dtype=torch.float32, device=device)
    large = max_exact + (log_ratio / scale
                         * (half - max_exact)).to(torch.int32)
    large = torch.clamp(large, max=half - 1)
    return (ret + torch.where(n < max_exact, n.to(torch.int32), large)).long()


class Attention(nn.Module):
    """Multi-head self-attention, with WavLM's per-layer gate of the shared
    relative position bias when ``gated``; ``rel_attn_embed`` (the bias
    table) lives in layer 0 only."""

    def __init__(self, hidden: int, heads: int, gated: bool,
                 has_table: bool, generator: Optional[torch.Generator]):
        super().__init__()
        self.heads = heads
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            setattr(self, name, init_linear(nn.Linear(hidden, hidden),
                                            generator))
        self.gated = gated
        if gated:
            self.gru_rel_pos_linear = init_linear(
                nn.Linear(hidden // heads, 8), generator)
            self.gru_rel_pos_const = nn.Parameter(torch.ones(1, heads, 1, 1))
        if has_table:
            self.rel_attn_embed = nn.Embedding(NUM_BUCKETS, heads)
            with torch.no_grad():
                self.rel_attn_embed.weight.copy_(0.02 * torch.randn(
                    NUM_BUCKETS, heads, generator=generator))

    def forward(self, h: torch.Tensor,
                position_bias: Optional[torch.Tensor]) -> torch.Tensor:
        B, T, D = h.shape
        heads, Hd = self.heads, D // self.heads
        bias = None
        if position_bias is not None and self.gated:
            gate_in = h.reshape(B, T, heads, Hd).transpose(1, 2)
            proj = self.gru_rel_pos_linear(gate_in)
            gates = torch.sigmoid(proj.reshape(B, heads, T, 2, 4).sum(-1))
            gate = gates[..., 0:1] * (gates[..., 1:2]
                                      * self.gru_rel_pos_const - 1.0) + 2.0
            bias = gate * position_bias[None]              # (B, H, T, T)
        elif position_bias is not None:
            bias = position_bias[None]
        q, k, v = (x.reshape(B, T, heads, Hd).transpose(1, 2)
                   for x in linears(h, (self.q_proj, self.k_proj,
                                        self.v_proj)))
        logits = torch.matmul(q, k.transpose(-1, -2)) / np.sqrt(Hd)
        if bias is not None:
            logits = logits + bias
        attn = torch.softmax(logits, dim=-1)
        ctx = torch.matmul(attn, v).transpose(1, 2).reshape(B, T, D)
        return linear(ctx, self.out_proj)


class FeedForward(nn.Module):
    def __init__(self, hidden: int, ffn: int,
                 generator: Optional[torch.Generator]):
        super().__init__()
        self.intermediate_dense = init_linear(nn.Linear(hidden, ffn),
                                              generator)
        self.output_dense = init_linear(nn.Linear(ffn, hidden), generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return linear(linear(x, self.intermediate_dense, gelu=True),
                      self.output_dense)


class TransformerLayer(nn.Module):
    """One encoder layer, pre-LN (LARGE) or post-LN (BASE)."""

    def __init__(self, hidden: int, heads: int, ffn: int, pre_ln: bool,
                 gated: bool, has_table: bool,
                 generator: Optional[torch.Generator]):
        super().__init__()
        self.pre_ln = pre_ln
        self.attention = Attention(hidden, heads, gated, has_table,
                                   generator)
        self.layer_norm = nn.LayerNorm(hidden, eps=EPS)
        self.feed_forward = FeedForward(hidden, ffn, generator)
        self.final_layer_norm = nn.LayerNorm(hidden, eps=EPS)

    def forward(self, x: torch.Tensor,
                position_bias: Optional[torch.Tensor]) -> torch.Tensor:
        if self.pre_ln:
            x = x + self.attention(self.layer_norm(x), position_bias)
            return x + self.feed_forward(self.final_layer_norm(x))
        x = self.layer_norm(x + self.attention(x, position_bias))
        return self.final_layer_norm(x + self.feed_forward(x))


class Encoder(nn.Module):
    def __init__(self, hidden: int, layers: int, heads: int, ffn: int,
                 pre_ln: bool, rel_pos_bias: bool, final_norm: bool,
                 generator: Optional[torch.Generator]):
        super().__init__()
        self.pos_conv_embed = ConvPositionalEmbedding(hidden, generator)
        if final_norm:
            self.layer_norm = nn.LayerNorm(hidden, eps=EPS)
        self.layers = nn.ModuleList([
            TransformerLayer(hidden, heads, ffn, pre_ln, rel_pos_bias,
                             rel_pos_bias and i == 0, generator)
            for i in range(layers)])


class SSLEncoder(nn.Module):
    """(B, [1,] samples) -> the embedding state and every layer's output,
    each (B, frames, hidden).

    ``pre_ln`` is HF's ``do_stable_layer_norm``: post-LN (BASE) applies
    the encoder LayerNorm right after the positional conv, pre-LN (LARGE)
    after the last layer, to the last returned state, and only when
    ``normalize_last`` (torchaudio's ``extract_features`` returns raw
    layer outputs, which SSeRiouSS averages).
    """

    def __init__(self, hidden: int = 768, layers: int = 12, heads: int = 12,
                 ffn: int = 3072, conv_channels: int = 512,
                 rel_pos_bias: bool = False, pre_ln: bool = True,
                 conv_norm: str = "group", normalize_last: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.pre_ln = pre_ln
        self.rel_pos_bias = rel_pos_bias
        self.normalize_last = normalize_last
        self.feature_extractor = FeatureExtractor(conv_channels, conv_norm,
                                                  generator)
        self.feature_projection = FeatureProjection(conv_channels, hidden,
                                                    generator)
        # a pre-LN encoder that returns raw outputs has no final norm
        self.encoder = Encoder(hidden, layers, heads, ffn, pre_ln,
                               rel_pos_bias, not pre_ln or normalize_last,
                               generator)

    def position_bias(self, seq_len: int, device) -> torch.Tensor:
        """(heads, T, T) bias from layer 0's table."""
        table = self.encoder.layers[0].attention.rel_attn_embed.weight
        buckets = relative_position_buckets(seq_len, device=device)
        return table[buckets].permute(2, 0, 1)

    def forward(self, waveforms: torch.Tensor) -> List[torch.Tensor]:
        x = waveforms[:, 0] if waveforms.dim() == 3 else waveforms
        with exact_float32():
            feats = self.feature_extractor(x)
            h = self.feature_projection(feats)
            h = self.encoder.pos_conv_embed(h)
            if not self.pre_ln:
                h = self.encoder.layer_norm(h)
            states = [h]
            bias = self.position_bias(h.shape[1], h.device) \
                if self.rel_pos_bias else None
            for layer in self.encoder.layers:
                h = layer(h, bias)
                states.append(h)
            if self.pre_ln and self.normalize_last:
                states[-1] = self.encoder.layer_norm(states[-1])
        return states

    @staticmethod
    def num_frames(num_samples: int) -> int:
        return multi_conv_num_frames(
            num_samples, kernel_size=list(CONV_KERNELS),
            stride=list(CONV_STRIDES), padding=[0] * 7, dilation=[1] * 7)

    @staticmethod
    def receptive_field_size(num_frames: int = 1) -> int:
        return multi_conv_receptive_field_size(
            num_frames, kernel_size=list(CONV_KERNELS),
            stride=list(CONV_STRIDES), dilation=[1] * 7)

    @staticmethod
    def receptive_field_center(frame: int = 0) -> int:
        return multi_conv_receptive_field_center(
            frame, kernel_size=list(CONV_KERNELS),
            stride=list(CONV_STRIDES), padding=[0] * 7, dilation=[1] * 7)

    def load_ssl_state_dict(self, state: Mapping) -> "SSLEncoder":
        """Load an HF or torchaudio wav2vec2 / WavLM state dict (numpy
        arrays or tensors; a ``wav2vec2.`` / ``wavlm.`` prefix is
        dropped). A final norm that this encoder does not apply is
        skipped."""
        state = hf_layout(state)
        if not hasattr(self.encoder, "layer_norm"):
            state = {k: v for k, v in state.items()
                     if not k.startswith("encoder.layer_norm.")}
        self.load_state_dict(state, strict=True)
        return self


_PREFIXES = ("wav2vec2.", "wavlm.")
# newer torch names the weight-norm pair as a parametrization
_PARAMETRIZED = {
    "encoder.pos_conv_embed.conv.parametrizations.weight.original0":
        "encoder.pos_conv_embed.conv.weight_g",
    "encoder.pos_conv_embed.conv.parametrizations.weight.original1":
        "encoder.pos_conv_embed.conv.weight_v"}


def normalize_ssl_keys(state: Mapping) -> Dict:
    """Fold torchaudio ``wav2vec2_model`` naming onto the HF layout:
    ``encoder.transformer.*`` -> ``encoder.*`` and
    ``encoder.feature_projection.*`` -> ``feature_projection.*`` (the
    per-layer names already coincide)."""
    out = {}
    for key, value in state.items():
        if key.startswith("encoder.transformer."):
            key = "encoder." + key[len("encoder.transformer."):]
        elif key.startswith("encoder.feature_projection."):
            key = "feature_projection." \
                + key[len("encoder.feature_projection."):]
        out[key] = value
    return out


def hf_layout(state: Mapping) -> Dict[str, torch.Tensor]:
    """Any accepted wav2vec2 / WavLM layout -> float32 tensors under the
    HF names this module's ``state_dict`` carries."""
    out = {}
    for key, value in state.items():
        for prefix in _PREFIXES:
            if key.startswith(prefix):
                key = key[len(prefix):]
        key = _PARAMETRIZED.get(key, key)
        out[key] = value.float() if isinstance(value, torch.Tensor) \
            else torch.from_numpy(np.array(value, dtype=np.float32))
    return normalize_ssl_keys(out)


def torchaudio_layout(state: Mapping) -> Dict:
    """HF names -> the torchaudio ``wav2vec2_model`` nesting (the inverse
    of ``normalize_ssl_keys``), which the reference's SSeRiouSS stores
    under ``wav2vec.*``."""
    out = {}
    for key, value in state.items():
        if key.startswith("encoder."):
            key = "encoder.transformer." + key[len("encoder."):]
        elif key.startswith("feature_projection."):
            key = "encoder." + key
        out[key] = value
    return out


def load_torch_ssl_state(path) -> Dict[str, np.ndarray]:
    """A local torch wav2vec2 / WavLM checkpoint as numpy arrays: a
    .bin/.pt/.ckpt file, or a directory holding pytorch_model.bin,
    model.pt or checkpoint.pt; a ``state_dict`` / ``model`` nesting is
    unwrapped and the HF ``wav2vec2.`` prefix dropped. No hub access."""
    from pathlib import Path
    path = Path(path)
    if path.is_dir():
        for name in ("pytorch_model.bin", "model.pt", "checkpoint.pt"):
            if (path / name).exists():
                path = path / name
                break
        else:
            raise ValueError(f"no torch checkpoint found in {path}")
    state = torch.load(path, map_location="cpu", weights_only=False)
    for key in ("state_dict", "model"):
        if isinstance(state, dict) and isinstance(state.get(key), dict):
            state = state[key]
    out = {}
    for key, value in state.items():
        if not isinstance(value, torch.Tensor):
            continue
        if key.startswith("wav2vec2."):
            key = key[len("wav2vec2."):]
        out[key] = value.detach().cpu().numpy()
    return out


def infer_ssl_config(state: Mapping) -> Dict:
    """Encoder dimensions of a wav2vec2 / WavLM state dict (HF or
    torchaudio layout), as the JAX package's ``_infer_ssl_config`` reads
    them: the head count from WavLM's gate constant or bias table, else
    64 dimensions per head; a layer-norm conv trunk means a pre-LN
    encoder, as in every released model."""
    state = normalize_ssl_keys(state)
    hidden = state["feature_projection.projection.weight"].shape[0]
    layers = 1 + max(int(k.split(".")[2]) for k in state
                     if k.startswith("encoder.layers."))
    ffn = next(v for k, v in state.items()
               if "feed_forward.intermediate_dense.weight" in k).shape[0]
    rel_pos_bias = any("rel_attn_embed" in k or "gru_rel_pos" in k
                       for k in state)
    heads = None
    for key, value in state.items():
        if key.endswith("gru_rel_pos_const"):
            heads = int(value.shape[1])
            break
        if key.endswith("rel_attn_embed.weight"):
            heads = int(value.shape[-1])
            break
    if heads is None:
        heads = {768: 12, 1024: 16}.get(hidden, max(1, hidden // 64))
    conv_channels = state[
        "feature_extractor.conv_layers.0.conv.weight"].shape[0]
    layer_trunk = \
        "feature_extractor.conv_layers.1.layer_norm.weight" in state
    return dict(hidden=int(hidden), layers=layers, heads=heads,
                ffn=int(ffn), rel_pos_bias=rel_pos_bias,
                conv_channels=int(conv_channels), pre_ln=layer_trunk,
                conv_norm="layer" if layer_trunk else "group")
