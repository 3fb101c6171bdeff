"""Plain SSeRiouSS: a WavLM-base trunk -> BiLSTM -> feed-forward ->
powerset log-softmax.

pyannote.audio's ``SSeRiouSS`` over torchaudio's WavLM (Chen et al.,
2022, "WavLM"), written from their description in plain PyTorch over a
state dict under HF's names (``wav2vec.feature_extractor.*``,
``wav2vec.encoder.layers.{i}.attention.*``, ...):

- seven strided convolutions (512 channels; kernels 10, 3, 3, 3, 3, 2, 2;
  strides 5, 2, ...), a per-channel group norm after the first, GELU;
- layer norm and a projection to 768, a grouped positional convolution
  (kernel 128, 16 groups, weight-normalised over its output and input
  axes, its last frame dropped) added through GELU, a layer norm;
- twelve post-LN transformer layers: multi-head attention (12 heads)
  with WavLM's bucketed relative position bias (320 buckets, distances
  up to 800, the table in layer 0) gated per layer from the layer's
  input, then a 3072-wide GELU feed-forward;
- the softmax-weighted average of the twelve layers' outputs, a 4-layer
  BiLSTM of 128 (the explicit loop of ``pyannet.lstm``), two leaky-ReLU
  linears of 128 and the classifier.

Everything is float32 with TF32 off, as the configuration states for the
trunk; ``Numerics("tf32-fp8")`` lets the matmuls and convolutions take
TF32, and the recurrent product's h and W_hh follow ``num.low``.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from .numerics import Numerics
from . import pyannet
from .pyannet import lstm

CONV = ((512, 10, 5), (512, 3, 2), (512, 3, 2), (512, 3, 2), (512, 3, 2),
        (512, 2, 2), (512, 2, 2))
POS_KERNEL, POS_GROUPS = 128, 16
BUCKETS, MAX_DISTANCE = 320, 800
EPS = 1e-5
TRUNK_BATCH, HEAD_BATCH = 32, 512


def receptive_field(sample_rate: int) -> Tuple[float, float]:
    size, jump = 1, 1
    for _, kernel, stride in CONV:
        size += (kernel - 1) * jump
        jump *= stride
    return size / sample_rate, jump / sample_rate


def buckets(T: int, device) -> torch.Tensor:
    """(T, T) relative position buckets of key - query positions."""
    pos = torch.arange(T, device=device)
    rel = pos[None, :] - pos[:, None]
    half = BUCKETS // 2
    out = (rel > 0).long() * half
    n = rel.abs()
    exact = half // 2
    large = exact + (torch.log(n.float().clamp(min=1) / exact)
                     / math.log(MAX_DISTANCE / exact)
                     * (half - exact)).long()
    return out + torch.where(n < exact, n, large.clamp(max=half - 1))


def layer_norm(x, p, name):
    return F.layer_norm(x, x.shape[-1:], p[f"{name}.weight"],
                        p[f"{name}.bias"], EPS)


def linear(x, p, name):
    return x @ p[f"{name}.weight"].t() + p[f"{name}.bias"]


def attention(h, p, name, heads, bias):
    B, T, D = h.shape
    hd = D // heads
    gate_in = h.reshape(B, T, heads, hd).transpose(1, 2)
    gates = torch.sigmoid(linear(gate_in, p, f"{name}.gru_rel_pos_linear")
                          .reshape(B, heads, T, 2, 4).sum(-1))
    gate = gates[..., :1] * (gates[..., 1:] * p[f"{name}.gru_rel_pos_const"]
                             - 1.0) + 2.0
    q, k, v = (linear(h, p, f"{name}.{n}_proj").reshape(B, T, heads, hd)
               .transpose(1, 2) for n in ("q", "k", "v"))
    logits = q @ k.transpose(-1, -2) / math.sqrt(hd) + gate * bias[None]
    ctx = (torch.softmax(logits, dim=-1) @ v).transpose(1, 2).reshape(B, T,
                                                                      D)
    return linear(ctx, p, f"{name}.out_proj")


def trunk(x: torch.Tensor, p: Dict[str, torch.Tensor], hp: dict,
          last: bool = False) -> torch.Tensor:
    """(B, samples) -> (B, frames, hidden): the weighted average of the
    transformer layers' outputs (the last layer's output with ``last``)."""
    pre = "wav2vec.feature_extractor.conv_layers"
    h = x[:, None]
    for i, (_, kernel, stride) in enumerate(CONV):
        h = F.conv1d(h, p[f"{pre}.{i}.conv.weight"], stride=stride)
        if i == 0:
            h = F.group_norm(h, h.shape[1], p[f"{pre}.0.layer_norm.weight"],
                             p[f"{pre}.0.layer_norm.bias"], EPS)
        h = F.gelu(h)
    h = linear(layer_norm(h.transpose(1, 2), p,
                          "wav2vec.feature_projection.layer_norm"),
               p, "wav2vec.feature_projection.projection")
    conv = "wav2vec.encoder.pos_conv_embed.conv"
    v = p[f"{conv}.weight_v"]
    weight = p[f"{conv}.weight_g"] / (
        torch.linalg.vector_norm(v, dim=(0, 1), keepdim=True) + 1e-8) * v
    pos = F.conv1d(h.transpose(1, 2), weight, p[f"{conv}.bias"],
                   padding=POS_KERNEL // 2, groups=POS_GROUPS)[..., :-1]
    h = layer_norm(h + F.gelu(pos).transpose(1, 2), p,
                   "wav2vec.encoder.layer_norm")
    table = p["wav2vec.encoder.layers.0.attention.rel_attn_embed.weight"]
    bias = table[buckets(h.shape[1], h.device)].permute(2, 0, 1)
    weights = torch.softmax(p["wav2vec_weights"], dim=0)
    average = torch.zeros_like(h)
    for i in range(hp["ssl"]["layers"]):
        name = f"wav2vec.encoder.layers.{i}"
        h = layer_norm(h + attention(h, p, f"{name}.attention",
                                     hp["ssl"]["heads"], bias),
                       p, f"{name}.layer_norm")
        ff = linear(F.gelu(linear(h, p, f"{name}.feed_forward."
                                  "intermediate_dense")),
                    p, f"{name}.feed_forward.output_dense")
        h = layer_norm(h + ff, p, f"{name}.final_layer_norm")
        average = average + weights[i] * h
    return h if last else average


def head(x: torch.Tensor, p: Dict[str, torch.Tensor], hp: dict,
         num: Numerics, logits: bool = False, features: bool = False
         ) -> torch.Tensor:
    x = lstm(x, p, "lstm", hp["lstm"]["num_layers"], num)
    return x if features else pyannet.head(x, p, hp, logits)


def sseriouss(chunks: torch.Tensor, p: Dict[str, torch.Tensor], hp: dict,
              num: Numerics, logits: bool = False, features: bool = False
              ) -> torch.Tensor:
    """(B, 1, samples) -> (B, frames, classes) log-probs (logits with
    ``logits``, the BiLSTM's output with ``features``), the trunk in
    batches of TRUNK_BATCH chunks."""
    with num.flags():
        feats = torch.cat([trunk(chunks[b:b + TRUNK_BATCH, 0], p, hp)
                           for b in range(0, len(chunks), TRUNK_BATCH)])
        return torch.cat([head(feats[b:b + HEAD_BATCH], p, hp, num, logits,
                               features)
                          for b in range(0, len(feats), HEAD_BATCH)])


def leaves(hp: dict, weight_scale: float):
    """The state dict's leaves and how the benchmark draws them: the
    program's inits (fan-in uniform, unit norms, the bias table
    N(0, 0.02^2)), the BiLSTM's and linear weights ``weight_scale`` times
    theirs. ``weight_g`` follows from ``weight_v`` (``finish``)."""
    from ..weights import Leaf
    ssl = hp["ssl"]
    d, heads, ffn = ssl["hidden"], ssl["heads"], ssl["ffn"]
    out: List[Leaf] = [Leaf("wav2vec_weights", (ssl["layers"],),
                            ("const", 1.0))]
    pre = "wav2vec.feature_extractor.conv_layers"
    cin = 1
    for i, (cout, kernel, _) in enumerate(CONV):
        out.append(Leaf(f"{pre}.{i}.conv.weight", (cout, cin, kernel),
                        ("uniform", (cin * kernel) ** -0.5)))
        if i == 0:
            out += [Leaf(f"{pre}.0.layer_norm.weight", (cout,),
                         ("const", 1.0)),
                    Leaf(f"{pre}.0.layer_norm.bias", (cout,),
                         ("const", 0.0))]
        cin = cout

    def dense(name, fan_out, fan_in, scale=1.0):
        bound = fan_in ** -0.5
        return [Leaf(f"{name}.weight", (fan_out, fan_in),
                     ("uniform", bound * scale)),
                Leaf(f"{name}.bias", (fan_out,), ("uniform", bound))]

    def norm(name, width):
        return [Leaf(f"{name}.weight", (width,), ("const", 1.0)),
                Leaf(f"{name}.bias", (width,), ("const", 0.0))]

    out += norm("wav2vec.feature_projection.layer_norm", cin)
    out += dense("wav2vec.feature_projection.projection", d, cin)
    conv = "wav2vec.encoder.pos_conv_embed.conv"
    fan = d // POS_GROUPS * POS_KERNEL
    out += [Leaf(f"{conv}.weight_v", (d, d // POS_GROUPS, POS_KERNEL),
                 ("uniform", fan ** -0.5)),
            Leaf(f"{conv}.weight_g", (1, 1, POS_KERNEL), ("const", 1.0)),
            Leaf(f"{conv}.bias", (d,), ("uniform", fan ** -0.5))]
    out += norm("wav2vec.encoder.layer_norm", d)
    for i in range(ssl["layers"]):
        name = f"wav2vec.encoder.layers.{i}"
        att = f"{name}.attention"
        out.append(Leaf(f"{att}.gru_rel_pos_const", (1, heads, 1, 1),
                        ("const", 1.0)))
        for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
            out += dense(f"{att}.{proj}", d, d)
        out += dense(f"{att}.gru_rel_pos_linear", 8, d // heads)
        if i == 0:
            out.append(Leaf(f"{att}.rel_attn_embed.weight", (BUCKETS, heads),
                            ("normal", 0.02)))
        out += norm(f"{name}.layer_norm", d)
        out += dense(f"{name}.feed_forward.intermediate_dense", ffn, d)
        out += dense(f"{name}.feed_forward.output_dense", d, ffn)
        out += norm(f"{name}.final_layer_norm", d)
    H, layers = hp["lstm"]["hidden_size"], hp["lstm"]["num_layers"]
    bound = H ** -0.5
    width = d
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
        out += dense(f"linear.{i}", hp["linear"]["hidden_size"], width,
                     weight_scale)
        width = hp["linear"]["hidden_size"]
    return out, width


def finish(p: Dict[str, torch.Tensor]) -> None:
    """``weight_g`` as the program's init sets it: the norm of
    ``weight_v`` over its output and input axes."""
    conv = "wav2vec.encoder.pos_conv_embed.conv"
    p[f"{conv}.weight_g"] = torch.linalg.vector_norm(
        p[f"{conv}.weight_v"], dim=(0, 1), keepdim=True)


# -- the segmentation kind "sseriouss" (``segmentation_models``) --------------

def hparams(spec: dict) -> dict:
    """The hyper-parameters ``sseriouss`` takes: the SSL trunk's with the
    rest."""
    return dict(spec["hparams"], ssl=spec["ssl"])


def forward(spec: dict, p: Dict[str, torch.Tensor], chunks: torch.Tensor,
            num: Numerics, features: bool = False) -> torch.Tensor:
    """(B, 1, samples) -> (B, frames, powerset classes) log-probs (the
    BiLSTM's output with ``features``)."""
    return sseriouss(chunks, p, hparams(spec), num, features=features)


def num_frames(spec: dict, num_samples: int) -> int:
    for _, kernel, stride in CONV:
        num_samples = (num_samples - kernel) // stride + 1
    return num_samples


def frames(spec: dict) -> Tuple[float, float]:
    return receptive_field(spec["hparams"]["sample_rate"])


def ssl_output(spec: dict, p: Dict[str, torch.Tensor], chunks: torch.Tensor,
               num: Numerics) -> torch.Tensor:
    """(B, samples) chunks -> the SSL trunk's last layer."""
    with num.flags():
        return trunk(chunks.contiguous(), p, hparams(spec), last=True)


def chunk_flops(spec: dict, window: int, classes: int) -> Tuple[int, int]:
    """(FLOPs, LSTM steps) of one chunk: the trunk, the BiLSTM over its
    frames and the head."""
    from ..flops import lstm_flops, wavlm_chunk_flops
    hp = spec["hparams"]
    trunk_flops, steps = wavlm_chunk_flops(window, spec["ssl"])
    H, layers = hp["lstm"]["hidden_size"], hp["lstm"]["num_layers"]
    d = spec["ssl"]["hidden"]
    widths = [2 * H] + [hp["linear"]["hidden_size"]] * \
        hp["linear"]["num_layers"] + [classes]
    return trunk_flops + lstm_flops(steps, [d] + [2 * H] * (layers - 1), H) \
        + 2 * steps * sum(a * b for a, b in zip(widths, widths[1:])), steps


def shared_flops(spec: dict, padded: int) -> Dict[str, int]:
    """Nothing runs over the whole recording: every chunk has its own
    trunk pass."""
    return {}
