"""Plain ToTaToNet with its WavLM-large branch, and the separation
pipeline's tail.

PixIT's ToTaToNet (Kalda et al., 2024, "PixIT: joint training of speaker
diarization and speech separation from real-world multi-speaker
recordings") as pyannote/speech-separation-ami-1.0 serves it, written
from that description in plain PyTorch over a state dict under the
reference checkpoint's names (asteroid's ``encoder.filterbank._filters``,
``masker.*``, ``linear.{i}``, ``classifier``, HF's ``WavLMModel`` names
under ``wavlm.*``):

- a free conv encoder (64 filters, kernel 32, stride 16) over each chunk;
- WavLM-large (Chen et al., 2022, "WavLM"), as HF's ``WavLMModel`` with
  ``do_stable_layer_norm``: seven strided convs (512 channels; kernels
  10, 3, 3, 3, 3, 2, 2; strides 5, 2, ...), each with its bias, a layer
  norm over its channels and GELU; a layer norm and a projection to 1024;
  the grouped positional conv (kernel 128, 16 groups, weight-normalised
  over its output and input axes, its last frame dropped) added through
  GELU; 24 pre-LN layers (16 heads, WavLM's bucketed relative position
  bias from layer 0's table gated per layer from the layer's normalised
  input, a GELU feed-forward of 4096); the encoder's final layer norm.
  The last state is repeated x20 in time (320 / 16 samples a frame) and
  zero-padded or cut to the encoder's frames, then concatenated to them
  (1088 channels);
- asteroid's DPRNN masker: gLN and a 1x1 bottleneck to 128, chunks of
  100 frames at a hop of 50 (the sequence padded by a chunk on each
  side), 6 repeats of an intra-chunk and an inter-chunk BiLSTM of 128
  (``pyannet.lstm``'s explicit loop), each followed by a linear and a
  gLN added to its input, PReLU and a 1x1 conv to 3 x 128, the chunks
  summed back in place, tanh x sigmoid gates, a 1x1 conv to the 64
  filters and ReLU: one mask per source;
- each source's masked representation decoded by a transposed conv (cut
  or zero-padded to the chunk) and, for the diarization, averaged over
  8 frames (125 frames a second), two leaky-ReLU linears of 64 and a
  classifier shared by the sources, through a sigmoid.

The pipeline's tail, on the program's chunk sources, hard clusters and
annotation: each chunk's sources summed per cluster at the chunk's
offset and divided by the number of contributions (each local speaker of
the cluster that covers the sample, at least 1), as the JAX package and
the port define it; each cluster's source zeroed outside its speaker's
segments dilated by scipy's ``binary_dilation`` with ``2 x collar`` ones;
each source divided by its peak (+ 1e-8). The columns follow the
annotation's labels, SPEAKER_{i:02d} for the clusters with a segment in
increasing order.

Departures from the published description, each for a reason:

- the dilation is applied run by run: scipy's ``binary_dilation`` is run
  once on an impulse to read how far the structure reaches on each side
  (its centring of an even structure included), and each run of active
  samples is widened by that much and clipped to the recording. The
  dilation of a union is the union of the dilations and the structure
  does not vary along the signal, so the result is the same booleans;
  scipy on the whole signal takes O(samples x collar), minutes on a
  15-minute recording;
- the count-constrained reconstruction is computed in float64; where the
  activations that decide a frame lie within ``TIE`` of each other, the
  check accepts either decision (``decided``), since float32 sums in
  another order may settle such a tie either way.

Everything is float32 with TF32 off; ``Numerics("tf32-fp8")`` lets the
matmuls and convolutions take TF32 and rounds the recurrent product's
operands to fp8 (the configuration computes them in bf16). ``STATED``
rounds those operands to bf16 instead, the configuration's own
arithmetic ("lstm_precision": "default": h and W_hh rounded to bf16 to
nearest, the products summed in float32), everything else float32.

Imports neither the program, nor JAX, nor the JAX package.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from scipy.ndimage import binary_dilation

from . import reconstruct
from .numerics import Numerics
from .pyannet import lstm
from .sseriouss import (BUCKETS, CONV, POS_GROUPS, POS_KERNEL, attention,
                        buckets, layer_norm, linear)

SSL_STRIDE = 320
# chunks a call of the plain model takes (WavLM-large's first conv maps
# are 1 GB per 32 five-second chunks)
BATCH = 32
# activations closer than this decide a frame by a tie
TIE = 1e-5


class _StatedNumerics(Numerics):
    """float32 with TF32 off, the recurrent product's operands rounded to
    bf16 (round to nearest even), as the configuration states them."""

    def __init__(self):
        super().__init__("float32")

    def low(self, x: torch.Tensor) -> torch.Tensor:
        return x.to(torch.bfloat16).to(x.dtype)


STATED = _StatedNumerics()


# -- the weights --------------------------------------------------------------

def leaves(spec: dict):
    """The state dict's leaves and how the benchmark draws them: the
    program's inits (fan-in uniform, unit norms, PReLU 0.25, the bias
    table N(0, 0.02^2)). ``weight_g`` follows from ``weight_v``
    (``finish``)."""
    from ..weights import Leaf
    hp, ssl = spec["hparams"], spec["ssl"]
    ed, d, S = hp["encoder_decoder"], hp["dprnn"], hp["n_sources"]
    F_, k = ed["n_filters"], ed["kernel_size"]
    C, H = d["bn_chan"], d["hid_size"]

    def uniform(name, shape, fan_in):
        return Leaf(name, shape, ("uniform", fan_in ** -0.5))

    def dense(name, fan_out, fan_in):
        return [uniform(f"{name}.weight", (fan_out, fan_in), fan_in),
                uniform(f"{name}.bias", (fan_out,), fan_in)]

    def norm(name, width, a="weight", b="bias", shape=None):
        shape = shape or (width,)
        return [Leaf(f"{name}.{a}", shape, ("const", 1.0)),
                Leaf(f"{name}.{b}", shape, ("const", 0.0))]

    out = [uniform("encoder.filterbank._filters", (F_, 1, k), k),
           uniform("decoder.filterbank._filters", (F_, 1, k), k)]
    # WavLM-large, HF's names
    pre = "wavlm.feature_extractor.conv_layers"
    cin = 1
    for i, (cout, kernel, _) in enumerate(CONV):
        cout = ssl.get("conv_channels", cout)
        out += [uniform(f"{pre}.{i}.conv.weight", (cout, cin, kernel),
                        cin * kernel),
                uniform(f"{pre}.{i}.conv.bias", (cout,), cin * kernel)]
        out += norm(f"{pre}.{i}.layer_norm", cout)
        cin = cout
    width, heads, ffn = ssl["hidden"], ssl["heads"], ssl["ffn"]
    out += norm("wavlm.feature_projection.layer_norm", cin)
    out += dense("wavlm.feature_projection.projection", width, cin)
    conv = "wavlm.encoder.pos_conv_embed.conv"
    fan = width // POS_GROUPS * POS_KERNEL
    out += [uniform(f"{conv}.weight_v", (width, width // POS_GROUPS,
                                         POS_KERNEL), fan),
            Leaf(f"{conv}.weight_g", (1, 1, POS_KERNEL), ("const", 1.0)),
            uniform(f"{conv}.bias", (width,), fan)]
    out += norm("wavlm.encoder.layer_norm", width)
    for i in range(ssl["layers"]):
        name = f"wavlm.encoder.layers.{i}"
        att = f"{name}.attention"
        out.append(Leaf(f"{att}.gru_rel_pos_const", (1, heads, 1, 1),
                        ("const", 1.0)))
        for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
            out += dense(f"{att}.{proj}", width, width)
        out += dense(f"{att}.gru_rel_pos_linear", 8, width // heads)
        if i == 0:
            out.append(Leaf(f"{att}.rel_attn_embed.weight", (BUCKETS, heads),
                            ("normal", 0.02)))
        out += norm(f"{name}.layer_norm", width)
        out += dense(f"{name}.feed_forward.intermediate_dense", ffn, width)
        out += dense(f"{name}.feed_forward.output_dense", width, ffn)
        out += norm(f"{name}.final_layer_norm", width)
    # the DPRNN masker, asteroid's names
    cin = F_ + width
    out += norm("masker.bottleneck.0", cin, "gamma", "beta", (1, cin, 1))
    out += [uniform("masker.bottleneck.1.weight", (C, cin, 1), cin),
            uniform("masker.bottleneck.1.bias", (C,), cin)]
    for r in range(d["n_repeats"]):
        for side in ("intra", "inter"):
            name = f"masker.net.{r}.{side}"
            for suffix in ("", "_reverse"):
                for kind, shape in (("weight_ih", (4 * H, C)),
                                    ("weight_hh", (4 * H, H)),
                                    ("bias_ih", (4 * H,)),
                                    ("bias_hh", (4 * H,))):
                    out.append(uniform(f"{name}_RNN.rnn.{kind}_l0{suffix}",
                                       shape, H))
            out += dense(f"{name}_linear", C, 2 * H)
            out += norm(f"{name}_norm", C, "gamma", "beta", (1, C, 1))
    out += [Leaf("masker.first_out.0.weight", (1,), ("const", 0.25)),
            uniform("masker.first_out.1.weight", (S * C, C, 1, 1), C),
            uniform("masker.first_out.1.bias", (S * C,), C)]
    for name in ("net_out.0", "net_gate.0"):
        out += [uniform(f"masker.{name}.weight", (C, C, 1), C),
                uniform(f"masker.{name}.bias", (C,), C)]
    out.append(uniform("masker.mask_net.weight", (F_, C, 1), C))
    # the diarization head
    width = F_
    for i in range(hp["linear"]["num_layers"]):
        out += dense(f"linear.{i}", hp["linear"]["hidden_size"], width)
        width = hp["linear"]["hidden_size"]
    out += dense("classifier", 1, width)
    return out


def finish(p: Dict[str, torch.Tensor]) -> None:
    """``weight_g`` as the program's init sets it: the norm of
    ``weight_v`` over its output and input axes."""
    conv = "wavlm.encoder.pos_conv_embed.conv"
    p[f"{conv}.weight_g"] = torch.linalg.vector_norm(
        p[f"{conv}.weight_v"], dim=(0, 1), keepdim=True)


# -- the model ----------------------------------------------------------------

def wavlm(x: torch.Tensor, p: Dict[str, torch.Tensor], ssl: dict
          ) -> torch.Tensor:
    """(B, samples) -> (B, frames, hidden): WavLM-large's last state,
    after the encoder's final layer norm."""
    pre = "wavlm.feature_extractor.conv_layers"
    h = x[:, None]
    for i, (_, _, stride) in enumerate(CONV):
        h = F.conv1d(h, p[f"{pre}.{i}.conv.weight"], p[f"{pre}.{i}.conv.bias"],
                     stride=stride)
        h = F.gelu(layer_norm(h.transpose(1, 2), p, f"{pre}.{i}.layer_norm")
                   ).transpose(1, 2)
    h = linear(layer_norm(h.transpose(1, 2), p,
                          "wavlm.feature_projection.layer_norm"),
               p, "wavlm.feature_projection.projection")
    conv = "wavlm.encoder.pos_conv_embed.conv"
    v = p[f"{conv}.weight_v"]
    weight = p[f"{conv}.weight_g"] / (
        torch.linalg.vector_norm(v, dim=(0, 1), keepdim=True) + 1e-8) * v
    pos = F.conv1d(h.transpose(1, 2), weight, p[f"{conv}.bias"],
                   padding=POS_KERNEL // 2, groups=POS_GROUPS)[..., :-1]
    h = h + F.gelu(pos).transpose(1, 2)
    table = p["wavlm.encoder.layers.0.attention.rel_attn_embed.weight"]
    bias = table[buckets(h.shape[1], h.device)].permute(2, 0, 1)
    for i in range(ssl["layers"]):
        name = f"wavlm.encoder.layers.{i}"
        h = h + attention(layer_norm(h, p, f"{name}.layer_norm"), p,
                          f"{name}.attention", ssl["heads"], bias)
        ff = layer_norm(h, p, f"{name}.final_layer_norm")
        h = h + linear(F.gelu(linear(ff, p, f"{name}.feed_forward."
                                     "intermediate_dense")),
                       p, f"{name}.feed_forward.output_dense")
    return layer_norm(h, p, "wavlm.encoder.layer_norm")


def gln(x: torch.Tensor, p: Dict[str, torch.Tensor], name: str
        ) -> torch.Tensor:
    """Global layer norm over every axis but the batch, channels last."""
    dims = tuple(range(1, x.dim()))
    mean = x.mean(dim=dims, keepdim=True)
    var = (x - mean).square().mean(dim=dims, keepdim=True)
    return (x - mean) / torch.sqrt(var + 1e-8) * p[f"{name}.gamma"].reshape(
        -1) + p[f"{name}.beta"].reshape(-1)


def pointwise(x: torch.Tensor, p: Dict[str, torch.Tensor], name: str,
              bias: bool = True) -> torch.Tensor:
    w = p[f"{name}.weight"]
    y = x @ w.reshape(w.shape[0], -1).t()
    return y + p[f"{name}.bias"] if bias else y


def dprnn(x: torch.Tensor, p: Dict[str, torch.Tensor], hp: dict,
          num: Numerics) -> torch.Tensor:
    """(B, T, channels) -> masks (B, sources, T, filters)."""
    d, S = hp["dprnn"], hp["n_sources"]
    B, T, _ = x.shape
    C, K = d["bn_chan"], d["chunk_size"]
    hop = K // 2
    h = pointwise(gln(x, p, "masker.bottleneck.0"), p, "masker.bottleneck.1")
    h = F.pad(h, (0, 0, K, K))
    Tp = h.shape[1]
    n = (Tp - K) // hop + 1
    chunks = torch.stack([h[:, s * hop:s * hop + K] for s in range(n)], 1)
    for r in range(d["n_repeats"]):
        pre = f"masker.net.{r}"
        y = lstm(chunks.reshape(B * n, K, C), p, f"{pre}.intra_RNN.rnn", 1,
                 num)
        y = pointwise(y, p, f"{pre}.intra_linear").reshape(B, n, K, C)
        chunks = chunks + gln(y, p, f"{pre}.intra_norm")
        y = lstm(chunks.transpose(1, 2).reshape(B * K, n, C), p,
                 f"{pre}.inter_RNN.rnn", 1, num)
        y = pointwise(y, p, f"{pre}.inter_linear").reshape(B, K, n, C)
        chunks = chunks + gln(y.transpose(1, 2), p, f"{pre}.inter_norm")
    a = p["masker.first_out.0.weight"]
    chunks = torch.where(chunks >= 0, chunks, a * chunks)
    chunks = pointwise(chunks, p, "masker.first_out.1").reshape(B, n, K, S, C)
    out = chunks.new_zeros((B, Tp, S, C))
    for s in range(n):
        out[:, s * hop:s * hop + K] += chunks[:, s]
    out = out[:, K:K + T]
    gated = torch.tanh(pointwise(out, p, "masker.net_out.0")) * \
        torch.sigmoid(pointwise(out, p, "masker.net_gate.0"))
    return torch.relu(pointwise(gated, p, "masker.mask_net", bias=False)
                      ).transpose(1, 2)


def scaling(hp: dict) -> int:
    """Encoder frames pooled into one diarization frame."""
    return int(hp["sample_rate"] / hp["diar"]["frames_per_second"]
               / hp["encoder_decoder"]["stride"])


def head(pooled: torch.Tensor, p: Dict[str, torch.Tensor], hp: dict
         ) -> torch.Tensor:
    """(..., filters) pooled masked representation -> (...) logits."""
    h = pooled
    for i in range(hp["linear"]["num_layers"]):
        h = F.leaky_relu(linear(h, p, f"linear.{i}"), 0.01)
    return linear(h, p, "classifier")[..., 0]


def totatonet(chunks: torch.Tensor, p: Dict[str, torch.Tensor], hp: dict,
              ssl: dict, num: Numerics, features: bool = False,
              state: torch.Tensor = None):
    """(B, 1, samples) -> (diarization (B, frames, sources), sources (B,
    samples, sources)); with ``features``, the head's input (B, sources,
    frames, filters) in place of the diarization. ``state``, where given,
    is WavLM's last state of these chunks, computed once for several
    modes."""
    B, _, T = chunks.shape
    stride = hp["encoder_decoder"]["stride"]
    S = hp["n_sources"]
    with num.flags():
        rep = F.conv1d(chunks, p["encoder.filterbank._filters"],
                       stride=stride).transpose(1, 2)
        if state is None:
            state = wavlm(chunks[:, 0], p, ssl)
        w = torch.repeat_interleave(state, SSL_STRIDE // stride, dim=1)
        frames = rep.shape[1]
        w = F.pad(w, (0, 0, 0, frames - w.shape[1])) \
            if w.shape[1] < frames else w[:, :frames]
        masked = dprnn(torch.cat([rep, w], dim=-1), p, hp, num) * rep[:, None]
        dec_in = masked.reshape(B * S, *masked.shape[2:])
        decoded = F.conv_transpose1d(
            dec_in.transpose(1, 2), p["decoder.filterbank._filters"],
            stride=stride)[:, 0].reshape(B, S, -1)
        decoded = F.pad(decoded, (0, max(0, T - decoded.shape[-1])))[..., :T]
        s = scaling(hp)
        pooled = dec_in[:, :frames // s * s].reshape(
            B, S, frames // s, s, -1).mean(dim=3)
        if features:
            return pooled, decoded.transpose(1, 2)
        return (torch.sigmoid(head(pooled, p, hp)).transpose(1, 2),
                decoded.transpose(1, 2))


# -- the segmentation kind "totatonet" (``segmentation_models``: what
# ``portbench/calibration.py`` asks of a model) ---------------------------------

def forward(spec: dict, p: Dict[str, torch.Tensor], chunks: torch.Tensor,
            num: Numerics, features: bool = False):
    """(B, 1, samples) -> (diarization, sources) as ``totatonet``, in
    calls of ``BATCH`` chunks."""
    parts = [totatonet(chunks[b:b + BATCH].contiguous(), p, spec["hparams"],
                       spec["ssl"], num, features)
             for b in range(0, len(chunks), BATCH)]
    return tuple(torch.cat(part) for part in zip(*parts))


def num_frames(spec: dict, num_samples: int) -> int:
    ed = spec["hparams"]["encoder_decoder"]
    return ((num_samples - ed["kernel_size"]) // ed["stride"] + 1) \
        // scaling(spec["hparams"])


def frames(spec: dict) -> Tuple[float, float]:
    """(duration, step) in seconds of a diarization frame: the encoder
    conv and the pooling as one conv."""
    hp = spec["hparams"]
    ed, s, rate = hp["encoder_decoder"], scaling(hp), hp["sample_rate"]
    return s * ed["kernel_size"] / rate, s * ed["stride"] / rate


def ssl_output(spec: dict, p: Dict[str, torch.Tensor], chunks: torch.Tensor,
               num: Numerics) -> torch.Tensor:
    """(B, samples) chunks -> WavLM's last state."""
    with num.flags():
        return torch.cat([wavlm(chunks[b:b + BATCH].contiguous(), p,
                                spec["ssl"])
                          for b in range(0, len(chunks), BATCH)])


# -- the pipeline's tail --------------------------------------------------------

def output_grid(num_chunks: int, chunk_step: float, chunk_duration: float,
                frame_duration: float, frame_step: float
                ) -> Tuple[np.ndarray, int]:
    """(the output frame each chunk starts at, output frames): the frame
    whose centre is closest to each chunk's first frame centre, on a grid
    that starts with the recording."""
    half = 0.5 * frame_duration
    offsets = np.array([int(np.rint((c * chunk_step + half - half)
                                    / frame_step))
                        for c in range(num_chunks)], dtype=np.int64)
    end = chunk_duration + (num_chunks - 1) * chunk_step
    return offsets, int(np.rint((end + half - half) / frame_step)) + 1


def activations(scores: np.ndarray, hard: np.ndarray, offsets: np.ndarray,
                frames: int, clusters: int) -> np.ndarray:
    """(frames, clusters) float64: per chunk and cluster the largest
    score of its local speakers, summed over the chunks covering each
    frame (0 where none does)."""
    C, Fr, _ = scores.shape
    total = np.zeros((frames, clusters))
    for c in range(C):
        for k in range(clusters):
            member = hard[c] == k
            if member.any():
                n = min(Fr, frames - offsets[c])
                total[offsets[c]:offsets[c] + n, k] += \
                    scores[c, :n, member].max(axis=0)
    return total


def decided(activation: np.ndarray, count: np.ndarray) -> np.ndarray:
    """(frames,) bool: whether the ``count`` highest activations of the
    frame lie more than TIE above the next one."""
    ranked = -np.sort(-activation, axis=1)
    K = ranked.shape[1]
    out = np.ones(len(count), dtype=bool)
    inside = (count > 0) & (count < K)
    rows = np.nonzero(inside)[0]
    out[rows] = ranked[rows, count[rows] - 1] - ranked[rows, count[rows]] \
        > TIE
    return out


def present(binary: np.ndarray) -> List[int]:
    """Clusters with an active frame, in increasing order."""
    return [k for k in range(binary.shape[1]) if binary[:, k].any()]


def dilation_reach(collar: int) -> Tuple[int, int]:
    """How far ``binary_dilation`` with ``2 * collar`` ones widens an
    active sample (before, after), read from scipy on one impulse."""
    impulse = np.zeros(4 * collar + 1, dtype=bool)
    impulse[2 * collar] = True
    on = np.flatnonzero(binary_dilation(impulse,
                                        structure=np.ones(2 * collar)))
    return 2 * collar - int(on[0]), int(on[-1]) - 2 * collar


def leakage_mask(segments: List[Tuple[float, float]], num_samples: int,
                 sample_rate: int, collar: int) -> np.ndarray:
    """(samples,) bool: a speaker's segments at sample resolution, each
    run of active samples widened as scipy's ``binary_dilation`` with
    ``2 * collar`` ones widens it (``dilation_reach``)."""
    active = np.zeros(num_samples, dtype=bool)
    for start, end in segments:
        active[max(0, int(start * sample_rate)):
               min(num_samples, int(end * sample_rate))] = True
    if collar <= 0:
        return active
    before, after = dilation_reach(collar)
    padded = np.concatenate(([False], active, [False]))
    edges = np.flatnonzero(padded[1:] != padded[:-1])
    out = np.zeros(num_samples, dtype=bool)
    for a, b in zip(edges[0::2], edges[1::2]):
        out[max(0, a - before):min(num_samples, b + after)] = True
    return out


def overlap_add(sources, hard: np.ndarray, starts: np.ndarray,
                num_samples: int, clusters: int) -> np.ndarray:
    """(samples, clusters) float64: each chunk's local sources summed per
    cluster at the chunk's offset, over the number of contributions (at
    least 1). ``sources`` is (chunks, window, local) on any device."""
    C, W, _ = sources.shape
    total = np.zeros((int(starts[-1]) + W, clusters))
    count = np.zeros((len(total), clusters))
    for c in range(C):
        chunk = sources[c].double().cpu().numpy() if isinstance(
            sources, torch.Tensor) else np.asarray(sources[c], np.float64)
        for k in range(clusters):
            member = hard[c] == k
            if member.any():
                total[starts[c]:starts[c] + W, k] += chunk[:, member].sum(1)
                count[starts[c]:starts[c] + W, k] += member.sum()
    return (total / np.maximum(count, 1.0))[:num_samples]


def tail(sources, hard: np.ndarray, starts: np.ndarray, num_samples: int,
         labelled: Dict[str, List[Tuple[float, float]]],
         clusters: List[int], sample_rate: int, collar_s: float
         ) -> np.ndarray:
    """(samples, speakers) float64: the overlap-add per cluster, the
    leakage removal of each labelled speaker's cluster (``clusters[i]``
    for the i-th label in sorted order) and the peak normalisation, in
    the labels' order."""
    hard = np.asarray(hard, dtype=np.int64)
    width = max([int(hard.max()) + 1] + [k + 1 for k in clusters])
    summed = overlap_add(sources, hard, starts, num_samples, width)
    collar = int(round(collar_s * sample_rate))
    out = np.zeros((num_samples, len(clusters)))
    for i, (label, k) in enumerate(zip(sorted(labelled), clusters)):
        mask = leakage_mask(labelled[label], num_samples, sample_rate,
                            collar)
        out[:, i] = np.where(mask, summed[:, k], 0.0)
    return out / (np.abs(out).max(axis=0, keepdims=True) + 1e-8)


def diarization(scores: np.ndarray, hard: np.ndarray, count: np.ndarray,
                offsets: np.ndarray, frames: int):
    """(normal (frames, K), exclusive (frames, K), the frames both decide
    beyond a tie) of the count-constrained reconstruction from continuous
    chunk scores."""
    K = max(int(hard.max()) + 1, int(count.max()) if len(count) else 0, 1)
    act = activations(scores, hard, offsets, frames, K)
    order = np.argsort(-act, axis=1, kind="stable")
    ranks = np.empty_like(order)
    np.put_along_axis(ranks, order, np.broadcast_to(
        np.arange(K), order.shape).copy(), axis=1)
    return (ranks < count[:, None], ranks < np.minimum(count, 1)[:, None],
            decided(act, count) & decided(act, np.minimum(count, 1)))


def frame_sets(segments: List[Tuple[float, float, str]], t0: float,
               step: float) -> Dict[str, set]:
    """Per label, the frames [first, end) its segments cover on the output
    grid; a segment off the grid by more than 1e-6 s counts under the
    label "off-grid"."""
    out: Dict[str, set] = {}
    for start, end, label in segments:
        a, b = round((start - t0) / step), round((end - t0) / step)
        if abs(t0 + a * step - start) > 1e-6 or \
                abs(t0 + b * step - end) > 1e-6:
            out.setdefault("off-grid", set()).add((start, end, label))
            continue
        out.setdefault(label, set()).update(range(a, b))
    return out


def labelled_runs(binary: np.ndarray, named: np.ndarray,
                  frame_duration: float, frame_step: float
                  ) -> List[Tuple[float, float, str]]:
    """(start, end, label) of each run of ``binary``, the labels
    SPEAKER_{i:02d} given to the clusters active in ``named`` in
    increasing order."""
    label = {k: f"SPEAKER_{i:02d}" for i, k in enumerate(present(named))}
    runs = reconstruct.runs(binary, frame_duration, frame_step)
    return sorted((a, b, label[k]) for k, r in enumerate(runs) for a, b in r)


def frames_apart(ours: List[Tuple[float, float, str]],
                 theirs: List[Tuple[float, float, str]], undecided: set,
                 t0: float, step: float) -> int:
    """Frames that one side has under a label and the other does not,
    outside ``undecided``, plus the segments off the grid."""
    a, b = frame_sets(ours, t0, step), frame_sets(theirs, t0, step)
    off = len(a.pop("off-grid", ())) + len(b.pop("off-grid", ()))
    return off + sum(len((a.get(k, set()) ^ b.get(k, set())) - undecided)
                     for k in set(a) | set(b))


def unit_gap(ours: torch.Tensor, theirs: torch.Tensor) -> torch.Tensor:
    """Relative L2 gaps along the last axis."""
    return (ours - theirs).norm(dim=-1) / theirs.norm(dim=-1).clamp(
        min=1e-12)


def relative_l2(ours, theirs) -> float:
    ours = np.asarray(ours, dtype=np.float64)
    theirs = np.asarray(theirs, dtype=np.float64)
    return float(np.linalg.norm(ours - theirs)
                 / max(np.linalg.norm(theirs), 1e-12))
