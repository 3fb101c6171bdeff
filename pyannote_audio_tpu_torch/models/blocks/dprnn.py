"""Dual-path RNN masker for source separation.

Counterpart of pyannote_audio_tpu/models/blocks/dprnn.py (asteroid's
``masknn.recurrent.DPRNN`` as the reference's ToTaToNet uses it): a gLN +
1x1 bottleneck, the frame axis cut into chunks of ``chunk_size`` with hop
``chunk_size // 2`` after ``chunk_size`` zeros on both sides, blocks of an
intra-chunk BiLSTM (sequence = the chunk, batch = batch x chunks) then an
inter-chunk one (sequence = the chunks, batch = batch x chunk frames),
each followed by a linear and gLN with a residual, then PReLU, a 1x1 conv
to ``n_src * bn_chan``, an overlap-add fold that does not normalise, a
tanh x sigmoid gate, the bias-free ``mask_net`` and the mask activation.

Submodules carry asteroid's names (``bottleneck.{0,1}``,
``net.{r}.{intra,inter}_{RNN.rnn,linear,norm}``, ``first_out.{0,1}``,
``net_out.0``, ``net_gate.0``, ``mask_net``) and its 1x1-conv and gLN
shapes, so reference weights load as they are; the 1x1 convs run as
matmuls on channel-last tensors. The BiLSTMs are the port's LSTM: on the
card, one launch of the CUDA kernel each.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ...utils.runtime import exact_float32
from .rnn import LSTM
from .ssl import uniform_, init_linear


class GlobalLayerNorm(nn.Module):
    """gLN: normalise over every axis but the batch, per sample; ``gamma``
    and ``beta`` in asteroid's (1, C, 1) shape, applied on the last axis."""

    def __init__(self, channels: int, eps: float = 1e-8):
        super().__init__()
        self.eps = eps
        self.gamma = nn.Parameter(torch.ones(1, channels, 1))
        self.beta = nn.Parameter(torch.zeros(1, channels, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # x: (B, ..., C)
        dims = tuple(range(1, x.dim()))
        var, mean = torch.var_mean(x, dim=dims, keepdim=True, correction=0)
        return (x - mean) / torch.sqrt(var + self.eps) \
            * self.gamma.reshape(-1) + self.beta.reshape(-1)


def _conv1x1(in_channels: int, out_channels: int, bias: bool,
             generator: Optional[torch.Generator]) -> nn.Conv1d:
    conv = nn.Conv1d(in_channels, out_channels, 1, bias=bias)
    uniform_(conv.weight, in_channels ** -0.5, generator)
    if bias:
        uniform_(conv.bias, in_channels ** -0.5, generator)
    return conv


def _pointwise(x: torch.Tensor, conv: nn.Module) -> torch.Tensor:
    """A 1x1 conv (Conv1d or Conv2d) as a matmul on channel-last x."""
    return F.linear(x, conv.weight.reshape(conv.weight.shape[0], -1),
                    conv.bias)


class SingleRNN(nn.Module):
    """asteroid's wrapper, for its ``*_RNN.rnn.*`` names."""

    def __init__(self, input_size: int, hidden_size: int,
                 generator: Optional[torch.Generator]):
        super().__init__()
        self.rnn = LSTM(input_size, hidden_size=hidden_size, num_layers=1,
                        bidirectional=True, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.rnn(x)


class DPRNNBlock(nn.Module):
    """x + gLN(linear(intra BiLSTM(x))), then the same across chunks."""

    def __init__(self, bn_chan: int, hid_size: int,
                 generator: Optional[torch.Generator]):
        super().__init__()
        self.intra_RNN = SingleRNN(bn_chan, hid_size, generator)
        self.intra_linear = init_linear(nn.Linear(2 * hid_size, bn_chan),
                                        generator)
        self.intra_norm = GlobalLayerNorm(bn_chan)
        self.inter_RNN = SingleRNN(bn_chan, hid_size, generator)
        self.inter_linear = init_linear(nn.Linear(2 * hid_size, bn_chan),
                                        generator)
        self.inter_norm = GlobalLayerNorm(bn_chan)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # x: (B, S, K, C), S chunks of K frames
        B, S, K, C = x.shape
        h = self.intra_linear(self.intra_RNN(x.reshape(B * S, K, C)))
        x = x + self.intra_norm(h.reshape(B, S, K, C))
        h = x.transpose(1, 2).reshape(B * K, S, C)
        h = self.inter_linear(self.inter_RNN(h))
        return x + self.inter_norm(h.reshape(B, K, S, C).transpose(1, 2))


class DPRNN(nn.Module):
    """(B, T, in_chan) -> masks (B, n_src, T, out_chan)."""

    def __init__(self, in_chan: int = 64, out_chan: int = 64, n_src: int = 3,
                 bn_chan: int = 128, hid_size: int = 128,
                 chunk_size: int = 100, n_repeats: int = 6,
                 mask_act: str = "relu",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.n_src, self.bn_chan = n_src, bn_chan
        self.chunk_size = chunk_size
        self.mask_act = mask_act
        self.bottleneck = nn.Sequential(
            GlobalLayerNorm(in_chan),
            _conv1x1(in_chan, bn_chan, True, generator))
        self.net = nn.ModuleList([DPRNNBlock(bn_chan, hid_size, generator)
                                  for _ in range(n_repeats)])
        conv = nn.Conv2d(bn_chan, n_src * bn_chan, 1)
        uniform_(conv.weight, bn_chan ** -0.5, generator)
        uniform_(conv.bias, bn_chan ** -0.5, generator)
        # torch's PReLU starts at 0.25
        self.first_out = nn.Sequential(nn.PReLU(), conv)
        self.net_out = nn.Sequential(
            _conv1x1(bn_chan, bn_chan, True, generator), nn.Tanh())
        self.net_gate = nn.Sequential(
            _conv1x1(bn_chan, bn_chan, True, generator), nn.Sigmoid())
        self.mask_net = _conv1x1(bn_chan, out_chan, False, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with exact_float32():
            return self._forward(x)

    def _forward(self, x: torch.Tensor) -> torch.Tensor:
        B, T, _ = x.shape
        h = _pointwise(self.bottleneck[0](x), self.bottleneck[1])
        K = self.chunk_size
        hop = K // 2
        h = F.pad(h, (0, 0, K, K))                       # (B, T + 2K, C)
        Tp = h.shape[1]
        S = (Tp - K) // hop + 1
        chunks = h.unfold(1, K, hop)[:, :S].transpose(2, 3)  # (B, S, K, C)
        for block in self.net:
            chunks = block(chunks)
        chunks = _pointwise(self.first_out[0](chunks), self.first_out[1])
        chunks = chunks.reshape(B, S, K, self.n_src, self.bn_chan)
        # overlap-add, no normalisation, in ceil(K / hop) rounds of chunks
        # that do not overlap among themselves (so no index repeats within
        # an index_add_, and the sums' order is fixed)
        out = chunks.new_zeros((B, Tp, self.n_src, self.bn_chan))
        idx = (torch.arange(S, device=x.device)[:, None] * hop
               + torch.arange(K, device=x.device)[None, :])
        rounds = -(-K // hop)
        for r in range(rounds):
            out.index_add_(1, idx[r::rounds].reshape(-1),
                           chunks[:, r::rounds].reshape(
                               B, -1, self.n_src, self.bn_chan))
        out = out[:, K:K + T]                          # (B, T, n_src, bn)
        gated = torch.tanh(_pointwise(out, self.net_out[0])) \
            * torch.sigmoid(_pointwise(out, self.net_gate[0]))
        masks = _pointwise(gated, self.mask_net).transpose(1, 2)
        if self.mask_act == "relu":
            return F.relu(masks)
        if self.mask_act == "sigmoid":
            return torch.sigmoid(masks)
        return masks
