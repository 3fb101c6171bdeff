"""LSTM recurrence in plain PyTorch: the reference for the CUDA kernel.

Counterpart of pyannote_audio_tpu/ops/lstm.py. The input projection
``x @ W_ih^T + b_ih + b_hh`` of every timestep is hoisted out of the
recurrence into one matmul; the loop carries only the (B, H) state and
does one (B, H) x (H, 4H) product per step. Gate order i, f, g, o and the
double bias follow torch.nn.LSTM, so reference checkpoints load weight
for weight. Runs in float32; on a CUDA device the matmuls need TF32 off
(``torch.backends.cuda.matmul.allow_tf32 = False``, torch's default) to
match the JAX reference, which pins them to HIGHEST.
"""

from __future__ import annotations

from typing import Dict, List

import torch


def lstm_recurrence(xw: torch.Tensor, w_hh: torch.Tensor,
                    reverse: bool = False) -> torch.Tensor:
    """(T, B, 4H) hoisted inputs + (4H, H) weights -> (T, B, H) hidden states.

    Counterpart of ``lstm_cell_scan``: zero initial state; ``reverse``
    walks time backwards and writes ``out[t]`` at the original index.
    """
    T, B, H4 = xw.shape
    H = H4 // 4
    w_hh_t = w_hh.t()
    h = xw.new_zeros((B, H))
    c = xw.new_zeros((B, H))
    out = xw.new_empty((T, B, H))
    for t in (range(T - 1, -1, -1) if reverse else range(T)):
        gates = xw[t] + h @ w_hh_t
        i, f, g, o = gates.chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        out[t] = h
    return out


def lstm_bidirectional_recurrence_plain(xw: torch.Tensor,
                                        w_hh: torch.Tensor) -> torch.Tensor:
    """(T, B, D*4H) + (D, 4H, H) -> (T, B, D*H), direction 1 reversed.

    The plain version of ``ops.lstm_kernel.lstm_bidirectional_recurrence``:
    direction d reads gate columns ``d*4H:(d+1)*4H`` and writes hidden
    columns ``d*H:(d+1)*H``.
    """
    D, H4, _ = w_hh.shape
    return torch.cat([
        lstm_recurrence(xw[..., d * H4:(d + 1) * H4], w_hh[d],
                        reverse=d == 1)
        for d in range(D)], dim=-1)


def lstm_single_direction(x: torch.Tensor, w_ih: torch.Tensor,
                          w_hh: torch.Tensor, b_ih: torch.Tensor,
                          b_hh: torch.Tensor,
                          reverse: bool = False) -> torch.Tensor:
    """x (B, T, D) -> (B, T, H). Weights in torch layout."""
    xw = torch.matmul(x, w_ih.t()) + b_ih + b_hh
    hs = lstm_recurrence(xw.transpose(0, 1), w_hh, reverse=reverse)
    return hs.transpose(0, 1)


def multilayer_lstm(x: torch.Tensor, layers: List[Dict[str, torch.Tensor]],
                    bidirectional: bool = True) -> torch.Tensor:
    """Stack of LSTM layers, (B, T, D) -> (B, T, H * num_directions).

    ``layers[i]`` maps w_ih, w_hh, b_ih, b_hh (and the ``_r`` reverse
    direction when bidirectional) to tensors in torch layout.
    """
    h = x
    for layer in layers:
        fwd = lstm_single_direction(h, layer["w_ih"], layer["w_hh"],
                                    layer["b_ih"], layer["b_hh"])
        if not bidirectional:
            h = fwd
            continue
        bwd = lstm_single_direction(h, layer["w_ih_r"], layer["w_hh_r"],
                                    layer["b_ih_r"], layer["b_hh_r"],
                                    reverse=True)
        h = torch.cat([fwd, bwd], dim=-1)
    return h
