"""LSTM recurrence in plain PyTorch: the reference for the CUDA kernel.

Counterpart of pyannote_audio_tpu/ops/lstm.py. The input projection
``x @ W_ih^T + b_ih + b_hh`` of every timestep is hoisted out of the
recurrence into one matmul; the loop carries only the (B, H) state and
does one (B, H) x (H, 4H) product per step. Gate order i, f, g, o and the
double bias follow torch.nn.LSTM, so reference checkpoints load weight
for weight. State, gates and output are float32. The recurrent product
takes the JAX package's three precisions (``recurrent_product``). The
recurrence and the input projection run under ``utils.runtime.
exact_float32`` (TF32 off, the JAX package's ``Precision.HIGHEST``), so
their float32 products do not depend on torch's global flags.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from ..utils.runtime import exact_float32


def split_bf16(a: torch.Tensor):
    """a -> (a_hi, a_lo), both bf16 values held in float32: a_hi = bf16(a)
    and a_lo = bf16(a - a_hi), each rounded to nearest even."""
    hi = a.to(torch.bfloat16).float()
    return hi, (a - hi).to(torch.bfloat16).float()


def split_tf32(a: torch.Tensor):
    """float32 a -> (a_hi, a_lo), both TF32 values held in float32: a_hi =
    tf32(a) and a_lo = tf32(a - a_hi), each rounded to nearest with ties
    away from zero, as ``cvt.rna.tf32.f32`` rounds. a = a_hi + a_lo to
    within 2^-22 |a|, so hi.hi + hi.lo + lo.hi carries a float32 product
    to within about 2^-21 of it: the backward kernel's products
    (``csrc/lstm_recurrence_backward.cu``)."""

    def tf32(x: torch.Tensor) -> torch.Tensor:
        bits = x.contiguous().view(torch.int32)
        return ((bits + 0x1000) & -0x2000).view(torch.float32)

    hi = tf32(a.float())
    return hi, tf32(a.float() - hi)


def recurrent_product(h: torch.Tensor, w_hh_t: torch.Tensor,
                      precision: str = "highest") -> torch.Tensor:
    """h (B, H) @ w_hh_t (H, 4H) in one of the JAX package's precisions.

    "highest": float32. "default": h and W_hh rounded to bf16, products
    summed in float32 (a bf16 x bf16 product is exact in float32).
    "high" (bf16_3x): hi.hi + hi.lo + lo.hi of the bf16 splits.
    """
    if precision == "highest":
        return h @ w_hh_t
    if precision == "default":
        return h.to(torch.bfloat16).float() @ w_hh_t.to(torch.bfloat16).float()
    if precision == "high":
        h_hi, h_lo = split_bf16(h)
        w_hi, w_lo = split_bf16(w_hh_t)
        return h_hi @ w_hi + h_hi @ w_lo + h_lo @ w_hi
    raise ValueError(f"unknown LSTM precision {precision!r}")


def lstm_recurrence(xw: torch.Tensor, w_hh: torch.Tensor,
                    reverse: bool = False,
                    precision: str = "highest") -> torch.Tensor:
    """(T, B, 4H) hoisted inputs + (4H, H) weights -> (T, B, H) hidden states.

    Counterpart of ``lstm_cell_scan`` (``precision="highest"``) and of
    ``pallas_lstm_cell`` at PYANNOTE_TPU_LSTM_PRECISION=``precision``:
    zero initial state; ``reverse`` walks time backwards and writes
    ``out[t]`` at the original index. xw is added after the product.
    """
    T, B, H4 = xw.shape
    H = H4 // 4
    w_hh_t = w_hh.t()
    h = xw.new_zeros((B, H))
    c = xw.new_zeros((B, H))
    out = xw.new_empty((T, B, H))
    with exact_float32():
        for t in (range(T - 1, -1, -1) if reverse else range(T)):
            gates = xw[t] + recurrent_product(h, w_hh_t, precision)
            i, f, g, o = gates.chunk(4, dim=-1)
            c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
            h = torch.sigmoid(o) * torch.tanh(c)
            out[t] = h
    return out


def lstm_bidirectional_recurrence_plain(xw: torch.Tensor,
                                        w_hh: torch.Tensor,
                                        precision: str = "highest"
                                        ) -> torch.Tensor:
    """(T, B, D*4H) + (D, 4H, H) -> (T, B, D*H), direction 1 reversed.

    The plain version of ``ops.lstm_kernel.lstm_bidirectional_recurrence``:
    direction d reads gate columns ``d*4H:(d+1)*4H`` and writes hidden
    columns ``d*H:(d+1)*H``.
    """
    D, H4, _ = w_hh.shape
    return torch.cat([
        lstm_recurrence(xw[..., d * H4:(d + 1) * H4], w_hh[d],
                        reverse=d == 1, precision=precision)
        for d in range(D)], dim=-1)


def lstm_bidirectional_recurrence_backward_plain(xw: torch.Tensor,
                                                 w_hh: torch.Tensor,
                                                 grad_out: torch.Tensor):
    """(grad_xw, grad_w_hh): the vector-Jacobian product of
    ``lstm_bidirectional_recurrence_plain(xw, w_hh, "highest")`` for the
    output's gradient ``grad_out`` (T, B, D*H).

    The plain version of ``ops.lstm_kernel.lstm_recurrence_backward``:
    explicit backpropagation through time, without autograd. Each
    direction's recurrence is recomputed at "highest" keeping every
    step's gate activations and cell state, then walked from its last
    step to its first; grad_w_hh[d] = sum over steps of dgates^T h_prev.
    The counterpart of ``jax.vjp`` of the JAX package's ``lstm_cell_scan``
    per direction. In xw's dtype, with TF32 off.
    """
    D, H4, H = w_hh.shape
    T, B, _ = xw.shape
    grad_xw = torch.empty_like(xw)
    grad_w_hh = torch.empty_like(w_hh)
    with exact_float32():
        for d in range(D):
            order = range(T - 1, -1, -1) if d == 1 else range(T)
            w = w_hh[d]
            w_t = w.t()
            h = xw.new_zeros((B, H))
            c = xw.new_zeros((B, H))
            h_prev = xw.new_empty((T, B, H))
            saved = []                    # per step: i, f, g, o, c_prev, c
            for t in order:
                gates = xw[t, :, d * H4:(d + 1) * H4] + h @ w_t
                i, f, g, o = gates.chunk(4, dim=-1)
                i, f, o = torch.sigmoid(i), torch.sigmoid(f), torch.sigmoid(o)
                g = torch.tanh(g)
                h_prev[t] = h
                c_prev, c = c, f * c + i * g
                h = o * torch.tanh(c)
                saved.append((i, f, g, o, c_prev, c))
            dgates = xw.new_empty((T, B, H4))
            dh_rec = xw.new_zeros((B, H))
            dc_next = xw.new_zeros((B, H))
            for t, (i, f, g, o, c_prev, c) in zip(reversed(order),
                                                  reversed(saved)):
                dh = grad_out[t, :, d * H:(d + 1) * H] + dh_rec
                tc = torch.tanh(c)
                dc = dc_next + dh * o * (1 - tc * tc)
                dg = torch.cat([dc * g * i * (1 - i),
                                dc * c_prev * f * (1 - f),
                                dc * i * (1 - g * g),
                                dh * tc * o * (1 - o)], dim=-1)
                dgates[t] = dg
                dc_next = dc * f
                dh_rec = dg @ w
            grad_xw[..., d * H4:(d + 1) * H4] = dgates
            grad_w_hh[d] = dgates.reshape(T * B, H4).t() \
                @ h_prev.reshape(T * B, H)
    return grad_xw, grad_w_hh


def lstm_single_direction(x: torch.Tensor, w_ih: torch.Tensor,
                          w_hh: torch.Tensor, b_ih: torch.Tensor,
                          b_hh: torch.Tensor,
                          reverse: bool = False) -> torch.Tensor:
    """x (B, T, D) -> (B, T, H). Weights in torch layout."""
    with exact_float32():
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
