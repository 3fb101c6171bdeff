"""The LSTM recurrence as a hand-written Hopper kernel.

Counterpart of pyannote_audio_tpu/ops/pallas_lstm.py: the CUDA kernel in
``csrc/lstm_recurrence.cu`` runs one bidirectional layer's recurrence in
one launch, in the JAX package's three precisions of the recurrent
product (see the source for its design). A CPU tensor takes the plain
PyTorch version (``ops.lstm``); a CUDA tensor launches the kernel or
raises — there is no fallback.

The kernel keeps W_hh on chip for all T steps, laid out by
``prepare_recurrent_weights`` (plain torch, testable on the CPU): gate
rows permuted and cut among the CTAs of a cluster, and for the bf16
modes ordered as ``mma.sync`` A fragments.

``LSTMRecurrence`` makes the recurrence trainable as the JAX package's
``custom_vjp`` wrappers do (``pallas_lstm.py:212-257``): its forward is
the kernel, its backward ``lstm_recurrence_backward``, the float32
vector-Jacobian product that the JAX package takes of its scan. On a
CUDA device that is a second hand-written kernel,
``csrc/lstm_recurrence_backward.cu``: the forward kernel recomputes the
layer at "highest" into a workspace of gate activations and cell
states, the backward kernel walks it in reverse for the gradient of xw,
and one float32 product gives W_hh's. On the CPU both are their plain
versions (``ops.lstm``).
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F

from ..utils.runtime import LSTM_PRECISIONS, exact_float32, lstm_precision
from .lstm import (lstm_bidirectional_recurrence_backward_plain,
                   lstm_bidirectional_recurrence_plain, split_bf16)

MAX_HIDDEN = 256          # the csrc kernel's kMaxHidden
SHARED_BYTES = 227 * 1024  # shared memory a Hopper block can use
ROWS = 8                  # batch rows per cluster: the mma's n
STAGES = 6                # xw ring depth in the csrc kernel (kStages)
MAX_UNITS = 64            # hidden units per CTA (kMaxUnits): 4 warps
MODES = {"default": 0, "high": 1, "highest": 2}


def _smallest_cluster(hidden: int, shared_bytes) -> dict:
    """The smallest cluster (1, 2, 4 or 8 CTAs; from 2 at H = 17 on, to
    spread the product over more SMs) whose CTAs each own ``padded //
    cluster`` hidden units (a multiple of 16, at most MAX_UNITS) in
    ``shared_bytes(units, padded)`` bytes of shared memory, at most
    SHARED_BYTES: {"cluster", "padded", "shared_bytes"}. Raises
    ``ValueError`` above MAX_HIDDEN."""
    if not 1 <= hidden <= MAX_HIDDEN:
        raise ValueError(f"hidden size {hidden} is outside what the LSTM "
                         f"kernel keeps on chip (1 to {MAX_HIDDEN})")
    for cluster in ((1, 2, 4, 8) if hidden <= 16 else (2, 4, 8)):
        padded = -(-hidden // (16 * cluster)) * 16 * cluster
        units = padded // cluster
        shared = shared_bytes(units, padded)
        if units <= MAX_UNITS and shared <= SHARED_BYTES:
            return {"cluster": cluster, "padded": padded,
                    "shared_bytes": shared}
    raise AssertionError("unreachable: H <= MAX_HIDDEN fits a cluster of 8")


def kernel_geometry(hidden: int, precision: str) -> dict:
    """Cluster size and padded hidden size the kernel runs ``hidden`` at.

    Each CTA keeps the 4 gate rows of W_hh of its units (a warp per 16)
    in shared memory beside the xw ring and the double-buffered h
    (``_smallest_cluster``). Raises ``ValueError`` above MAX_HIDDEN.
    """
    if precision not in MODES:
        raise ValueError(f"unknown LSTM precision {precision!r}: expected "
                         f"one of {LSTM_PRECISIONS}")

    def shared_bytes(units, padded):
        if precision == "highest":
            w_bytes = 4 * units * padded * 4
            h_bytes = 2 * padded * ROWS * 4
        else:
            parts = 2 if precision == "high" else 1
            w_bytes = parts * 4 * units * padded * 2
            h_bytes = parts * 2 * ROWS * (padded + 8) * 2
        ring_bytes = STAGES * ROWS * (4 * units + 4) * 4
        return w_bytes + h_bytes + ring_bytes + 16  # + 2 mbarriers

    return _smallest_cluster(hidden, shared_bytes)


def backward_geometry(hidden: int) -> dict:
    """Cluster size and padded hidden size the backward kernel runs
    ``hidden`` at.

    Each CTA keeps the 4 * padded W_hh columns of its units in float32
    beside two buffers of every unit's gate gradients for ROWS batch rows
    and 2 mbarriers (``_smallest_cluster``). Raises ``ValueError`` above
    MAX_HIDDEN.
    """
    return _smallest_cluster(
        hidden, lambda units, padded:
        4 * padded * units * 4 + 2 * 4 * padded * ROWS * 4 + 16)


@dataclass(frozen=True)
class RecurrentWeights:
    """W_hh (D, 4H, H) laid out for the kernel at one precision.

    ``packed`` is (D, cluster, ...) with each CTA's block contiguous:
    float32 rows for "highest"; bf16 mma A fragments for "default", and
    hi then lo fragments for "high".
    """
    packed: torch.Tensor
    precision: str
    hidden: int
    cluster: int
    padded: int


def prepare_recurrent_weights(w_hh: torch.Tensor,
                              precision: str) -> RecurrentWeights:
    """Permute, pad and split (D, 4H, H) W_hh for the kernel.

    Hidden units are padded to ``padded`` with zero rows and columns and
    cut into cluster x groups x 16; within a group's 16 units, unit
    ``half * 8 + g`` is fragment row ``g`` (half 0) or ``g + 8`` (half 1),
    for lane group ``g`` = lane / 4. Each of the 4 gates is its own m16
    tile, so a thread's accumulators hold i, f, g and o of the same
    (unit, batch row) and the gate math needs no exchange.
    """
    D, H4, H = w_hh.shape
    geometry = kernel_geometry(H, precision)
    C, Hp = geometry["cluster"], geometry["padded"]
    groups = Hp // C // 16
    w = F.pad(w_hh.float().reshape(D, 4, H, H), (0, Hp - H, 0, Hp - H))
    if precision == "highest":
        # (D, gate, C, group, half, g, k/4, 4)
        #   -> (D, C, group, gate, k/4, half, g, 4): float4 rows along k
        packed = w.reshape(D, 4, C, groups, 2, 8, Hp // 4, 4) \
            .permute(0, 2, 3, 1, 6, 4, 5, 7)
    else:
        parts = split_bf16(w) if precision == "high" else (w,)
        # (D, gate, C, group, rh, g, k-step, kh, t, e)
        #   -> (D, C, group, gate, k-step, g, t, kh, rh, e): each lane's
        # 16 bytes are its 4 A registers {row g / g+8, k 2t(+8) .. +1}
        packed = torch.stack([
            p.reshape(D, 4, C, groups, 2, 8, Hp // 16, 2, 4, 2)
            .permute(0, 2, 3, 1, 6, 5, 8, 7, 4, 9) for p in parts],
            dim=2).to(torch.bfloat16)
    return RecurrentWeights(packed.contiguous(), precision, H, C, Hp)


def pack_backward_weights(w_hh: torch.Tensor) -> tuple:
    """(D, 4H, H) W_hh -> (packed, cluster) for the backward kernel.

    Hidden units are padded to ``padded`` with zero rows and columns;
    ``packed`` is (D, cluster, 4 * padded, padded // cluster) float32:
    for each CTA the columns of W_hh of its units, gate row by gate row
    (row ``q * padded + u`` is gate q of unit u).
    """
    D, H4, H = w_hh.shape
    geometry = backward_geometry(H)
    C, Hp = geometry["cluster"], geometry["padded"]
    w = F.pad(w_hh.float().reshape(D, 4, H, H), (0, Hp - H, 0, Hp - H))
    packed = w.reshape(D, 4 * Hp, C, Hp // C).permute(0, 2, 1, 3)
    return packed.contiguous(), C


def _bind(name: str, pointers: int, ints: int) -> ctypes.CDLL:
    """``csrc/<name>.cu``'s library; its entry ``name`` takes
    ``pointers`` pointers, ``ints`` ints and the stream, and returns an
    int."""
    from ..utils.build import load
    lib = load(name)
    fn = getattr(lib, name)
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * pointers + [ctypes.c_int] * ints \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def _library() -> ctypes.CDLL:
    return _bind("lstm_recurrence", 4, 6)


def _backward_library() -> ctypes.CDLL:
    return _bind("lstm_recurrence_backward", 4, 5)


def lstm_bidirectional_recurrence(
        xw: torch.Tensor, w_hh: torch.Tensor,
        precision: Optional[str] = None,
        prepared: Optional[RecurrentWeights] = None) -> torch.Tensor:
    """(T, B, D*4H) hoisted inputs + (D, 4H, H) weights -> (T, B, D*H).

    D is 1 or 2 directions; direction 1 walks time backwards.
    ``precision`` is "default", "high" or "highest"; None resolves it for
    xw's device (``utils.runtime.lstm_precision``). On the CPU this is
    ``lstm_bidirectional_recurrence_plain``; on a CUDA device one kernel
    launch covers every direction, counted in ``.launches``. ``prepared``
    is ``prepare_recurrent_weights(w_hh, precision)``, for callers that
    cache it.
    """
    if precision is None:
        precision = lstm_precision(xw.device)
    if xw.device.type == "cpu" and w_hh.device.type == "cpu":
        return lstm_bidirectional_recurrence_plain(xw, w_hh, precision)
    _check_layer(xw, w_hh)
    D, H4, H = w_hh.shape
    if prepared is None:
        prepared = prepare_recurrent_weights(w_hh, precision)
    if (prepared.precision, prepared.hidden, prepared.packed.shape[0],
            prepared.packed.device) != (precision, H, D, xw.device):
        raise ValueError(f"prepared weights are for H={prepared.hidden}, "
                         f"D={prepared.packed.shape[0]}, "
                         f"{prepared.precision!r} on "
                         f"{prepared.packed.device}, not H={H}, D={D}, "
                         f"{precision!r} on {xw.device}")
    out = _launch_forward(xw, prepared, None)
    lstm_bidirectional_recurrence.launches += 1
    return out


lstm_bidirectional_recurrence.launches = 0


def _check_layer(xw: torch.Tensor, w_hh: torch.Tensor) -> None:
    """Raise unless xw (T, B, D*4H) and w_hh (D, 4H, H) are one float32
    LSTM layer on one CUDA device, xw contiguous."""
    if xw.device.type != "cuda" or w_hh.device != xw.device:
        raise ValueError(f"xw and w_hh must share one CUDA device, got "
                         f"{xw.device} and {w_hh.device}")
    if xw.dtype != torch.float32 or w_hh.dtype != torch.float32:
        raise TypeError(f"the LSTM kernel takes float32, got {xw.dtype} "
                        f"and {w_hh.dtype}")
    if w_hh.dim() != 3 or xw.dim() != 3:
        raise ValueError(f"expected xw (T, B, D*4H) and w_hh (D, 4H, H), "
                         f"got {tuple(xw.shape)} and {tuple(w_hh.shape)}")
    D, H4, H = w_hh.shape
    T, B, G = xw.shape
    if D not in (1, 2) or H4 != 4 * H or G != D * H4 or min(T, B, H) < 1:
        raise ValueError(f"shapes xw {tuple(xw.shape)} and w_hh "
                         f"{tuple(w_hh.shape)} do not form an LSTM layer")
    if not xw.is_contiguous():
        raise ValueError("xw must be contiguous")


def _launch_forward(xw: torch.Tensor, prepared: RecurrentWeights,
                    workspace: Optional[torch.Tensor]) -> torch.Tensor:
    """One launch of the forward kernel; also fills ``workspace`` (T, B,
    D, 5H) with each step's i, f, g, o and c where it is given
    ("highest" only). Counts nothing."""
    T, B, _ = xw.shape
    D, H = prepared.packed.shape[0], prepared.hidden
    out = torch.empty((T, B, D * H), device=xw.device, dtype=torch.float32)
    # the C entry launches on the current device
    with torch.cuda.device(xw.device):
        err = _library().lstm_recurrence(
            xw.data_ptr(), prepared.packed.data_ptr(), out.data_ptr(),
            None if workspace is None else workspace.data_ptr(),
            T, B, H, D, MODES[prepared.precision], prepared.cluster,
            torch.cuda.current_stream(xw.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"lstm_recurrence launch failed with CUDA error "
                           f"{err}")
    return out


def lstm_recurrence_backward(xw: torch.Tensor, w_hh: torch.Tensor,
                             grad_out: torch.Tensor) -> tuple:
    """(grad_xw, grad_w_hh) of ``lstm_bidirectional_recurrence`` at
    "highest" for the output's gradient ``grad_out`` (T, B, D*H).

    On the CPU this is ``lstm_bidirectional_recurrence_backward_plain``.
    On a CUDA device: the forward kernel recomputes the layer at
    "highest" into a (T, B, D, 5H) float32 workspace of gate activations
    and cell states (freed on return), the backward kernel walks it in
    reverse into grad_xw (one launch for every direction, counted in
    ``.launches``), and grad_w_hh[d] = sum over steps of dgates^T h_prev
    is one float32 product over (T * B), h_prev the recomputed h shifted
    in the direction's own order. A failed build or launch raises.
    """
    if all(t.device.type == "cpu" for t in (xw, w_hh, grad_out)):
        return lstm_bidirectional_recurrence_backward_plain(xw, w_hh,
                                                            grad_out)
    _check_layer(xw, w_hh)
    D, H4, H = w_hh.shape
    T, B, _ = xw.shape
    if (grad_out.shape != (T, B, D * H) or grad_out.device != xw.device
            or grad_out.dtype != torch.float32
            or not grad_out.is_contiguous()):
        raise ValueError(f"grad_out must be contiguous float32 "
                         f"{(T, B, D * H)} on {xw.device}, got "
                         f"{grad_out.dtype} {tuple(grad_out.shape)} on "
                         f"{grad_out.device}")
    prepared = prepare_recurrent_weights(w_hh, "highest")
    packed, cluster = pack_backward_weights(w_hh)
    workspace = torch.empty((T, B, D, 5 * H), device=xw.device,
                            dtype=torch.float32)
    h = _launch_forward(xw, prepared, workspace)
    grad_xw = torch.empty_like(xw)
    with torch.cuda.device(xw.device):
        err = _backward_library().lstm_recurrence_backward(
            workspace.data_ptr(), grad_out.data_ptr(), packed.data_ptr(),
            grad_xw.data_ptr(), T, B, H, D, cluster,
            torch.cuda.current_stream(xw.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"lstm_recurrence_backward launch failed with "
                           f"CUDA error {err}")
    lstm_recurrence_backward.launches += 1
    del workspace
    h_prev = h.new_zeros((D, T, B, H))
    h_prev[0, 1:] = h[:-1, :, :H]
    if D == 2:
        h_prev[1, :-1] = h[1:, :, H:]
    with exact_float32():
        grad_w_hh = torch.matmul(
            grad_xw.view(T * B, D, H4).permute(1, 2, 0),
            h_prev.view(D, T * B, H))
    return grad_xw, grad_w_hh


lstm_recurrence_backward.launches = 0


class LSTMRecurrence(torch.autograd.Function):
    """``lstm_bidirectional_recurrence`` with a gradient.

    ``LSTMRecurrence.apply(xw, w_hh, precision, prepared)``: the forward
    is ``lstm_bidirectional_recurrence`` (one counted kernel launch on a
    CUDA device, the plain version on the CPU) at ``precision``; xw must
    be contiguous and is saved for the backward as it is, with w_hh. The
    backward is ``lstm_recurrence_backward`` (the backward kernel on a
    CUDA device, counted in its own ``.launches``; the plain version on
    the CPU): the float32 vector-Jacobian product of the "highest"
    recurrence, whatever the forward's precision, as the JAX package's
    scan VJP at ``Precision.HIGHEST``.
    """

    @staticmethod
    def forward(ctx, xw, w_hh, precision=None, prepared=None):
        ctx.save_for_backward(xw, w_hh)
        return lstm_bidirectional_recurrence(xw, w_hh, precision, prepared)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad_out):
        xw, w_hh = ctx.saved_tensors
        grads = lstm_recurrence_backward(xw, w_hh, grad_out.contiguous())
        return tuple(g if need else None for g, need in
                     zip(grads, ctx.needs_input_grad[:2])) + (None, None)
