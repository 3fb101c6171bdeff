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
``csrc/lstm_recurrence_backward.cu``: in one launch it recomputes the
layer at "highest" into a workspace of gate activations and cell states,
then walks it in reverse for the gradient of xw, both products on tensor
cores in three TF32 passes; one float32 product gives W_hh's gradient.
Its weights are packed by ``pack_backward_weights`` for the geometry
that ``backward_geometry`` chooses from H and B. On the CPU both are
their plain versions (``ops.lstm``).
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
SMS = 132                 # streaming multiprocessors of an H100 SXM
BACKWARD_ROWS = (8, 16, 32, 64)  # batch rows per cluster of the backward
BACKWARD_SLOTS = 8        # partial dh_rec sums a backward CTA receives


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


def backward_geometry(hidden: int, batch: int = 1,
                      directions: int = 2) -> dict:
    """The backward kernel's geometry for ``hidden`` units, ``batch`` rows
    and ``directions`` (``csrc/lstm_recurrence_backward.cu``).

    Each CTA owns ``units`` hidden units: 16 up to H = 128, in a cluster
    of the smallest power of two that covers H, with 8 warps; 32 above
    (a cluster of 8, 16 warps). A warp keeps ``frags`` = padded / 16 mma A
    fragments of W_hh, split into TF32 hi and lo: in ``a_registers``
    registers a thread at 16 units, in shared memory at 32. ``rows``, the
    batch rows per cluster, is the smallest of BACKWARD_ROWS whose grid of
    one CTA per SM fits the card's SMS at once (latency sets the time),
    else the largest (fewer waves); 8 at 32 units. ``shared_bytes`` is
    the kernel's dynamic shared memory, the larger phase's buffers plus A
    in shared memory and 4 mbarriers. Raises ``ValueError`` above
    MAX_HIDDEN.
    """
    if not 1 <= hidden <= MAX_HIDDEN:
        raise ValueError(f"hidden size {hidden} is outside what the LSTM "
                         f"backward kernel keeps on chip (1 to "
                         f"{MAX_HIDDEN})")
    if hidden <= 128:
        units = 16
        cluster = 1 << max(0, (-(-hidden // 16) - 1).bit_length())
        rows = next((r for r in BACKWARD_ROWS
                     if directions * -(-batch // r) * cluster <= SMS),
                    BACKWARD_ROWS[-1])
    else:
        units, cluster, rows = 32, 8, 8
    padded = units * cluster
    warps = units // 2
    frags = padded // 16
    gate_row = 4 * units + 4
    buffers = max(2 * rows * (padded + 4) + 2 * rows * gate_row,
                  2 * BACKWARD_SLOTS * units * (rows + 2) + rows * gate_row)
    a_shared = 0 if units == 16 else warps * frags * 32 * 16
    return {"cluster": cluster, "padded": padded, "units": units,
            "rows": rows, "warps": warps, "threads": 32 * warps,
            "frags": frags, "a_registers": 8 * frags if units == 16 else 0,
            "shared_bytes": a_shared + 4 * buffers + 4 * 8}


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


def pack_backward_weights(w_hh: torch.Tensor,
                          geometry: dict) -> torch.Tensor:
    """(D, 4H, H) W_hh -> (D, cluster, 2, warps, frags, 32, 4) float32,
    the backward kernel's mma A fragments for ``geometry``
    (``backward_geometry``; the packing depends on H only).

    Hidden units are padded with zero rows and columns. CTA c of the
    cluster owns units [c * units, (c + 1) * units) and their 4 gate
    rows, A = rows ``q * units + ul`` (gate q of unit ``c * units + ul``)
    of W_hh by its ``padded`` columns: phase 0 (the recompute) multiplies
    by A, phase 1 (the walk) by A's transpose. A matrix of M x K is cut
    into 16 x 8 tiles; warp ``kp * (M / 16) + mt`` holds tile row mt and
    k-steps ``kp * frags`` to ``(kp + 1) * frags - 1``; a lane (g = lane
    / 4, t = lane % 4) holds (A[g, t], A[g + 8, t], A[g, t + 4], A[g + 8,
    t + 4]) of each tile, mma.sync m16n8k8's A fragment. The kernel
    splits each value into TF32 hi and lo (``ops.lstm.split_tf32``).
    """
    D, H4, H = w_hh.shape
    C, Hp, units = geometry["cluster"], geometry["padded"], geometry["units"]
    warps, frags = geometry["warps"], geometry["frags"]
    w = F.pad(w_hh.float().reshape(D, 4, H, H), (0, Hp - H, 0, Hp - H))
    # (D, gate, C, ul, k) -> (D, C, gate * units + ul, k)
    a = w.reshape(D, 4, C, units, Hp).permute(0, 2, 1, 3, 4) \
        .reshape(D, C, 4 * units, Hp)

    def fragments(m: torch.Tensor) -> torch.Tensor:
        M, K = m.shape[2:]
        tiles, steps = M // 16, K // 8
        # (mt, row half, g, k-step, col half, t) -> (mt, k-step, g, t,
        # col half, row half): a lane's 4 values in fragment order
        x = m.reshape(D, C, tiles, 2, 8, steps, 2, 4) \
            .permute(0, 1, 2, 5, 4, 7, 6, 3).reshape(D, C, tiles, steps,
                                                     32, 4)
        # k-step kp * frags + i of tile mt -> warp kp * tiles + mt, frag i
        x = x.reshape(D, C, tiles, steps // frags, frags, 32, 4) \
            .permute(0, 1, 3, 2, 4, 5, 6)
        return x.reshape(D, C, warps, frags, 32, 4)

    return torch.stack([fragments(a), fragments(a.transpose(2, 3))],
                       dim=2).contiguous()


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
    return _bind("lstm_recurrence", 3, 6)


def _backward_library() -> ctypes.CDLL:
    return _bind("lstm_recurrence_backward", 6, 7)


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
    out = _launch_forward(xw, prepared)
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


def _launch_forward(xw: torch.Tensor,
                    prepared: RecurrentWeights) -> torch.Tensor:
    """One launch of the forward kernel. Counts nothing."""
    T, B, _ = xw.shape
    D, H = prepared.packed.shape[0], prepared.hidden
    out = torch.empty((T, B, D * H), device=xw.device, dtype=torch.float32)
    # the C entry launches on the current device
    with torch.cuda.device(xw.device):
        err = _library().lstm_recurrence(
            xw.data_ptr(), prepared.packed.data_ptr(), out.data_ptr(),
            T, B, H, D, MODES[prepared.precision], prepared.cluster,
            torch.cuda.current_stream(xw.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"lstm_recurrence launch failed with CUDA error "
                           f"{err}")
    return out


def _launch_backward(xw: torch.Tensor, grad_out: torch.Tensor,
                     packed: torch.Tensor, geometry: dict,
                     workspace: torch.Tensor, h_prev: torch.Tensor,
                     grad_xw: torch.Tensor, phases: int = 3) -> None:
    """One launch of the backward kernel: ``phases`` 1 recomputes the
    layer into ``workspace`` (T, B, D, 5H) and ``h_prev`` (D, T, B, H),
    2 walks them into ``grad_xw``, 3 does both. Counts nothing."""
    T, B, _ = xw.shape
    D, H = h_prev.shape[0], h_prev.shape[3]
    with torch.cuda.device(xw.device):
        err = _backward_library().lstm_recurrence_backward(
            xw.data_ptr(), grad_out.data_ptr(), packed.data_ptr(),
            workspace.data_ptr(), h_prev.data_ptr(), grad_xw.data_ptr(),
            T, B, H, D, geometry["cluster"], geometry["rows"], phases,
            torch.cuda.current_stream(xw.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"lstm_recurrence_backward launch failed with "
                           f"CUDA error {err}")


def lstm_recurrence_backward(xw: torch.Tensor, w_hh: torch.Tensor,
                             grad_out: torch.Tensor) -> tuple:
    """(grad_xw, grad_w_hh) of ``lstm_bidirectional_recurrence`` at
    "highest" for the output's gradient ``grad_out`` (T, B, D*H).

    On the CPU this is ``lstm_bidirectional_recurrence_backward_plain``.
    On a CUDA device one launch of the backward kernel (counted in
    ``.launches``) recomputes the layer at "highest" into a (T, B, D, 5H)
    float32 workspace of gate activations and cell states and h_prev (D,
    T, B, H), the recomputed h shifted in each direction's own order
    (both freed on return), then walks them in reverse into grad_xw, for
    every direction; grad_w_hh is ``grad_w_hh_product``. A failed build
    or launch raises.
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
    geometry = backward_geometry(H, B, D)
    packed = pack_backward_weights(w_hh, geometry)
    workspace = torch.empty((T, B, D, 5 * H), device=xw.device,
                            dtype=torch.float32)
    h_prev = torch.empty((D, T, B, H), device=xw.device, dtype=torch.float32)
    grad_xw = torch.empty_like(xw)
    _launch_backward(xw, grad_out, packed, geometry, workspace, h_prev,
                     grad_xw)
    lstm_recurrence_backward.launches += 1
    del workspace
    return grad_xw, grad_w_hh_product(grad_xw, h_prev)


lstm_recurrence_backward.launches = 0


def grad_w_hh_product(grad_xw: torch.Tensor,
                      h_prev: torch.Tensor) -> torch.Tensor:
    """grad_W_hh (D, 4H, H) = sum over steps and rows of dgates^T h_prev,
    from grad_xw (T, B, D*4H) and h_prev (D, T, B, H): one float32 2-D
    product over T * B per direction (cuBLAS splits the long sum; 6x
    faster than one batched product over a permuted view at DPRNN's B,
    measured on an H100)."""
    D, T, B, H = h_prev.shape
    rows = grad_xw.view(T * B, D * 4 * H)
    out = grad_xw.new_empty((D, 4 * H, H))
    with exact_float32():
        for d in range(D):
            torch.mm(rows[:, d * 4 * H:(d + 1) * 4 * H].t(),
                     h_prev[d].view(T * B, H), out=out[d])
    return out


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
