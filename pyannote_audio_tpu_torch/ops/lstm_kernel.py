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
the kernel (the plain version on the CPU), its backward the gradient of
the plain float32 recurrence recomputed from the saved inputs. There is
no backward kernel, as there is no backward Pallas kernel.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F

from ..utils.runtime import LSTM_PRECISIONS, exact_float32, lstm_precision
from .lstm import lstm_bidirectional_recurrence_plain, split_bf16

MAX_HIDDEN = 256          # the csrc kernel's kMaxHidden
SHARED_BYTES = 227 * 1024  # shared memory a Hopper block can use
ROWS = 8                  # batch rows per cluster: the mma's n
STAGES = 6                # xw ring depth in the csrc kernel (kStages)
MAX_UNITS = 64            # hidden units per CTA (kMaxUnits): 4 warps
MODES = {"default": 0, "high": 1, "highest": 2}


def kernel_geometry(hidden: int, precision: str) -> dict:
    """Cluster size and padded hidden size the kernel runs ``hidden`` at.

    Each CTA of a cluster owns ``padded // cluster`` hidden units (a
    multiple of 16, a warp per 16, at most MAX_UNITS) and keeps their 4
    gate rows of W_hh in shared memory beside the xw ring and the
    double-buffered h. The smallest cluster
    (2 from H = 17 on, to spread the product over more SMs) whose units
    and bytes fit is taken, up to 8. Raises ``ValueError`` above
    MAX_HIDDEN.
    """
    if precision not in MODES:
        raise ValueError(f"unknown LSTM precision {precision!r}: expected "
                         f"one of {LSTM_PRECISIONS}")
    if not 1 <= hidden <= MAX_HIDDEN:
        raise ValueError(f"hidden size {hidden} is outside what the LSTM "
                         f"kernel keeps on chip (1 to {MAX_HIDDEN})")
    for cluster in ((1, 2, 4, 8) if hidden <= 16 else (2, 4, 8)):
        padded = -(-hidden // (16 * cluster)) * 16 * cluster
        units = padded // cluster
        if precision == "highest":
            w_bytes = 4 * units * padded * 4
            h_bytes = 2 * padded * ROWS * 4
        else:
            parts = 2 if precision == "high" else 1
            w_bytes = parts * 4 * units * padded * 2
            h_bytes = parts * 2 * ROWS * (padded + 8) * 2
        ring_bytes = STAGES * ROWS * (4 * units + 4) * 4
        shared = w_bytes + h_bytes + ring_bytes + 16  # + 2 mbarriers
        if units <= MAX_UNITS and shared <= SHARED_BYTES:
            return {"cluster": cluster, "padded": padded,
                    "shared_bytes": shared}
    raise AssertionError("unreachable: H <= MAX_HIDDEN fits a cluster of 8")


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


def _library() -> ctypes.CDLL:
    from ..utils.build import load
    lib = load("lstm_recurrence")
    fn = lib.lstm_recurrence
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


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
    if prepared is None:
        prepared = prepare_recurrent_weights(w_hh, precision)
    if (prepared.precision, prepared.hidden, prepared.packed.shape[0],
            prepared.packed.device) != (precision, H, D, xw.device):
        raise ValueError(f"prepared weights are for H={prepared.hidden}, "
                         f"D={prepared.packed.shape[0]}, "
                         f"{prepared.precision!r} on "
                         f"{prepared.packed.device}, not H={H}, D={D}, "
                         f"{precision!r} on {xw.device}")
    lib = _library()
    out = torch.empty((T, B, D * H), device=xw.device, dtype=torch.float32)
    # the C entry launches on the current device
    with torch.cuda.device(xw.device):
        err = lib.lstm_recurrence(
            xw.data_ptr(), prepared.packed.data_ptr(), out.data_ptr(),
            T, B, H, D, MODES[precision], prepared.cluster,
            torch.cuda.current_stream(xw.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"lstm_recurrence launch failed with CUDA error "
                           f"{err}")
    lstm_bidirectional_recurrence.launches += 1
    return out


lstm_bidirectional_recurrence.launches = 0


class LSTMRecurrence(torch.autograd.Function):
    """``lstm_bidirectional_recurrence`` with a gradient.

    ``LSTMRecurrence.apply(xw, w_hh, precision, prepared)``: the forward
    is ``lstm_bidirectional_recurrence`` (one counted kernel launch on a
    CUDA device, the plain version on the CPU) at ``precision``; xw must
    be contiguous and is saved for the backward as it is, with w_hh. The
    backward recomputes ``lstm_bidirectional_recurrence_plain(xw, w_hh,
    "highest")`` under autograd and returns its vector-Jacobian product,
    with TF32 off, whatever the forward's precision: the JAX package's
    scan VJP at ``Precision.HIGHEST``. It launches no kernel of its own.
    """

    @staticmethod
    def forward(ctx, xw, w_hh, precision=None, prepared=None):
        ctx.save_for_backward(xw, w_hh)
        return lstm_bidirectional_recurrence(xw, w_hh, precision, prepared)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad_out):
        xw, w_hh = ctx.saved_tensors
        wanted = ctx.needs_input_grad[:2]
        inputs = [t.detach().requires_grad_(need)
                  for t, need in zip((xw, w_hh), wanted)]
        with torch.enable_grad(), exact_float32():
            out = lstm_bidirectional_recurrence_plain(*inputs, "highest")
            grads = iter(torch.autograd.grad(
                out, [t for t in inputs if t.requires_grad], grad_out))
        return tuple(next(grads) if need else None
                     for need in wanted) + (None, None)
