"""The LSTM recurrence as a hand-written Hopper kernel.

Counterpart of pyannote_audio_tpu/ops/pallas_lstm.py: the CUDA kernel in
``csrc/lstm_recurrence.cu`` runs one bidirectional layer's recurrence in
one launch (see the source for its design). A CPU tensor takes the plain
PyTorch version (``ops.lstm``); a CUDA tensor launches the kernel or
raises — there is no fallback.
"""

from __future__ import annotations

import ctypes

import torch

from .lstm import lstm_bidirectional_recurrence_plain


def _library() -> ctypes.CDLL:
    from ..utils.build import load
    lib = load("lstm_recurrence")
    fn = lib.lstm_recurrence_f32
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.lstm_recurrence_max_hidden.argtypes = []
        lib.lstm_recurrence_max_hidden.restype = ctypes.c_int
    return lib


def lstm_bidirectional_recurrence(xw: torch.Tensor,
                                  w_hh: torch.Tensor) -> torch.Tensor:
    """(T, B, D*4H) hoisted inputs + (D, 4H, H) weights -> (T, B, D*H).

    D is 1 or 2 directions; direction 1 walks time backwards. On the CPU
    this is ``lstm_bidirectional_recurrence_plain``; on a CUDA device one
    kernel launch covers every direction, counted in ``.launches``.
    """
    if xw.device.type == "cpu" and w_hh.device.type == "cpu":
        return lstm_bidirectional_recurrence_plain(xw, w_hh)
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
    lib = _library()
    max_hidden = lib.lstm_recurrence_max_hidden()
    if H > max_hidden:
        raise ValueError(f"hidden size {H} exceeds the kernel's shared "
                         f"memory budget (at most {max_hidden})")
    # W_hh transposed to (D, H, 4H): a warp reads neighbouring gate columns
    w_hh_t = w_hh.transpose(1, 2).contiguous()
    out = torch.empty((T, B, D * H), device=xw.device, dtype=torch.float32)
    # the C entry launches on the current device
    with torch.cuda.device(xw.device):
        err = lib.lstm_recurrence_f32(
            xw.data_ptr(), w_hh_t.data_ptr(), out.data_ptr(), T, B, H, D,
            torch.cuda.current_stream(xw.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"lstm_recurrence_f32 launch failed with CUDA "
                           f"error {err}")
    lstm_bidirectional_recurrence.launches += 1
    return out


lstm_bidirectional_recurrence.launches = 0
