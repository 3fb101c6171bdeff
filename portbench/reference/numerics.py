"""The arithmetic the plain reference computes in.

"float32" is float32 with TF32 off for every matmul and convolution. The
lower modes exist for the control, the reference put in the program's
place one precision below what a configuration states:

- "fp8": every operand that the configuration computes in bf16 is
  rounded to float8 e4m3 with one scale per tensor (its absolute maximum
  maps to 448, as an fp8 deployment scales), then the product runs in
  float32; operands the configuration keeps in float32 stay so;
- "tf32-fp8": both that and TF32 allowed for every matmul and
  convolution, for a configuration that states float32 with TF32 off for
  some parts and bf16 for others.

Plain PyTorch only: nothing of the program is imported here.
"""

from __future__ import annotations

import contextlib

import torch

MODES = ("float32", "fp8", "tf32-fp8")
FP8_MAX = 448.0


def fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under one per-tensor scale, back in
    ``x``'s dtype."""
    scale = x.detach().abs().amax().clamp(min=1e-30) / FP8_MAX
    return ((x / scale).to(torch.float8_e4m3fn).to(x.dtype)) * scale


class Numerics:
    """``low(x)`` rounds an operand that the configuration computes in
    bf16; ``flags()`` sets the TF32 switches for the mode."""

    def __init__(self, mode: str = "float32"):
        if mode not in MODES:
            raise ValueError(f"mode must be one of {MODES}, not {mode!r}")
        self.mode = mode

    def low(self, x: torch.Tensor) -> torch.Tensor:
        return fp8(x) if self.mode.endswith("fp8") else x

    @contextlib.contextmanager
    def flags(self):
        allow = self.mode.startswith("tf32")
        saved = (torch.backends.cuda.matmul.allow_tf32,
                 torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = allow
        torch.backends.cudnn.allow_tf32 = allow
        try:
            yield
        finally:
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = saved
