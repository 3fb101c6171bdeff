"""Device gates of the accelerator fast paths, and device resolution.

Counterpart of pyannote_audio_tpu/utils/runtime.py: the same environment
names, with "accelerator" read as "CUDA device". ``check_device`` is the
one place where an entry point's device is resolved: the CUDA card by
default, and a CUDA device without a card raises.
"""

from __future__ import annotations

import contextlib
import os
from typing import Union

import torch

LSTM_PRECISIONS = ("default", "high", "highest")


def check_device(device: Union[str, torch.device, None]) -> torch.device:
    """``device`` as a ``torch.device``, the CUDA card when it is None; a
    CUDA device without a card raises, so that nothing carries on on the
    CPU."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the pipeline runs on a CUDA device by default "
                           "and none is available: pass device=\"cpu\" to "
                           "run on the CPU")
    return device


@contextlib.contextmanager
def exact_float32():
    """TF32 off for CUDA matmuls and cuDNN convolutions, restored on exit.

    The port's counterpart of the JAX package's ``Precision.HIGHEST`` at
    its float32 call sites. torch's flags are process-global and cuDNN
    convolutions take TF32 by default, so every float32 site of the exact
    path runs under this, whatever the process set
    (``torch.set_float32_matmul_precision("high")`` included). It wraps
    whole module calls on the thread that queues device work; the worker
    threads of ``apply_batch`` only decode, so they never read the flags.
    """
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


def exact_float32_if(dtype: torch.dtype):
    """``exact_float32()`` for float32 work, a no-op for bf16 work."""
    return exact_float32() if dtype == torch.float32 \
        else contextlib.nullcontext()


def device_flag(name: str, device: Union[str, torch.device],
                accelerator_default: bool = True) -> bool:
    """Resolve a PYANNOTE_TPU_* gate for work on ``device``.

    An explicit "1" or "0" in the environment wins (any other value reads
    as off, as in the JAX package). When the variable is unset the gate is
    on iff ``device`` is a CUDA device, or off everywhere for an opt-in
    gate (``accelerator_default=False``).
    """
    value = os.environ.get(name)
    if value is not None:
        return value == "1"
    return accelerator_default and torch.device(device).type == "cuda"


def lstm_precision(device: Union[str, torch.device]) -> str:
    """Precision of the LSTM recurrent product for work on ``device``.

    Counterpart of ``_kernel_precision`` in the JAX package's
    ops/pallas_lstm.py: PYANNOTE_TPU_LSTM_PRECISION is "default" (h and
    W_hh rounded to bf16, products summed in float32), "high" (bf16_3x)
    or "highest" (float32); unset means "default", and any other value
    raises. On the CPU the answer is "highest" whatever the gate says,
    because the JAX package runs its float32 scan there.
    """
    name = os.environ.get("PYANNOTE_TPU_LSTM_PRECISION", "default")
    if name not in LSTM_PRECISIONS:
        raise ValueError(f"PYANNOTE_TPU_LSTM_PRECISION={name!r}: expected "
                         f"one of {LSTM_PRECISIONS}")
    return name if torch.device(device).type == "cuda" else "highest"
