"""Device gates of the accelerator fast paths.

Counterpart of pyannote_audio_tpu/utils/runtime.py: the same environment
names, with "accelerator" read as "CUDA device".
"""

from __future__ import annotations

import os
from typing import Union

import torch

LSTM_PRECISIONS = ("default", "high", "highest")


def device_flag(name: str, device: Union[str, torch.device]) -> bool:
    """Resolve a PYANNOTE_TPU_* gate for work on ``device``.

    An explicit "1" or "0" in the environment wins (any other value reads
    as off, as in the JAX package). When the variable is unset the gate is
    on iff ``device`` is a CUDA device.
    """
    value = os.environ.get(name)
    if value is not None:
        return value == "1"
    return torch.device(device).type == "cuda"


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
