"""Device gates of the accelerator fast paths.

Counterpart of pyannote_audio_tpu/utils/runtime.py: the same environment
names, with "accelerator" read as "CUDA device".
"""

from __future__ import annotations

import os
from typing import Union

import torch


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
