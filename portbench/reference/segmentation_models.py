"""The segmentation models the configurations name, each found by its
``kind``: ``portbench/reference/<kind>.py`` defines ``hparams``,
``forward``, ``num_frames``, ``frames``, ``chunk_flops`` and
``shared_flops`` (``portbench/flops.py``), and ``ssl_output`` where the
model has an SSL trunk. A new kind is a new file."""

from __future__ import annotations

import importlib
from types import ModuleType
from typing import Dict, Optional, Tuple

import torch

from .numerics import Numerics


def model(spec: dict) -> ModuleType:
    """The reference module of ``spec["kind"]``."""
    return importlib.import_module(f"{__package__}.{spec['kind']}")


def hparams(spec: dict) -> dict:
    """The hyper-parameters the model's reference function takes."""
    return model(spec).hparams(spec)


def forward(spec: dict, p: Dict[str, torch.Tensor], chunks: torch.Tensor,
            num: Numerics, features: bool = False) -> torch.Tensor:
    """(B, 1, samples) -> (B, frames, powerset classes) log-probs (the
    BiLSTM's output with ``features``)."""
    return model(spec).forward(spec, p, chunks, num, features=features)


def num_frames(spec: dict, num_samples: int) -> int:
    """Output frames of the model for a chunk of ``num_samples``."""
    return model(spec).num_frames(spec, num_samples)


def frames(spec: dict) -> Tuple[float, float]:
    """(duration, step) in seconds of the model's output frames."""
    return model(spec).frames(spec)


def ssl_output(spec: dict, p: Dict[str, torch.Tensor], chunks: torch.Tensor,
               num: Numerics) -> Optional[torch.Tensor]:
    """The SSL trunk's last layer over (B, samples) chunks, or None for a
    model without one."""
    fn = getattr(model(spec), "ssl_output", None)
    return None if fn is None else fn(spec, p, chunks, num)
