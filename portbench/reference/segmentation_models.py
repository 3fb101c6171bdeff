"""The segmentation models the configurations name, by ``kind``."""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from . import pyannet
from .numerics import Numerics

BATCH = 256


def hparams(spec: dict) -> dict:
    """The hyper-parameters the model's reference function takes."""
    if spec["kind"] == "sseriouss":
        return dict(spec["hparams"], ssl=spec["ssl"])
    return spec["hparams"]


def forward(spec: dict, p: Dict[str, torch.Tensor], chunks: torch.Tensor,
            num: Numerics, features: bool = False) -> torch.Tensor:
    """(B, 1, samples) -> (B, frames, powerset classes) log-probs (the
    BiLSTM's output with ``features``), in batches that fit the card."""
    if spec["kind"] == "pyannet":
        return torch.cat([
            pyannet.pyannet(chunks[b:b + BATCH].contiguous(), p,
                            spec["hparams"], num, features=features)
            for b in range(0, len(chunks), BATCH)])
    if spec["kind"] == "sseriouss":
        from . import sseriouss
        return sseriouss.sseriouss(chunks, p, hparams(spec), num,
                                   features=features)
    raise ValueError(f"unknown segmentation kind {spec['kind']!r}")


def num_frames(spec: dict, num_samples: int) -> int:
    """Output frames of the model for a chunk of ``num_samples``."""
    if spec["kind"] == "pyannet":
        return pyannet.conv_frames(num_samples,
                                   spec["hparams"]["sincnet"]["stride"])
    from . import sseriouss
    for _, kernel, stride in sseriouss.CONV:
        num_samples = (num_samples - kernel) // stride + 1
    return num_samples


def frames(spec: dict) -> Tuple[float, float]:
    """(duration, step) in seconds of the model's output frames."""
    rate = spec["hparams"]["sample_rate"]
    if spec["kind"] == "pyannet":
        return pyannet.receptive_field(spec["hparams"]["sincnet"]["stride"],
                                       rate)
    from . import sseriouss
    return sseriouss.receptive_field(rate)
