"""Augmentation registry: input / target transforms applied to batches.

Counterpart of pyannote_audio_tpu/augmentation/registry.py: named
``(X, y) -> (X, y)`` transforms that ``Task.collate`` applies to every
numpy batch before it reaches the device, each with its probability
``p`` drawn from the batch's generator.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional

_REGISTRY: Dict[str, "AugmentationSpec"] = {}


@dataclass
class AugmentationSpec:
    name: str
    transform: Callable           # (X, y) -> (X, y)
    when: str = "input"           # "input" | "output"
    p: float = 1.0


def register_augmentation(name: str, transform: Callable,
                          when: str = "input", p: float = 1.0
                          ) -> AugmentationSpec:
    if when not in ("input", "output"):
        raise ValueError("when must be 'input' or 'output'")
    spec = AugmentationSpec(name=name, transform=transform, when=when, p=p)
    _REGISTRY[name] = spec
    return spec


def unregister_augmentation(name: str) -> None:
    _REGISTRY.pop(name, None)


def get_augmentation(name: str) -> Optional[AugmentationSpec]:
    return _REGISTRY.get(name)


def apply_augmentations(X, y, when: str = "input",
                        rng: Optional["object"] = None):
    """Apply registered transforms; each fires with its ``p``.

    ``rng``: optional np.random.Generator for reproducible draws (the
    Task collate passes its per-epoch generator). Transforms with p=1.0
    never consult it.
    """
    for spec in _REGISTRY.values():
        if spec.when != when:
            continue
        if spec.p < 1.0:
            import numpy as np
            draw = (rng.uniform() if rng is not None
                    else np.random.default_rng().uniform())
            if draw >= spec.p:
                continue
        X, y = spec.transform(X, y)
    return X, y


class TorchAudiomentationsWaveformTransformWrapper:
    """A torch-audiomentations waveform transform as a registry
    transform: the numpy batch goes through it as a tensor and comes back
    as numpy; targets pass through (waveform transforms are input-only).
    """

    def __init__(self, augmentation, model=None, when: str = "input",
                 sample_rate: int = 16000):
        if when != "input":
            raise ValueError(
                "waveform transforms can only be applied to the model "
                f"input, not {when!r}")
        self.augmentation = augmentation
        self.sample_rate = getattr(model, "sample_rate", sample_rate)

    def __call__(self, X, y):
        import numpy as np
        import torch
        samples = torch.from_numpy(np.ascontiguousarray(X))
        out = self.augmentation(samples=samples,
                                sample_rate=self.sample_rate)
        # torch-audiomentations may return an ObjectDict or a tensor
        samples = getattr(out, "samples", out)
        return samples.detach().cpu().numpy(), y


def wrap_augmentation(augmentation, model=None, when: str = "input"):
    """An augmentation for ``Task.collate``: (X, y) -> (X, y) callables
    pass through; objects with the torch-audiomentations ``(samples=...,
    sample_rate=...)`` convention are wrapped to take numpy batches."""
    if hasattr(augmentation, "sample_rate") or hasattr(
            augmentation, "supported_modes"):
        return TorchAudiomentationsWaveformTransformWrapper(
            augmentation, model=model, when=when)
    return augmentation
