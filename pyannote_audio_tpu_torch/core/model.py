"""What a model predicts, and its output frames in time.

Counterpart of the Specifications part of pyannote_audio_tpu/core/model.py.
The port's models are ``torch.nn.Module``s; ``FrameModel`` adds the frame
arithmetic that Inference and the diarization pipeline read.
"""

from __future__ import annotations

from dataclasses import dataclass
from math import comb
from typing import List, Optional

from .segment import SlidingWindow


@dataclass(frozen=True)
class Specifications:
    """A segmentation model's task: chunk duration and (powerset) classes.

    ``powerset_max_classes`` set means a mono-label powerset output over
    ``classes`` (at most that many active at once).
    """

    duration: float
    classes: List[str]
    powerset_max_classes: Optional[int] = None

    @property
    def powerset(self) -> bool:
        return self.powerset_max_classes is not None

    @property
    def num_powerset_classes(self) -> int:
        return sum(comb(len(self.classes), k)
                   for k in range(self.powerset_max_classes + 1))

    @property
    def dimension(self) -> int:
        return self.num_powerset_classes if self.powerset \
            else len(self.classes)


class FrameModel:
    """Mixin for frame-resolution models: subclasses define
    ``receptive_field_size`` and ``receptive_field_center`` (in samples)
    and a ``sample_rate``."""

    sample_rate: int

    @property
    def receptive_field(self) -> SlidingWindow:
        """Output frames as a SlidingWindow (as the JAX Model computes it)."""
        size = self.receptive_field_size(num_frames=1)
        step = (self.receptive_field_center(frame=1)
                - self.receptive_field_center(frame=0))
        center = self.receptive_field_center(frame=0)
        return SlidingWindow(duration=size / self.sample_rate,
                             step=step / self.sample_rate,
                             start=(center - (size - 1) / 2)
                             / self.sample_rate)
