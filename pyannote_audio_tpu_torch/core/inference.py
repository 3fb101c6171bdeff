"""Sliding-window batched inference.

Counterpart of pyannote_audio_tpu/core/inference.py (``_chunk_grid`` and
the batched ``slide``) for the diarization path: the waveform is moved to
the model's device once, chunks are strided views of it, each batch runs
the model eagerly, and powerset outputs are decoded to multilabel scores.
The result stays chunk-level and on the device (the JAX package's
``skip_aggregation=True`` path); the last chunk is zero-padded and a
short last batch runs at its own size.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..ops.powerset import Powerset
from .segment import SlidingWindow, SlidingWindowFeature


def _chunk_grid(num_samples: int, window_size: int,
                step_size: int) -> Tuple[np.ndarray, int]:
    """Chunk starts (int64 samples) + the zero-padded length they need.

    A last, partial chunk is added when the grid does not end exactly at
    the end of the file (or when the file is shorter than one window).
    """
    num_full = 1 + (num_samples - window_size) // step_size \
        if num_samples >= window_size else 0
    has_last = num_samples < window_size or \
        (num_samples - window_size) % step_size > 0
    starts = np.arange(num_full + int(has_last), dtype=np.int64) * step_size
    return starts, int(starts[-1]) + window_size


def chunk_views(waveform: torch.Tensor, window_size: int,
                step_size: int) -> torch.Tensor:
    """(channel, samples) -> (num_chunks, channel, window) strided views
    over the waveform, zero-padded to the chunk grid's length."""
    starts, padded_len = _chunk_grid(waveform.shape[1], window_size,
                                     step_size)
    if padded_len > waveform.shape[1]:
        waveform = torch.nn.functional.pad(
            waveform, (0, padded_len - waveform.shape[1]))
    chunks = waveform.unfold(1, window_size, step_size).transpose(0, 1)
    assert chunks.shape[0] == len(starts)
    return chunks


class Inference:
    """Run a segmentation model over a file with a sliding window.

    ``model`` is a frame-resolution ``nn.Module`` with ``specifications``
    (e.g. PyanNet), on the device the waveforms will be on.
    """

    def __init__(self, model: nn.Module, duration: Optional[float] = None,
                 step: Optional[float] = None, batch_size: int = 32):
        spec = model.specifications
        self.model = model
        self.duration = duration or spec.duration
        self.step = 0.1 * self.duration if step is None else step
        if self.step > self.duration:
            raise ValueError("step must not be larger than duration")
        self.batch_size = batch_size
        self._powerset = Powerset(len(spec.classes),
                                  spec.powerset_max_classes) \
            if spec.powerset else None

    @torch.inference_mode()
    def slide(self, waveform: torch.Tensor,
              sample_rate: int) -> SlidingWindowFeature:
        """(channel, samples) waveform on the device -> chunk-level scores.

        Returns a SlidingWindowFeature whose data is a (num_chunks,
        frames_per_chunk, num_classes) tensor on the device.
        """
        window_size = round(self.duration * sample_rate)
        step_size = round(self.step * sample_rate)
        chunks = chunk_views(waveform, window_size, step_size)
        B = self.batch_size
        outputs = []
        for b in range(0, chunks.shape[0], B):
            out = self.model(chunks[b:b + B].contiguous())
            if self._powerset is not None:
                out = self._powerset.to_multilabel(out)
            outputs.append(out)
        scores = torch.cat(outputs) if len(outputs) > 1 else outputs[0]
        return SlidingWindowFeature(
            scores, SlidingWindow(start=0.0, duration=self.duration,
                                  step=self.step))
