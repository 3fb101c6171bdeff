"""Sliding-window batched inference.

Counterpart of pyannote_audio_tpu/core/inference.py (``_chunk_grid`` and
the batched ``slide``) for the diarization path: the waveform is moved to
the model's device once, chunks are strided views of it, each batch runs
the model eagerly, and powerset outputs are decoded to multilabel scores.
The result stays chunk-level and on the device (the JAX package's
``skip_aggregation=True`` path); the last chunk is zero-padded and a
short last batch runs at its own size.

Models that advertise ``FRONTEND_SHARED`` (PyanNet) may take the shared
front-end (the JAX package's ``_shared_frontend`` /
``_make_shared_batch_fn``): one raw front-end conv over the whole padded
file, then per chunk its conv frames and its raw mean and population
variance. The PYANNOTE_TPU_SHARED_SINC gate selects it (by default on a
CUDA device, off on the CPU), and it needs every chunk start on the conv
stride; otherwise the chunks run one by one, as in the JAX package.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..ops.powerset import Powerset
from ..utils.runtime import device_flag
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


def pad_to_grid(waveform: torch.Tensor, window_size: int,
                step_size: int) -> torch.Tensor:
    """(channel, samples) -> the waveform zero-padded to the chunk grid's
    length."""
    _, padded_len = _chunk_grid(waveform.shape[1], window_size, step_size)
    if padded_len > waveform.shape[1]:
        waveform = torch.nn.functional.pad(
            waveform, (0, padded_len - waveform.shape[1]))
    return waveform


def chunk_views(waveform: torch.Tensor, window_size: int,
                step_size: int) -> torch.Tensor:
    """(channel, samples) -> (num_chunks, channel, window) strided views
    over the waveform, zero-padded to the chunk grid's length."""
    return pad_to_grid(waveform, window_size, step_size).unfold(
        1, window_size, step_size).transpose(0, 1)


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
        # whole-file front-end convs run: one per file on the shared path
        self.counts = {"whole_conv": 0}

    def _shared_frontend(self, window_size: int, step_size: int,
                         device: torch.device) -> bool:
        """Take the shared whole-file front-end for this grid?"""
        if not getattr(self.model, "FRONTEND_SHARED", False):
            return False
        if not device_flag("PYANNOTE_TPU_SHARED_SINC", device):
            return False
        return step_size % self.model.frontend_stride == 0

    def _convert(self, out: torch.Tensor) -> torch.Tensor:
        return self._powerset.to_multilabel(out) \
            if self._powerset is not None else out

    @torch.inference_mode()
    def slide(self, waveform: torch.Tensor,
              sample_rate: int) -> SlidingWindowFeature:
        """(channel, samples) waveform on the device -> chunk-level scores.

        Returns a SlidingWindowFeature whose data is a (num_chunks,
        frames_per_chunk, num_classes) tensor on the device.
        """
        window_size = round(self.duration * sample_rate)
        step_size = round(self.step * sample_rate)
        padded = pad_to_grid(waveform, window_size, step_size)
        B = self.batch_size
        if waveform.shape[0] == 1 and self._shared_frontend(
                window_size, step_size, waveform.device):
            outputs = self._slide_shared(padded, window_size, step_size)
        else:
            chunks = chunk_views(padded, window_size, step_size)
            outputs = [self._convert(self.model(chunks[b:b + B].contiguous()))
                       for b in range(0, chunks.shape[0], B)]
        scores = torch.cat(outputs) if len(outputs) > 1 else outputs[0]
        return SlidingWindowFeature(
            scores, SlidingWindow(start=0.0, duration=self.duration,
                                  step=self.step))

    def _slide_shared(self, padded: torch.Tensor, window_size: int,
                      step_size: int) -> list:
        """Batched forwards from one front-end conv over the (1, samples)
        grid-padded waveform."""
        model = self.model
        try:
            conv_whole = model.precompute_frontend(padded)
        except torch.cuda.OutOfMemoryError as exception:
            raise MemoryError(
                "the whole-file front-end conv buffer does not fit in "
                "device memory for this file length; set "
                "PYANNOTE_TPU_SHARED_SINC=0 to fall back to per-chunk "
                "forwards.") from exception
        self.counts["whole_conv"] += 1
        # strided views: chunk c's samples start at c * step, its conv
        # frames at c * step / stride
        raw = padded[0].unfold(0, window_size, step_size)      # (C, window)
        frames = conv_whole[0].unfold(
            1, model.frontend_num_frames(window_size),
            step_size // model.frontend_stride).transpose(0, 1)
        B = self.batch_size
        outputs = []
        for b in range(0, raw.shape[0], B):
            var, mean = torch.var_mean(raw[b:b + B], dim=-1, correction=0)
            out = model.forward_from_frontend(frames[b:b + B], mean, var)
            outputs.append(self._convert(out))
        return outputs
