"""Sliding-window batched inference.

Counterpart of pyannote_audio_tpu/core/inference.py (``Inference`` with
its ``window="sliding"`` / ``"whole"``, ``pre_aggregation_hook``,
``skip_aggregation`` and ``skip_conversion`` options, ``infer``,
``crop``, the static ``aggregate`` and ``trim``, and underneath
``_chunk_grid``, the device-waveform cache, ``_slide_scores``, the
batched ``slide`` and its long-file slices, ``preload``): the waveform is
uploaded once per file, chunks are strided views of it, each batch runs
the model eagerly, and powerset outputs are decoded to multilabel scores.
The last chunk is zero-padded and a short last batch runs at its own
size.

``slide`` keeps chunk-level scores on the device (the diarization path)
when ``skip_aggregation`` is set or the output is permutation-invariant
with no ``pre_aggregation_hook``; otherwise it aggregates them on the
device into frame-level scores (hamming and warm-up weighted overlap-add)
and returns those on the host. The hook takes and returns a (chunks,
frames, classes) tensor on the device.

Models that advertise ``FRONTEND_SHARED`` (PyanNet) may take the shared
front-end (the JAX package's ``_shared_frontend`` /
``_make_shared_batch_fn``): one raw front-end conv over the whole padded
file, then per chunk its conv frames and its raw mean and population
variance. The PYANNOTE_TPU_SHARED_SINC gate selects it (by default on a
CUDA device, off on the CPU), and it needs every chunk start on the conv
stride; otherwise the chunks run one by one, as in the JAX package.

Files past the device-memory budget run in halo'd slices
(core/longfile.py): each slice is uploaded and run on its own, with its
chunk starts translated, and the per-chunk scores are concatenated. Slice
uploads stay cached for a later stage only where one reuses them (the
chunk-level path); aggregating runs release each after its batches.

Uploads to a CUDA device go through page-locked host memory with
``non_blocking=True``: a copy from pageable memory would make the host
wait for all the work already queued on the stream.
"""

from __future__ import annotations

import math
import warnings
from collections.abc import MutableMapping
from pathlib import Path
from typing import Callable, List, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from ..ops.aggregate import aggregate_scores
from ..ops.powerset import Powerset
from ..utils.runtime import check_device, device_flag
from .io import Audio, AudioFile
from .longfile import (plan_slices, retained_upload_bytes_ok,
                       slice_uploads)
from .model import Model, Resolution, first_specifications
from .segment import Segment, SlidingWindow, SlidingWindowFeature


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


def _progression(starts: np.ndarray, unit: int) -> Tuple[int, int]:
    """(first start, step) of chunk starts that are evenly spaced, as the
    chunk grid and its translation into a slice are; a single chunk gets
    the step ``unit``."""
    first = int(starts[0])
    if len(starts) == 1:
        return first, unit
    step = int(starts[1] - starts[0])
    if step <= 0 or np.any(np.diff(starts) != step):
        raise ValueError("chunk starts must be evenly spaced")
    return first, step


def chunks_at(buffer: torch.Tensor, starts: np.ndarray,
              window_size: int) -> torch.Tensor:
    """(channel, samples) buffer -> (len(starts), channel, window) strided
    views of the chunks starting at ``starts``."""
    first, step = _progression(starts, 1)
    return buffer[:, first:].unfold(1, window_size, step)[
        :, :len(starts)].transpose(0, 1)


def _waveform_fingerprint(waveform: np.ndarray) -> tuple:
    """Content key of the device-buffer caches (the JAX package's recipe):
    shape, dtype, a float64 checksum of every sample, a strided abs-sum
    (sign flips) and the two end samples. ``_upload_waveform_cached`` and
    ``longfile.slice_uploads`` share it, so both caches agree on what is
    the same audio."""
    n = waveform.shape[-1]
    stride = max(1, n // 4096)
    probe = (float(waveform.sum(dtype=np.float64)),
             float(np.abs(waveform[0, ::stride]).sum(dtype=np.float64)),
             float(waveform[0, 0]), float(waveform[0, n - 1]))
    return (waveform.shape, str(waveform.dtype), probe)


def pinned(array: np.ndarray) -> torch.Tensor:
    """A copy of a host array in page-locked memory, from which a copy to
    a CUDA device does not make the host wait. An empty pinned tensor is
    filled by numpy: inside the pipeline, ``Tensor.pin_memory()`` of a
    whole waveform was the slowest host step of a file-by-file pass
    (PERF.md). Needs a CUDA runtime."""
    array = np.ascontiguousarray(array)
    out = torch.empty(array.shape, dtype=torch.from_numpy(array).dtype,
                      pin_memory=True)
    out.numpy()[...] = array
    return out


def pin_waveform(waveform: np.ndarray) -> np.ndarray:
    """A float32 copy of a host waveform in page-locked memory, as a numpy
    view of a pinned tensor (which the view keeps alive)."""
    return pinned(np.asarray(waveform, dtype=np.float32)).numpy()


def to_device(array: np.ndarray, device) -> torch.Tensor:
    """A small host array as a tensor on ``device``. To a CUDA device it
    goes through page-locked memory and does not make the host wait; the
    caching host allocator keeps the pinned block until the copy ran."""
    if torch.device(device).type != "cuda":
        return torch.from_numpy(np.ascontiguousarray(array))
    return pinned(array).to(device, non_blocking=True)


def _upload_waveform(waveform, device,
                     padded_len: Optional[int] = None) -> torch.Tensor:
    """A (channel, samples) float32 host array, or a tensor, as a tensor
    on ``device``, zero-padded to ``padded_len`` samples.

    To a CUDA device the samples go from page-locked memory (the array's
    own when it is a ``pin_waveform`` view, else a pinned copy) with
    ``non_blocking=True``. A pinned view's array must outlive the copy:
    the pipelines keep it in the file dict until the file is finalized.
    """
    device = torch.device(device)
    if isinstance(waveform, torch.Tensor):
        out = waveform.to(device)
    else:
        array = np.ascontiguousarray(waveform, dtype=np.float32)
        out = torch.from_numpy(array)
        if device.type == "cuda":
            if not out.is_pinned():
                out = pinned(array)
            out = out.to(device, non_blocking=True)
    if padded_len is not None and padded_len > out.shape[1]:
        out = torch.nn.functional.pad(out, (0, padded_len - out.shape[1]))
    return out


def _upload_waveform_cached(waveform, cache, device) -> torch.Tensor:
    """The file's waveform on ``device``, uploaded once per file.

    The segmentation and embedding stages share the buffer through the
    file dict (``cache``) under ``_device_waveform``, keyed by the
    waveform's fingerprint and the device: a reused dict whose waveform
    was replaced or changed uploads afresh. A tensor is used as it is.
    """
    if isinstance(waveform, torch.Tensor) or cache is None:
        return _upload_waveform(waveform, device)
    key = _waveform_fingerprint(waveform) + (str(torch.device(device)),)
    hit = cache.get("_device_waveform")
    if hit is not None and hit[0] == key:
        return hit[1]
    buf = _upload_waveform(waveform, device)
    if isinstance(cache, MutableMapping):
        cache["_device_waveform"] = (key, buf)
    return buf


def _concat(parts: list):
    """Concatenate per-batch outputs along the chunks, per output of a
    multi-task model."""
    if len(parts) == 1:
        return parts[0]
    if isinstance(parts[0], tuple):
        return tuple(torch.cat(p) for p in zip(*parts))
    return torch.cat(parts)


class Inference:
    """Run a model over a file with a sliding (or whole-file) window.

    ``model`` is an ``nn.Module`` with ``specifications`` (e.g. PyanNet),
    or a checkpoint path for ``Model.from_pretrained``. It is moved to
    ``device``: the CUDA card when None (a CUDA device without a card
    raises; ``device="cpu"`` runs on the CPU). ``step`` defaults to the
    model's left warm-up, else a tenth of ``duration`` (by default the
    model's training duration).
    """

    def __init__(self, model: Union[nn.Module, str, Path],
                 window: str = "sliding", duration: Optional[float] = None,
                 step: Optional[float] = None,
                 pre_aggregation_hook: Optional[Callable] = None,
                 skip_aggregation: bool = False,
                 skip_conversion: bool = False, batch_size: int = 32,
                 device: Union[str, torch.device, None] = None):
        if window not in ("sliding", "whole"):
            raise ValueError('`window` must be "sliding" or "whole".')
        self.model = model if isinstance(model, nn.Module) \
            else Model.from_pretrained(model)
        specs = self.model.specifications
        spec = first_specifications(specs)
        if window == "whole" and spec.resolution == Resolution.FRAME:
            warnings.warn(
                'Using "whole" window on a frame-resolution model.')
        self.window = window
        self.skip_aggregation = skip_aggregation
        self.skip_conversion = skip_conversion
        self.pre_aggregation_hook = pre_aggregation_hook
        self.batch_size = batch_size
        training_duration = spec.duration
        duration = duration or training_duration
        if training_duration and training_duration != duration:
            warnings.warn(
                f"Duration ({duration:g}s) != training duration "
                f"({training_duration:g}s); this may hurt performance.")
        self.duration = duration
        self.warm_up = spec.warm_up or (0.0, 0.0)
        if step is None:
            step = 0.1 * duration if self.warm_up[0] == 0.0 \
                else self.warm_up[0]
        if step > self.duration:
            raise ValueError("step must not be larger than duration")
        self.step = step
        # one powerset converter per output (None where it is not one):
        # a multi-task model's tuple gets a tuple
        converters = tuple(
            Powerset(len(s.classes), s.powerset_max_classes)
            if s.powerset else None
            for s in (specs if isinstance(specs, tuple) else (specs,)))
        self._powerset = converters if isinstance(specs, tuple) \
            else converters[0]
        if isinstance(self._powerset, tuple) and \
                all(c is None for c in self._powerset):
            self._powerset = None
        self.audio = Audio(sample_rate=getattr(self.model, "sample_rate",
                                               16000), mono="downmix")
        # whole-file front-end convs run: one per file (or slice) on the
        # shared path
        self.counts = {"whole_conv": 0}
        self.to(check_device(device))

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device

    def to(self, device: Union[str, torch.device]) -> "Inference":
        """Move the model to ``device`` and drop the per-device constants
        cached for it (the powerset mapping, the LSTM's packed weights)."""
        self.model.to(device)
        for converter in (self._powerset if isinstance(self._powerset, tuple)
                          else (self._powerset,)):
            if converter is not None:
                converter._mapping_on.clear()
        for module in self.model.modules():
            prepared = getattr(module, "_prepared", None)
            if isinstance(prepared, dict):
                prepared.clear()
        return self

    def _shared_frontend(self, window_size: int, step_size: int,
                         device: torch.device) -> bool:
        """Take the shared whole-file front-end for this grid?"""
        if not getattr(self.model, "FRONTEND_SHARED", False):
            return False
        if not device_flag("PYANNOTE_TPU_SHARED_SINC", device):
            return False
        return step_size % self.model.frontend_stride == 0

    def _convert(self, out):
        """Powerset outputs to multi-label scores, per output of a
        multi-task model."""
        if self._powerset is None or self.skip_conversion:
            return out
        if isinstance(self._powerset, tuple):
            return tuple(o if c is None else c.to_multilabel(o)
                         for c, o in zip(self._powerset, out))
        return self._powerset.to_multilabel(out)

    @torch.inference_mode()
    def infer(self, chunks):
        """Forward an explicit (batch, channel, samples) array or tensor;
        returns the (converted) outputs on the host, a tuple of them for a
        multi-task model."""
        x = torch.as_tensor(np.asarray(chunks, dtype=np.float32)) \
            if not isinstance(chunks, torch.Tensor) else chunks
        out = self._convert(self.model(x.to(self.device)))
        if isinstance(out, tuple):
            return tuple(o.float().cpu().numpy() for o in out)
        return out.float().cpu().numpy()

    def _slide_scores(self, device_waveform: torch.Tensor,
                      starts: np.ndarray, window_size: int, shared: bool,
                      hook: Optional[Callable] = None, hook_base: int = 0,
                      hook_total: int = 0) -> torch.Tensor:
        """Batched forwards over the chunks at ``starts`` (evenly spaced
        sample offsets) of one uploaded (slice of a) waveform; returns the
        (len(starts), frames, classes) scores on the device (a tuple of
        outputs for a multi-task model).

        ``hook(completed=, total=)`` follows each batch, counted from
        ``hook_base`` chunks out of ``hook_total`` (a slice's place in its
        file).
        """
        model = self.model
        if shared:
            try:
                conv_whole = model.precompute_frontend(device_waveform)
            except torch.cuda.OutOfMemoryError as exception:
                raise MemoryError(
                    "the whole-file front-end conv buffer does not fit in "
                    "device memory for this file length; set "
                    "PYANNOTE_TPU_SHARED_SINC=0 to fall back to per-chunk "
                    "forwards.") from exception
            self.counts["whole_conv"] += 1
            # a chunk's samples start at s, its conv frames at s / stride
            stride = model.frontend_stride
            first, step = _progression(starts, stride)
            raw = chunks_at(device_waveform, starts, window_size)[:, 0]
            frames = conv_whole[0][:, first // stride:].unfold(
                1, model.frontend_num_frames(window_size),
                step // stride)[:, :len(starts)].transpose(0, 1)
        else:
            chunks = chunks_at(device_waveform, starts, window_size)
        B = self.batch_size
        num_chunks = len(starts)
        outputs = []
        for b in range(0, num_chunks, B):
            try:
                if shared:
                    var, mean = torch.var_mean(raw[b:b + B], dim=-1,
                                               correction=0)
                    out = model.forward_from_frontend(frames[b:b + B],
                                                      mean, var)
                else:
                    out = model(chunks[b:b + B].contiguous())
            except torch.cuda.OutOfMemoryError as exception:
                message = (f"batch_size ({self.batch_size: d}) is probably "
                           f"too large. Try with a smaller value until "
                           f"memory error disappears.")
                if shared:
                    message += (" The shared front-end also holds a "
                                "whole-file conv buffer that batch_size "
                                "cannot shrink; PYANNOTE_TPU_SHARED_SINC=0 "
                                "reverts to per-chunk forwards.")
                raise MemoryError(message) from exception
            outputs.append(self._convert(out))
            if hook is not None:
                hook(completed=hook_base + min(b + B, num_chunks),
                     total=hook_total or num_chunks)
        return _concat(outputs)

    @torch.inference_mode()
    def slide(self, waveform, sample_rate: int,
              hook: Optional[Callable] = None,
              cache=None) -> SlidingWindowFeature:
        """(channel, samples) waveform -> chunk-level scores.

        ``waveform`` is a float32 host array, uploaded through ``cache``
        (the file dict, shared with later stages), or a tensor already on
        the model's device. Files past the memory budget run slice by
        slice (core/longfile.py). Returns a SlidingWindowFeature whose
        data is a (num_chunks, frames_per_chunk, num_classes) tensor on
        the device, unless the output is aggregated: then a host
        SlidingWindowFeature of (frames, classes) on the model's receptive
        field, cut at the end of the file. A multi-task model gives a
        tuple of chunk-level host SlidingWindowFeatures, one per output,
        without aggregation, as the JAX package does.
        ``hook(completed=, total=)`` follows each batch.
        """
        window_size = round(self.duration * sample_rate)
        step_size = round(self.step * sample_rate)
        num_samples = waveform.shape[1]
        starts, _ = _chunk_grid(num_samples, window_size, step_size)
        device = self.device
        spec = first_specifications(self.model.specifications)
        frame_resolution = spec.resolution == Resolution.FRAME
        chunk_level = self.skip_aggregation or (
            spec.permutation_invariant and self.pre_aggregation_hook is None)
        shared = waveform.shape[0] == 1 and self._shared_frontend(
            window_size, step_size, device)
        plan = plan_slices(num_samples, window_size, step_size, sample_rate,
                           starts)
        if plan is not None and len(plan) > 1:
            get_upload, release_upload = slice_uploads(
                cache, waveform, plan, sample_rate, starts, window_size,
                device)
            # chunk-level scores feed the embedding stage, which reuses
            # the slice uploads, but only while all of them together stay
            # a small share of the budget; aggregated outputs have no
            # later stage, so each slice goes as it came
            keep_for_later = frame_resolution and chunk_level and \
                retained_upload_bytes_ok(num_samples)
            parts = []
            for k, sl in enumerate(plan):
                parts.append(self._slide_scores(
                    get_upload(k), starts[sl.i0:sl.i1] - sl.a, window_size,
                    shared, hook=hook, hook_base=sl.i0,
                    hook_total=len(starts)))
                if not keep_for_later:
                    release_upload(k)
            scores = _concat(parts)
        else:
            buffer = pad_to_grid(
                _upload_waveform_cached(waveform, cache, device),
                window_size, step_size)
            scores = self._slide_scores(buffer, starts, window_size, shared,
                                        hook=hook, hook_total=len(starts))
        chunk_window = SlidingWindow(start=0.0, duration=self.duration,
                                     step=self.step)
        if isinstance(scores, tuple):
            return tuple(SlidingWindowFeature(s.cpu().numpy(), chunk_window)
                         for s in scores)
        if not frame_resolution:
            return SlidingWindowFeature(scores.cpu().numpy(), chunk_window)
        if chunk_level:
            return SlidingWindowFeature(scores, chunk_window)
        if self.pre_aggregation_hook is not None:
            scores = torch.as_tensor(self.pre_aggregation_hook(scores),
                                     device=device)
        # per-chunk output-frame offsets, with the op order of
        # SlidingWindow.closest_frame
        frames = self.model.receptive_field
        t = starts.astype(np.float64) / sample_rate
        offsets = np.rint((t + 0.5 * frames.duration - frames.start
                           - 0.5 * frames.duration) / frames.step
                          ).astype(np.int64)
        num_output_frames = int(math.floor(num_samples / sample_rate
                                           / frames.step))
        total_frames = max(num_output_frames, int(offsets[-1])
                           + self.model.num_frames(window_size))
        aggregated = aggregate_scores(
            scores, to_device(offsets, device), total_frames, hamming=True,
            # Specifications.warm_up is in seconds, the weights want ratios
            warm_up=(self.warm_up[0] / self.duration,
                     self.warm_up[1] / self.duration),
            missing=0.0)
        return SlidingWindowFeature(
            aggregated[:num_output_frames].cpu().numpy(), frames)

    def preload(self, file) -> None:
        """Start the upload of a file's waveform early (into the file
        dict's cache, where ``slide`` finds it). A file past the memory
        budget warms only its first slice: a whole-file buffer is what its
        slice plan avoids. Does nothing for whole-window inference or an
        immutable mapping."""
        if self.window != "sliding" or not isinstance(file, MutableMapping):
            return
        waveform, sample_rate = self.audio(file)
        window_size = round(self.duration * sample_rate)
        step_size = round(self.step * sample_rate)
        starts, _ = _chunk_grid(waveform.shape[-1], window_size, step_size)
        plan = plan_slices(waveform.shape[-1], window_size, step_size,
                           sample_rate, starts)
        if plan is not None and len(plan) > 1:
            get_upload, _ = slice_uploads(file, waveform, plan, sample_rate,
                                          starts, window_size, self.device)
            get_upload(0)
            return
        _upload_waveform_cached(waveform, file, self.device)

    def __call__(self, file: AudioFile, hook: Optional[Callable] = None):
        """``slide`` over a whole file (a path or a mapping), uploads
        cached in the file dict; with ``window="whole"`` one forward of
        the whole file, on the host."""
        waveform, sample_rate = self.audio(file)
        if self.window == "sliding":
            cache = file if isinstance(file, MutableMapping) else None
            return self.slide(waveform, sample_rate, hook=hook, cache=cache)
        return self.infer(waveform[None])[0]

    def crop(self, file: AudioFile, chunk: Union[Segment, List[Segment]],
             duration: Optional[float] = None,
             hook: Optional[Callable] = None):
        """Inference on an excerpt of the file, zero-padded where it lies
        outside. Sliding: over the hull of ``chunk`` (a Segment or a list
        of them), the output's window shifted to its start. Whole: one
        forward per segment; a list gives the padded crops stacked."""
        if self.window == "sliding":
            if not isinstance(chunk, Segment):
                chunk = Segment(min(c.start for c in chunk),
                                max(c.end for c in chunk))
            waveform, sample_rate = self.audio.crop(
                file, chunk, duration=duration, mode="pad")
            output = self.slide(waveform, sample_rate, hook=hook)
            window = output.sliding_window
            return SlidingWindowFeature(
                output.data, SlidingWindow(start=window.start + chunk.start,
                                           duration=window.duration,
                                           step=window.step))
        if isinstance(chunk, Segment):
            waveform, _ = self.audio.crop(file, chunk, duration=duration,
                                          mode="pad")
            return self.infer(waveform[None])[0]
        return self.infer(np.stack([
            self.audio.crop(file, c, duration=duration, mode="pad")[0]
            for c in chunk]))

    @staticmethod
    def aggregate(scores: SlidingWindowFeature, frames: SlidingWindow,
                  warm_up: Tuple[float, float] = (0.0, 0.0),
                  epsilon: float = 1e-12, hamming: bool = False,
                  missing: float = np.nan, skip_average: bool = False
                  ) -> SlidingWindowFeature:
        """Chunk-level (chunks, frames, classes) scores -> frame-level
        scores on ``frames``' grid, rebased to the chunks' start;
        ``warm_up`` in seconds. Runs where the data is: a tensor stays on
        its device, a numpy array gives a numpy array."""
        data = scores.data
        as_numpy = not isinstance(data, torch.Tensor)
        if as_numpy:
            data = torch.from_numpy(np.asarray(data, dtype=np.float32))
        num_chunks = data.shape[0]
        chunk_window = scores.sliding_window
        window = SlidingWindow(start=chunk_window.start,
                               duration=frames.duration, step=frames.step)
        offsets = np.array([window.closest_frame(
            chunk_window[i].start + 0.5 * frames.duration)
            for i in range(num_chunks)], dtype=np.int64)
        num_output_frames = window.closest_frame(
            chunk_window.start + chunk_window.duration
            + (num_chunks - 1) * chunk_window.step
            + 0.5 * frames.duration) + 1
        out = aggregate_scores(
            data.float(), to_device(offsets, data.device), num_output_frames,
            hamming=hamming,
            warm_up=(warm_up[0] / chunk_window.duration,
                     warm_up[1] / chunk_window.duration),
            missing=missing, skip_average=skip_average)
        return SlidingWindowFeature(out.cpu().numpy() if as_numpy else out,
                                    window)

    @staticmethod
    def trim(scores: SlidingWindowFeature,
             warm_up: Tuple[float, float] = (0.1, 0.1)
             ) -> SlidingWindowFeature:
        """Cut the warm-up frames (ratios of a chunk) off each end of
        chunk-level scores."""
        chunk_window = scores.sliding_window
        _, num_frames, _ = scores.data.shape
        left = int(round(warm_up[0] * num_frames))
        right = int(round(warm_up[1] * num_frames))
        frame_duration = chunk_window.duration / num_frames
        return SlidingWindowFeature(
            scores.data[:, left:num_frames - right],
            SlidingWindow(start=chunk_window.start + left * frame_duration,
                          duration=chunk_window.duration
                          - (left + right) * frame_duration,
                          step=chunk_window.step))
